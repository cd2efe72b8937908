"""The port's utils (tpugnn_torch/utils/{metrics,timing,hostidle}.py):
twins of tests/test_utils.py's logger and timer tests and of
tests/test_hostidle.py, on the CPU."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from tpugnn.utils.metrics import MetricLogger as JaxMetricLogger
from tpugnn_torch.utils.hostidle import PIDFILE, _queue_pids, paused_queue_jobs
from tpugnn_torch.utils.metrics import MetricLogger, Timer, profile
from tpugnn_torch.utils.timing import hard_sync


def test_metric_logger_jsonl(tmp_path):
    path = os.path.join(str(tmp_path), "x.jsonl")
    ml = MetricLogger(path, stdout=False)
    ml.log({"step": 1, "loss": 0.5})
    ml("legacy string call")
    ml.close()
    rec = json.loads(open(path).read().splitlines()[0])
    assert rec["loss"] == 0.5 and "time" in rec


def test_metric_logger_records_equal_jax(tmp_path, capsys):
    """The same record, tensors as floats, in the JAX logger's JSONL and
    stdout format."""
    ours, theirs = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    rec = {"step": 3, "loss": torch.tensor(0.25), "ler": 0.125, "time": 1.0, "tag": "x"}
    for cls, path in ((MetricLogger, ours), (JaxMetricLogger, theirs)):
        ml = cls(path, prefix="run ")
        ml.log(dict(rec, loss=0.25) if cls is JaxMetricLogger else rec)
        ml.close()
    assert open(ours).read() == open(theirs).read()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "run step 3: loss=0.25 ler=0.125 tag=x"


def test_timer():
    t = Timer.time_fn(lambda x: x + 1, torch.ones(4), iters=2, warmup=1)
    assert t >= 0.0
    with Timer("cpu") as tm:
        time.sleep(0.01)
    assert tm.elapsed >= 0.009


def test_hard_sync_fetches_one_element():
    out = (torch.arange(6.0).reshape(2, 3), {"b": torch.ones(2)})
    got = hard_sync(out)
    assert got.device.type == "cpu" and got.tolist() == [0.0]
    assert hard_sync({"a": [torch.full((3,), 7.0)]}).tolist() == [7.0]
    assert hard_sync(()) is None and hard_sync(5) == 5


def test_profile_writes_a_chrome_trace(tmp_path):
    with profile(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with profile(None):
        pass


# --- hostidle (tests/test_hostidle.py) ---------------------------------------

def _state(pid: int) -> str:
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split()[2]


def _spawn_fake_queue_job(marker="train_quality_v3.py"):
    # argv carries an allowlisted marker (unused by -c) so that the cmdline
    # check recognizes it as one of the repo's queue entry points
    return subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)", marker])


def _wait_resumed(pid):
    deadline = time.time() + 5
    while _state(pid) == "T" and time.time() < deadline:
        time.sleep(0.05)
    assert _state(pid) != "T"


@pytest.mark.parametrize("marker", ["train_quality_v3.py", "tpugnn_torch.cli"])
def test_pause_and_resume(tmp_path, marker):
    proc = _spawn_fake_queue_job(marker)
    pidfile = tmp_path / "tpu_active.pid"
    pidfile.write_text(f"{proc.pid}\n")
    try:
        time.sleep(0.3)
        with paused_queue_jobs(str(pidfile), settle_s=0.1) as paused:
            assert paused == [proc.pid]
            assert _state(proc.pid) == "T"
        _wait_resumed(proc.pid)
    finally:
        proc.kill()
        proc.wait()


def test_resume_on_exception(tmp_path):
    proc = _spawn_fake_queue_job()
    pidfile = tmp_path / "tpu_active.pid"
    pidfile.write_text(f"{proc.pid}\n")
    try:
        time.sleep(0.3)
        with pytest.raises(RuntimeError, match="crashed"):
            with paused_queue_jobs(str(pidfile), settle_s=0.1):
                assert _state(proc.pid) == "T"
                raise RuntimeError("bench crashed")
        _wait_resumed(proc.pid)
    finally:
        proc.kill()
        proc.wait()


def test_non_allowlisted_pid_ignored(tmp_path):
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    pidfile = tmp_path / "tpu_active.pid"
    pidfile.write_text(f"{proc.pid}\n# comment\nnot-a-pid\n999999999\n")
    try:
        assert _queue_pids(str(pidfile)) == []
        with paused_queue_jobs(str(pidfile), settle_s=0.0) as paused:
            assert paused == []
            assert _state(proc.pid) != "T"
    finally:
        proc.kill()
        proc.wait()


def test_missing_pidfile_is_noop(tmp_path):
    with paused_queue_jobs(str(tmp_path / "nope.pid"), settle_s=0.0) as paused:
        assert paused == []


def test_own_pid_skipped(tmp_path):
    pidfile = tmp_path / "tpu_active.pid"
    pidfile.write_text(f"{os.getpid()}\n")
    assert _queue_pids(str(pidfile)) == []


def test_pidfile_is_the_repos():
    from tpugnn.utils import hostidle

    assert PIDFILE == hostidle.PIDFILE
