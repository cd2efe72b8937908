"""The local launcher of ranks and the process-group set-up.

``tpugnn_torch.dist.multihost.launch`` must not hide a failure: a rank that
raises, a rank that dies, and ranks that outlast the time limit each raise
in the caller, with every rank ended.  The ranks are gloo processes on the
CPU meeting through a ``file://`` store.
"""

import os
import time

import pytest
import torch
import torch.distributed as dist

from tpugnn_torch.dist.multihost import initialize, is_multihost, launch, process_info


def _report(tag):
    print(f"rank {dist.get_rank()} says {tag}", flush=True)
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    return process_info(), is_multihost(), float(t), initialize(device="cpu").type


def _raise_on_rank_one():
    if dist.get_rank() == 1:
        raise ValueError("rank one gives up")
    dist.barrier()
    return "done"


def _exit_on_rank_zero():
    if dist.get_rank() == 0:
        os._exit(3)
    dist.barrier()


def _sleep():
    time.sleep(120)


def test_launch_returns_every_rank_in_order(capfd):
    results = launch(_report, 3, args=("hello",), device="cpu", timeout=120)
    for r, (info, multi, total, dev) in enumerate(results):
        assert info["process_index"] == r and info["process_count"] == 3
        assert info["backend"] == "gloo" and multi and total == 6.0 and dev == "cpu"
    out = capfd.readouterr().out
    assert [f"rank {r} says hello" in out for r in range(3)] == [True] * 3


def test_a_rank_that_raises_fails_the_launch():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 1") as e:
        launch(_raise_on_rank_one, 2, device="cpu", timeout=120, echo=False)
    assert "rank one gives up" in str(e.value)
    assert time.monotonic() - t0 < 60


def test_a_rank_that_dies_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 0 of 2 exited with code 3"):
        launch(_exit_on_rank_zero, 2, device="cpu", timeout=120, echo=False)


def test_a_timeout_fails_the_launch():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="outlasted 8"):
        launch(_sleep, 2, device="cpu", timeout=8, echo=False)
    assert time.monotonic() - t0 < 30


def test_launch_needs_a_rank():
    with pytest.raises(ValueError, match="n >= 1"):
        launch(_report, 0, args=("x",), device="cpu")


def test_a_failed_init_fails_the_launch():
    with pytest.raises(RuntimeError, match="exited with code"):
        launch(_report, 2, args=("x",), device="cpu", backend="no-such-backend", timeout=120,
               echo=False)
