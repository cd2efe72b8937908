"""Pause the repo's own background jobs while a measurement runs.

The port's copy of ``tpugnn/utils/hostidle.py``.  Device timings are
unreliable while the host CPU is busy: the host launches the work and runs
the decoders' host tails.  Long-running quality jobs (training runs, LER
tables) are queued by scripts/tpu_queue_*.sh; each queue job advertises its
PID in ``runs/tpu_active.pid``.  Benchmarks call :func:`paused_queue_jobs`
to SIGSTOP those jobs for the duration of the measurement and SIGCONT them
afterwards, so that a benchmark started at any time measures an idle
host.

Safety properties:

* PIDs come ONLY from the pidfile our own queue scripts write — never from
  scanning process tables by name/pattern.
* Each PID is verified against an allowlist of our queue entrypoints via
  ``/proc/<pid>/cmdline`` before any signal is sent.
* SIGCONT is guaranteed via ``finally`` + ``atexit`` + SIGTERM/SIGINT
  handlers, and the queue scripts run an independent watchdog that resumes
  any job left stopped for too long (scripts/tpu_queue_r1d.sh).
"""

from __future__ import annotations

import atexit
import contextlib
import os
import signal
import time

__all__ = ["paused_queue_jobs", "PIDFILE"]

PIDFILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "runs",
    "tpu_active.pid",
)

# Only processes whose cmdline mentions one of OUR queue entrypoints are
# ever signalled; anything else in the pidfile is ignored.
_ALLOWED = (
    "train_quality_v3.py",
    "train_quality_circuit.py",
    "ler_table.py",
    "baseline_table.py",
    "probe_kernel_attrib.py",
    "probe_train_step.py",
    "probe_tb.py",
    "serve_latency.py",
    "stream_quality.py",
    "tau_sweep.py",
    "decoder_throughput.py",
    "tpugnn_torch.cli",
    "tpugnn_torch/cli.py",
)


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def _queue_pids(pidfile: str) -> list[int]:
    pids = []
    try:
        with open(pidfile) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                try:
                    pid = int(line)
                except ValueError:
                    continue
                if pid == os.getpid():
                    continue
                cmd = _cmdline(pid)
                if any(a in cmd for a in _ALLOWED):
                    pids.append(pid)
    except OSError:
        pass
    return pids


@contextlib.contextmanager
def paused_queue_jobs(pidfile: str = PIDFILE, settle_s: float = 5.0):
    """SIGSTOP queue-advertised jobs for the body; SIGCONT on ANY exit.

    Yields the list of paused PIDs (empty when nothing was running, e.g. on
    CPU or an idle host).  ``settle_s`` lets the paused job's in-flight
    device work drain before the caller starts timing.
    """
    pids = _queue_pids(pidfile)
    paused: list[int] = []
    resumed = False

    def _resume(*_args):
        nonlocal resumed
        if resumed:
            return
        resumed = True
        for pid in paused:
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGCONT)

    prev_handlers = {}
    try:
        for pid in pids:
            try:
                os.kill(pid, signal.SIGSTOP)
                paused.append(pid)
            except OSError:
                pass
        if paused:
            atexit.register(_resume)
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev = signal.getsignal(sig)
                    prev_handlers[sig] = prev

                    def _handler(signum, frame, _prev=prev):
                        _resume()
                        if callable(_prev):
                            _prev(signum, frame)
                        else:
                            signal.signal(signum, signal.SIG_DFL)
                            os.kill(os.getpid(), signum)

                    signal.signal(sig, _handler)
                except (ValueError, OSError):
                    pass  # not the main thread / unsupported
            time.sleep(settle_s)
        yield paused
    finally:
        _resume()
        for sig, prev in prev_handlers.items():
            with contextlib.suppress(ValueError, OSError):
                signal.signal(sig, prev)
        with contextlib.suppress(ValueError):
            atexit.unregister(_resume)
