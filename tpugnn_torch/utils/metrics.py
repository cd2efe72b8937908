"""Structured metrics and profiling hooks (the port of
``tpugnn/utils/metrics.py``).

Metrics are records written to stdout and/or a JSONL file, one JSON object a
line, in the JAX package's format; ``profile`` wraps a region in a
``torch.profiler`` capture and writes a Chrome trace; ``Timer`` times on
CUDA events when the work runs on a card and on the host clock otherwise.

Canonical metric names (used by train/eval):
    loss, loss_qubit, loss_logical, acc_qubit, ler, ler_stderr,
    ler_logical, edges_per_s, step_time_ms
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from typing import IO, Iterator, Optional

import torch

from tpugnn_torch.utils.timing import hard_sync

__all__ = ["MetricLogger", "profile", "Timer"]


class MetricLogger:
    """Write metric records to stdout and/or a JSONL file."""

    def __init__(self, jsonl_path: Optional[str] = None, *, stdout: bool = True,
                 prefix: str = ""):
        self._stdout = stdout
        self._prefix = prefix
        self._fh: Optional[IO[str]] = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._fh = open(jsonl_path, "a", buffering=1)

    def log(self, record: dict) -> None:
        """One record: tensors and NumPy scalars become floats, ``time``
        is added when absent."""
        rec = {k: (float(v) if hasattr(v, "item") else v) for k, v in record.items()}
        rec.setdefault("time", time.time())
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        if self._stdout:
            step = rec.get("step")
            body = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("time", "step"))
            head = f"{self._prefix}step {step}: " if step is not None else self._prefix
            print(head + body)

    def __call__(self, *args) -> None:
        """Accept ``log(dict)`` or plain ``log(str)`` calls."""
        if len(args) == 1 and isinstance(args[0], dict):
            self.log(args[0])
        else:
            print(self._prefix + " ".join(str(a) for a in args))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def profile(trace_dir: Optional[str]) -> Iterator[None]:
    """Wrap a region in a ``torch.profiler`` capture when ``trace_dir`` is
    set (CPU activity, and the card's where one is present), written as a
    Chrome trace to ``<trace_dir>/trace.json``."""
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class Timer:
    """Times a region: with ``device`` a card, between two CUDA events on
    its current stream; otherwise on the host clock.  ``elapsed`` is in
    seconds after the ``with`` block."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else None
        self._cuda = dev is not None and dev.type == "cuda"
        self._t0 = None
        self.elapsed: Optional[float] = None

    def __enter__(self):
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t1 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            self._t1.record()
            self._t1.synchronize()
            self.elapsed = self._t0.elapsed_time(self._t1) / 1e3
        else:
            self.elapsed = time.perf_counter() - self._t0
        return False

    @staticmethod
    def time_fn(fn, *args, iters: int = 10, warmup: int = 2, device=None) -> float:
        """Median seconds of ``iters`` calls of ``fn(*args)`` after ``warmup``
        calls; each call waits for its output (:func:`hard_sync`), and on a
        card (``device``) is timed between CUDA events."""
        out = None
        for _ in range(warmup):
            out = fn(*args)
        hard_sync(out)
        times = []
        for _ in range(iters):
            with Timer(device) as t:
                out = fn(*args)
                hard_sync(out)
            times.append(t.elapsed)
        return statistics.median(times)
