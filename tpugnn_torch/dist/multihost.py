"""Process-group set-up and a local launcher of ranks.

The port of ``tpugnn.dist.multihost`` onto ``torch.distributed``, one
process per rank:

* :func:`initialize` joins the process group: from the arguments, or from
  torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``).  ``nccl`` for a CUDA device and ``gloo``
  for ``device='cpu'`` unless ``backend`` says otherwise; a rank on a card
  takes ``cuda:LOCAL_RANK mod device_count``.  Idempotent; any failure
  raises.
* :func:`launch` starts N ranks on this host as child processes, each one
  running ``fn(*args)`` after :func:`initialize`, and returns
  their results in rank order.  The ranks meet through a ``file://`` store
  in a directory of their own (no port to race for).  It raises if any rank
  exits with another code than 0 or if the run outlasts ``timeout``, and
  then ends every rank it started.

On several cards of one host, or several hosts::

    torchrun --nproc-per-node 4 my_script.py      # calls initialize()
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_multihost", "process_info", "launch"]

_GRACE_S = 10.0     # after one rank fails, the others' time to end on their own


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, *, device="cuda", backend: str | None = None,
               local_rank: int | None = None) -> torch.device:
    """Join the process group (a no-op if this process has joined one) and
    return this rank's device.

    With no arguments, torchrun's environment names everything
    (``init_method='env://'``).  ``backend`` defaults to ``nccl`` on a CUDA
    device and ``gloo`` on the CPU; ``gloo`` with a CUDA device is the
    several-ranks-on-one-card set-up, whose exchanges are staged through
    the host (:mod:`tpugnn_torch.dist.exchange`)."""
    from tpugnn_torch.utils.device import resolve_device

    dev = resolve_device(device)
    env = os.environ
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None:
        init_method = "env://"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev      # binds the communicator to this rank's card
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    return dev


def is_multihost() -> bool:
    """More than one process in the group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    joined = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "backend": dist.get_backend() if joined else None,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 0,
    }


def _tail(path: str, limit: int = 4000) -> str:
    with open(path, "rb") as f:
        data = f.read()
    return data[-limit:].decode(errors="replace")


def launch(fn, n: int, args: tuple = (), *, device="cuda", backend: str | None = None,
           timeout: float = 300.0, echo: bool = True) -> list:
    """Run ``fn(*args)`` on ``n`` ranks of this host; returns their results,
    rank 0 first.

    ``fn`` is a module-level function of an importable module (or of the
    file that defines it).  Each rank is a fresh Python process that joins
    the group with :func:`initialize` (``device`` and ``backend`` as there:
    the card unless ``device='cpu'``, and on a card every rank takes
    ``cuda:rank mod device_count``), runs ``fn`` and leaves the group.
    ``echo`` writes each rank's standard output to this one's after the
    run.  Raises ``RuntimeError`` naming the rank if a rank exits with
    another code than 0, ``TimeoutError`` if the ranks outlast ``timeout``
    seconds; either way every rank is ended first."""
    from tpugnn_torch.utils.device import resolve_device

    if n < 1:
        raise ValueError(f"launch needs n >= 1 ranks, got {n}")
    dev = resolve_device(device)
    module = sys.modules[fn.__module__]
    spec = {"module": fn.__module__, "file": getattr(module, "__file__", None),
            "name": fn.__qualname__, "args": args,
            "device": str(dev), "backend": backend, "world": n}
    root = tempfile.mkdtemp(prefix="tpugnn_ranks_")
    procs, logs = [], []
    try:
        spec["init_method"] = "file://" + os.path.join(root, "store")
        spec_path = os.path.join(root, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(spec, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p and os.path.isdir(p))
        env["WORLD_SIZE"], env["LOCAL_WORLD_SIZE"] = str(n), str(n)
        for r in range(n):
            env.update(RANK=str(r), LOCAL_RANK=str(r))
            out = open(os.path.join(root, f"out{r}.txt"), "wb")
            err = open(os.path.join(root, f"err{r}.txt"), "wb")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "from tpugnn_torch.dist.multihost import _rank_main; _rank_main()",
                 spec_path], env=env, stdout=out, stderr=err, stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout
        failed_at, timed_out, order = None, False, []
        while True:
            codes = [p.poll() for p in procs]
            order += [r for r, c in enumerate(codes) if c not in (None, 0) and r not in order]
            if all(c is not None for c in codes):
                break
            now = time.monotonic()
            if failed_at is None and order:
                failed_at = now
            if failed_at is not None and now > failed_at + _GRACE_S:
                break
            if now > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for out, err in logs:
            out.close()
            err.close()
        codes = [p.returncode for p in procs]
        if echo:
            for r in range(n):
                text = _tail(os.path.join(root, f"out{r}.txt"), 1 << 20)
                if text:
                    sys.stdout.write(text if text.endswith("\n") else text + "\n")
            sys.stdout.flush()
        bad = [r for r, c in enumerate(codes) if c != 0]
        if bad:
            first = order[0] if order else bad[0]     # the rank that failed first
            msg = (f"rank {first} of {n} exited with code {codes[first]} (codes {codes}); "
                   f"its stderr ends:\n{_tail(os.path.join(root, f'err{first}.txt'))}")
            if timed_out:
                raise TimeoutError(f"{n} ranks outlasted {timeout} s; " + msg)
            raise RuntimeError(msg)
        results = []
        for r in range(n):
            with open(os.path.join(root, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)


def _resolve(spec: dict):
    if spec["module"] != "__main__":
        module = importlib.import_module(spec["module"])
    else:       # a script's function: load the script under another name
        mod_spec = importlib.util.spec_from_file_location("_tpugnn_rank_module", spec["file"])
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
    fn = module
    for part in spec["name"].split("."):
        fn = getattr(fn, part)
    return fn


def _rank_main() -> None:
    """A rank's process: join, run, write the result, leave."""
    with open(sys.argv[1], "rb") as f:
        spec = pickle.load(f)
    rank = int(os.environ["RANK"])
    # ranks on the CPU share its cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec["world"]))
    initialize(spec["init_method"], spec["world"], rank, device=spec["device"],
               backend=spec["backend"], local_rank=rank)
    result = _resolve(spec)(*spec["args"])
    path = os.path.join(os.path.dirname(sys.argv[1]), f"result{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    sys.stdout.flush()
    dist.destroy_process_group()
