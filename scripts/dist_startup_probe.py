#!/usr/bin/env python3
"""Where a launch of gloo ranks on one NVIDIA card spends its time.

    python3 scripts/dist_startup_probe.py [--ranks 4]

Prints, each as one JSON line:

  bare      the wall time of N fresh processes that only ``import torch``,
            and of N that also run one kernel on the card, all started at
            once (the floor of any launch of N ranks on this host);
  launch    two launches of N ranks through
            ``tpugnn_torch.dist.multihost.launch`` (gloo, on the card), each
            rank running :func:`dryrun`'s body twice and timing its steps
            (mesh, partition, ``init_state``, the sharded step's set-up,
            sampling, two steps), and the seconds from the launch call to
            the rank's function;
  dryrun    two calls of ``tpugnn_torch.dist.dryrun(N)`` on the card.

It needs one card; it imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ranks_body(t_launch: float, n: int) -> dict:
    """dryrun's rank body, timed step by step, twice (cold, then warm)."""
    import torch

    from tpugnn_torch.configs import CodeConfig, ExperimentConfig, ModelConfig, TrainConfig
    from tpugnn_torch.dist import build_partitioned_code, make_mesh, make_sharded_train_step
    from tpugnn_torch.dist.api import _pick_mesh_shape
    from tpugnn_torch.sampling import sample_batch
    from tpugnn_torch.train import init_state

    out = {"to_fn_s": time.time() - t_launch, "passes": []}
    dev = torch.device("cuda", torch.cuda.current_device())
    names = ["mesh", "partition", "init_state", "make_step", "sample", "step1", "step2"]
    for _ in range(2):
        t = [time.perf_counter()]

        def lap():
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        mcfg = _pick_mesh_shape(n)
        mesh = make_mesh(mcfg, n_devices=n)
        lap()
        graph, pgraph = build_partitioned_code("surface", 5, mcfg.graph)
        lap()
        cfg = ExperimentConfig(code=CodeConfig(family="surface", distance=5, p=0.05),
                               model=ModelConfig(hidden=16, msg_hidden=16, rounds=2),
                               train=TrainConfig(batch=max(8, 2 * mcfg.data), steps=1,
                                                 warmup_steps=1), mesh=mcfg)
        state = init_state(cfg, graph, dev)
        lap()
        step = make_sharded_train_step(cfg, state.model, mesh, graph, pgraph,
                                       state.optimizer, device=dev)
        lap()
        batch = sample_batch(state.generator, graph.to(dev), cfg.code.p, cfg.train.batch)
        lap()
        for _ in range(2):
            float(step(batch)["loss"])
            lap()
        out["passes"].append({k: b - a for k, a, b in zip(names, t, t[1:])})
    return out


def _processes(n: int, code: str) -> float:
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code]) for _ in range(n)]
    codes = [p.wait() for p in procs]
    if any(codes):
        raise RuntimeError(f"a bare process failed: {codes}")
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    n = ap.parse_args().ranks

    import torch

    from tpugnn_torch.dist import dryrun
    from tpugnn_torch.dist.multihost import launch

    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs on an NVIDIA card", file=sys.stderr)
        return 2
    print(json.dumps({"bare": {
        "ranks": n,
        "import_torch_s": _processes(n, "import torch"),
        "import_torch_and_a_kernel_s": _processes(
            n, "import torch; torch.ones(1, device='cuda'); torch.cuda.synchronize()")}}),
        flush=True)
    for i in range(2):
        t0 = time.perf_counter()
        res = launch(_ranks_body, n, args=(time.time(), n), device="cuda", backend="gloo",
                     timeout=300, echo=False)
        print(json.dumps({"launch": {"call": i, "ranks": n,
                                     "wall_s": time.perf_counter() - t0, "rank0": res[0]}}),
              flush=True)
    for i in range(2):
        t0 = time.perf_counter()
        dryrun(n, device="cuda", backend="gloo", timeout=300)
        print(json.dumps({"dryrun": {"call": i, "ranks": n,
                                     "wall_s": time.perf_counter() - t0}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
