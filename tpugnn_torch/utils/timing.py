"""Device synchronization for timings (the port of ``tpugnn/utils/timing.py``).

A CUDA call returns before the card has run it, so every timing or warm-up
path waits for the card before it reads a clock: :func:`hard_sync` waits for
all work queued on the device of its argument and fetches one element of it
to the host, as the JAX version fetches one element through its relay.
"""

from __future__ import annotations

import torch

__all__ = ["hard_sync"]


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def hard_sync(out):
    """Block until all work queued before ``out`` on its device is done.

    ``out`` is a tensor or a (nested) tuple, list, NamedTuple or dict of
    them; returns one fetched element of its first tensor (a 1-element CPU
    tensor), ``out`` itself when it holds no tensor, or None when it is an
    empty container."""
    leaf = _first_tensor(out)
    if leaf is None:
        return None if isinstance(out, (list, tuple, dict)) else out
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return leaf.detach().reshape(-1)[:1].cpu()
