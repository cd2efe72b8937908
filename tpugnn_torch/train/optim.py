"""The JAX package's optimizer, written out: optax's formulas in PyTorch.

``tpugnn/train/loop.py:83-94`` trains with::

    optax.chain(optax.clip_by_global_norm(1.0),
                optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup,
                                                         max(steps, warmup + 1),
                                                         0.1 lr),
                            weight_decay=wd))

``torch.optim.AdamW`` and ``clip_grad_norm_`` differ from it: the clip
divides by norm + 1e-6 and clips at the boundary too, the decay is applied
as ``p * (1 - lr wd)`` before the Adam step, and the schedule is not
optax's.  So :class:`OptaxAdamW` computes optax's update itself.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["OptaxAdamW", "warmup_cosine_decay", "make_optimizer"]


def warmup_cosine_decay(count: int, *, peak: float, warmup_steps: int,
                        decay_steps: int, end: float, init: float = 0.0) -> float:
    """``optax.warmup_cosine_decay_schedule(init, peak, warmup_steps,
    decay_steps, end)`` at step ``count``: linear from init to peak over the
    warmup, then a cosine from peak to end over the remaining steps.  In f32
    and in optax's order of operations, as the JAX package's runs see it."""
    f = np.float32
    if count < warmup_steps:
        frac = f(1.0) - f(min(max(count, 0), warmup_steps)) / f(warmup_steps)
        return float((f(init) - f(peak)) * frac + f(peak))
    alpha = 0.0 if peak == 0.0 else end / peak
    span = f(decay_steps - warmup_steps)
    t = min(f(count - warmup_steps), span)
    cosine = f(0.5) * (f(1.0) + np.cos(f(np.pi) * t / span, dtype=np.float32))
    return float(f(peak) * ((f(1.0) - f(alpha)) * cosine + f(alpha)))


class OptaxAdamW:
    """Global-norm clip, then AdamW with a learning-rate schedule, as optax
    chains them.  Per step, over all parameters with a gradient:

    * g <- g / ||g|| * max_norm unless ||g|| < max_norm (global L2 norm);
    * mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, count += 1;
    * u <- mu / (1 - b1^count) / (sqrt(nu / (1 - b2^count)) + eps) + wd p;
    * p <- p - lr(count - 1) u.

    One parameter group; ``zero_grad``, ``state_dict`` and
    ``load_state_dict`` keep ``torch.optim.Optimizer``'s interface and
    checkpoint format.  It does not derive from that class: its first
    construction in a process imports ``torch._dynamo`` (about 2 s), which
    every training run and rank would pay.
    """

    def __init__(self, params, schedule, *, max_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4):
        self.param_groups = [dict(params=list(params), b1=b1, b2=b2, eps=eps,
                                  weight_decay=weight_decay, max_norm=max_norm, count=0)]
        self.state: dict = {}    # parameter -> {"mu", "nu"}
        self.schedule = schedule

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.param_groups[0]["params"]:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def state_dict(self) -> dict:
        """``{"state": {index: {"mu", "nu"}}, "param_groups": [hyperparameters
        and "params": indices]}``, as ``torch.optim.Optimizer`` writes it."""
        group = self.param_groups[0]
        index = {id(p): i for i, p in enumerate(group["params"])}
        return {"state": {index[id(p)]: dict(st) for p, st in self.state.items()},
                "param_groups": [{**{k: v for k, v in group.items() if k != "params"},
                                  "params": list(range(len(group["params"])))}]}

    def load_state_dict(self, state_dict: dict) -> None:
        """Restores :meth:`state_dict`'s output (moments onto each
        parameter's device and type, the hyperparameters and count)."""
        (saved,) = state_dict["param_groups"]
        params = self.param_groups[0]["params"]
        if len(saved["params"]) != len(params):
            raise ValueError(f"the state holds {len(saved['params'])} parameters, the "
                             f"optimizer {len(params)}")
        self.param_groups = [{**{k: v for k, v in saved.items() if k != "params"},
                              "params": params}]
        self.state = {params[i]: {k: v.to(device=params[i].device, dtype=params[i].dtype)
                                  for k, v in st.items()}
                      for i, st in state_dict["state"].items()}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdamW takes no closure")
        live = [(g, p) for g in self.param_groups for p in g["params"]
                if p.grad is not None]
        if not live:
            return None
        grads = [p.grad for _, p in live]
        g_norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
        for group in self.param_groups:
            max_norm = group["max_norm"]
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            count = group["count"] + 1
            lr = self.schedule(group["count"])
            # optax takes the bias corrections in f32, where 0.999 is not
            # exact: 1 - 0.999^1 comes out 1.3e-5 below 1e-3
            c1, c2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(count))
                      for b in (b1, b2))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = torch.where(g_norm < max_norm, p.grad, p.grad / g_norm * max_norm)
                st = self.state.setdefault(p, {})
                if not st:
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                mu, nu = st["mu"], st["nu"]
                mu.mul_(b1).add_((1.0 - b1) * g)
                nu.mul_(b2).add_((1.0 - b2) * (g * g))
                u = (mu / c1) / (torch.sqrt(nu / c2) + eps) + wd * p
                p.sub_(lr * u)
            group["count"] = count
        return None


def make_optimizer(cfg, params) -> OptaxAdamW:
    """The training config's optimizer over ``params``
    (``tpugnn/train/loop.py::make_optimizer``)."""
    t = cfg.train
    decay_steps = max(t.steps, t.warmup_steps + 1)
    schedule = lambda count: warmup_cosine_decay(
        count, peak=t.lr, warmup_steps=t.warmup_steps, decay_steps=decay_steps,
        end=t.lr * 0.1)
    return OptaxAdamW(params, schedule, max_norm=1.0, weight_decay=t.weight_decay)
