"""What the 3xTF32 tests share (``test_torch_tf32x3*.py``): a
``TorchFunctionMode`` that computes every f32 matrix product as the f32
rounds kernels do, the split pack read back out of its fragment order, and
seeded round weights.

The f32 rounds kernels (K1, K2a and K5) form every product ``a @ w`` as
three TF32 products: each operand split into ``hi = tf32(x)`` and ``lo =
tf32(x - hi)`` (``cvt.rna``), ``a_lo w_hi + a_hi w_lo + a_hi w_hi`` summed
in f32.  Not a test module: pytest collects nothing here.
"""

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from tpugnn_torch.kernels import fused_decoder as fd

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}
_VECTORS = ("b0_c", "bo_c", "b0_q", "bo_q", "uc_s", "uc_b0", "uc_b1", "uq_b0", "uq_b1",
            "lnc_scale", "lnc_bias", "lnq_scale", "lnq_bias")


class Tf32x3Products(TorchFunctionMode):
    """Computes every f32 matrix product as the kernels do: both operands
    split into TF32 halves, a_lo w_hi + a_hi w_lo + a_hi w_hi in f32; with
    ``passes=1`` as one TF32 product, a_hi w_hi.  ``count`` is the number
    of products it formed."""

    def __init__(self, passes: int = 3):
        super().__init__()
        self.passes = passes
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS and all(isinstance(a, torch.Tensor) and a.dtype == torch.float32
                                     for a in args[:2]):
            self.count += 1
            a, w = args[:2]
            ah, wh = fd.tf32_round(a), fd.tf32_round(w)
            if self.passes == 1:
                return torch.matmul(ah, wh)
            al, wl = fd.tf32_round(a - ah), fd.tf32_round(w - wh)
            return torch.matmul(al, wh) + torch.matmul(ah, wl) + torch.matmul(ah, wh)
        return func(*args, **kwargs)


def split_matrices(pack: torch.Tensor) -> torch.Tensor:
    """hi and lo [2, 10, 128 (k), 128 (n)] back out of the fragment-ordered
    pack of ``fd.tf32_split_pack``: [10, k-step s, n-tile j, g, t, (hi, lo),
    (row 8s + t, row 8s + t + 4)] for column 8j + g."""
    p = pack.reshape(10, 16, 16, 8, 4, 2, 2)            # s, j, g, t, (hi, lo), (k, k + 4)
    return p.permute(5, 0, 1, 6, 4, 2, 3).reshape(2, 10, 128, 128)


def wgmma_matrices(pack: torch.Tensor, wid: int, dt: torch.dtype) -> list:
    """The matrices [10, W (k), W (n)] back out of ``fd.wgmma_pack``'s
    layout [10, slab, (half,) n // 8, k % KS // T, n % 8, k % T]: one in
    bf16, (hi, lo) in f32."""
    from tpugnn_torch.kernels import fused_decoder as fd

    ks, te = fd.wide_slab_rows(wid, dt), 4 if dt == torch.float32 else 8
    halves = [pack] if dt != torch.float32 else [pack[:, :, 0], pack[:, :, 1]]
    return [h.reshape(10, wid // ks, wid // 8, ks // te, 8, te).permute(0, 1, 3, 5, 2, 4)
            .reshape(10, wid, wid) for h in halves]


def round_weights(h: int, seed: int) -> dict:
    """Seeded f32 round weights of width h as numpy arrays: matrices of
    scale 1/sqrt(h), vectors of scale 0.2 (LayerNorm scales about 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for f in fd.RoundWeights._fields:
        if f in _VECTORS:
            w = rng.standard_normal((1, h)) * 0.2 + (1.0 if f.endswith("scale") else 0.0)
        else:
            w = rng.standard_normal((h, h)) / np.sqrt(h)
        out[f] = w.astype(np.float32)
    return out
