"""The precision scheme of the f32 rounds kernel on tensor cores (3xTF32).

K1 (``csrc/wide_rounds.cuh``, on ``wgmma``) and K5
(``csrc/roll_gather_tf32.cu``, on ``mma.sync``) form every f32 product of
the rounds as three TF32 products: each operand ``x`` is split into
``hi = tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna``: 10 mantissa bits,
ties away from zero) and ``a @ w`` accumulates ``a_lo w_hi + a_hi w_lo +
a_hi w_hi`` in f32.  The wrappers split the weights once a call (K5 in its
fragment order, ``fused_decoder.tf32_split_pack``; K1 in its slab order,
``fused_decoder.wgmma_pack``); the kernels split the states as they load
them.  These tests hold (a) the rounding, bit
for bit, and the wrapper's split pack, exactly and in its fragment layout,
and (b) the rounds of ``rounds_plain`` with every f32 product computed as
that three-term split product (a ``TorchFunctionMode``) against the JAX
package's ``rounds_xla`` in f32 on the same numpy-seeded inputs, within
1e-3 (the f32 kernel's tolerance against the plain version on the card)
and with >= 99.9% of the real qubits' argmax decisions equal.  The same
rounds with one TF32 product (``a_hi w_hi``) are the negative control: they
must land past 1e-3, so the tolerance tells the split from plain TF32
(``pytest -s -k split_products`` prints both distances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tf32x3_emulation import Tf32x3Products, round_weights, split_matrices
from tpugnn.kernels import fused_decoder as jfd
from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.tanner import build_code

TOL_F32 = 1e-3          # the f32 kernel's max abs error against the plain version
MIN_AGREE = 0.999       # argmax decisions of the real qubits
SPLIT_REL = 2.0 ** -21  # |x - (hi + lo)| <= SPLIT_REL |x|


def _values(n, seed):
    """Seeded f32 values over many magnitudes and both signs, with zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)
    x[::97] = 0.0
    return torch.from_numpy(x.astype(np.float32))


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round to nearest with 11 significant bits, ties away from zero, in
    f64 through frexp (independent of the bit trick under test)."""
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def test_tf32_round_is_cvt_rna():
    """tf32_round clears the 13 low mantissa bits, rounds to nearest with
    ties away from zero, and the two-term split keeps x to 2^-21."""
    x = _values(20000, 0)
    hi = fd.tf32_round(x)
    lo = fd.tf32_round(x - hi)
    assert hi.dtype == torch.float32 and hi.shape == x.shape
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    np.testing.assert_array_equal(hi.numpy(), _tf32_reference(x.numpy()))
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= SPLIT_REL * x.double().abs()).all()), float(err.max())
    # ties: half an ulp of the 10-bit mantissa goes away from zero
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 * 2 ** -10])
    assert torch.equal(fd.tf32_round(tie), want)


def test_split_pack_as_the_wrapper_makes_it():
    """The pack f32 K5 reads holds hi = tf32(w) and lo = tf32(w - hi) of
    every entry of every matrix, and read in the
    kernel's fragment order (lane 4g + t of n-tile j and k-step s: rows
    8s + t and 8s + t + 4 of column 8j + g), with the states split as the
    kernel splits them, it forms a @ w to f32 accuracy."""
    rng = np.random.default_rng(1)
    mats = torch.from_numpy((rng.standard_normal((10, 128, 128)) / 11.3).astype(np.float32))
    pack = fd.tf32_split_pack(mats)
    assert pack.dtype == torch.float32 and pack.is_contiguous()
    assert pack.numel() == 2 * mats.numel()
    hi, lo = split_matrices(pack)
    assert torch.equal(hi, fd.tf32_round(mats))
    assert torch.equal(lo, fd.tf32_round(mats - hi))
    err = (mats.double() - hi.double() - lo.double()).abs()
    assert bool((err <= SPLIT_REL * mats.double().abs()).all())

    # one warp's m16 x n128 product of matrix 3, from B fragments as lanes hold them
    a = torch.from_numpy(rng.standard_normal((16, 128)).astype(np.float32))
    ah = fd.tf32_round(a)
    al = fd.tf32_round(a - ah)
    blk = pack.reshape(10, 16, 16, 32, 4)[3].double()     # s, j, lane, (hi, hi, lo, lo)
    lanes = torch.arange(32)
    g, t = lanes // 4, lanes % 4
    out = torch.zeros(16, 128, dtype=torch.float64)
    for s in range(16):
        ks = slice(8 * s, 8 * s + 8)
        for j in range(16):
            bh = torch.zeros(8, 8, dtype=torch.float64)
            bl = torch.zeros(8, 8, dtype=torch.float64)
            bh[t, g], bh[t + 4, g] = blk[s, j, :, 0], blk[s, j, :, 1]
            bl[t, g], bl[t + 4, g] = blk[s, j, :, 2], blk[s, j, :, 3]
            out[:, 8 * j:8 * j + 8] += (al[:, ks].double() @ bh + ah[:, ks].double() @ bl
                                        + ah[:, ks].double() @ bh)
    ref = a.double() @ mats[3].double()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("d,h,rounds,batch", [(5, 128, 14, 32), (3, 64, 14, 64)])
def test_split_products_match_rounds_xla(d, h, rounds, batch):
    """The rounds with every f32 product split three ways (on states and
    packs padded to the kernels' 128 columns, the LayerNorm over the
    model's h) against JAX rounds_xla at width h: within TOL_F32, the padded
    columns exactly 0, and >= 99.9% of the real qubits decided alike by a
    seeded 4-way head.  One TF32 pass on the same inputs lands past
    TOL_F32."""
    jg = jax_build_code("surface", d)
    tg = build_code("surface", d).to("cpu")
    w = round_weights(h, seed=70 + d)
    rng = np.random.default_rng(80 + d)
    xc = rng.standard_normal((batch, jg.n_checks_pad, h)).astype(np.float32)
    xq = rng.standard_normal((batch, jg.n_qubits_pad, h)).astype(np.float32)
    syn = (np.sign(rng.standard_normal((batch, jg.n_checks_pad, 1)))
           * np.asarray(jg.check_mask)[None, :, None]).astype(np.float32)
    head = (rng.standard_normal((h, 4)) / np.sqrt(h)).astype(np.float32)

    ref = jfd.rounds_xla(jnp.asarray(xc), jnp.asarray(xq), jnp.asarray(syn),
                         jfd.make_operators(jg),
                         jfd.RoundWeights(**{k: jnp.asarray(v) for k, v in w.items()}),
                         rounds=rounds)
    tw = fd.RoundWeights(**{k: torch.from_numpy(v) for k, v in w.items()})
    mats, vecs = fd.pad_packs(*fd.pack_weights(tw, torch.float32))
    xc_p, xq_p = fd.pad_states(torch.from_numpy(xc), torch.from_numpy(xq))
    ops = fd.make_operators(tg)

    def rounds_as(passes):
        mode = Tf32x3Products(passes)
        with torch.no_grad(), mode:
            out = fd.rounds_packed(xc_p, xq_p, torch.from_numpy(syn), ops, mats, vecs,
                                   rounds=rounds, dtype=torch.float32,
                                   width=h if h < fd.WIDTH else None)
        assert mode.count == 10 * rounds      # five products a direction and round
        return out, max(float(np.abs(g_[..., :h].numpy() - np.asarray(r_)).max())
                        for g_, r_ in zip(out, ref))

    got, err = rounds_as(3)
    for g_ in got:
        assert g_.shape[-1] == fd.WIDTH and not g_[..., h:].any()
    assert err <= TOL_F32, err
    _, err_one = rounds_as(1)
    print(f"d={d} h={h}: max err from rounds_xla, 3xTF32 {err}, one TF32 pass {err_one}")
    assert err_one > TOL_F32, err_one
    n = tg.n_qubits
    decide = lambda x: np.argmax(np.asarray(x)[:, :n] @ head, -1)
    agree = (decide(got[1][..., :h].numpy()) == decide(ref[1])).mean()
    assert agree >= MIN_AGREE, agree
