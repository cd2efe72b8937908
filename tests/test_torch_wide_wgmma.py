"""The host side of the rounds kernels on wgmma (csrc/wide_mma.cuh,
csrc/wide_rounds.cuh; W = 128 to 512): the weight packs their ring and
wgmma read, the slab and chunk arithmetic, and the wrappers' calls with
stubbed libraries.

The packs must hold every weight exactly: bf16 packs the bf16 matrix, f32
packs its TF32 halves hi = tf32_round(w) and lo = tf32_round(w - hi), so
the checks here are equalities.  The kernels themselves run only on a card
(chip_smoke.py phase 6d).
"""

import contextlib
import types

import pytest
import torch

from tpugnn_torch.kernels import fused_backward as fb
from tpugnn_torch.kernels import fused_decoder as fd
from tpugnn_torch.kernels import roll_gather as rg
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)

WIDE = [256, 384, 512]
DTYPES = [torch.bfloat16, torch.float32]


def _unpack(pack: torch.Tensor, wid: int, dt: torch.dtype) -> list:
    """The matrices [n, W, W] of a wgmma pack: one in bf16, (hi, lo) in f32,
    read back by inverting the layout [n, slab, (half,) n // 8, k % KS // T,
    n % 8, k % T]."""
    ks, te = fd.wide_slab_rows(wid, dt), 4 if dt == torch.float32 else 8
    n = pack.shape[0]
    halves = [pack] if dt != torch.float32 else [pack[:, :, 0], pack[:, :, 1]]
    return [h.reshape(n, wid // ks, wid // 8, ks // te, 8, te).permute(0, 1, 3, 5, 2, 4)
            .reshape(n, wid, wid) for h in halves]


@pytest.mark.parametrize("dt", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("wid", [128, *WIDE])
def test_pack_unpacks_to_the_matrices(wid, dt):
    """Unpacking recovers every matrix exactly: bf16 the bf16 matrix, f32
    the TF32 halves hi and lo (and hi + lo is w to within 2^-21 |w|)."""
    mats = torch.randn((10, wid, wid), generator=torch.Generator().manual_seed(wid)) * 3
    pack = fd.wgmma_pack(mats, dt)
    assert pack.dtype == dt and pack.is_contiguous()
    got = _unpack(pack, wid, dt)
    if dt == torch.bfloat16:
        assert torch.equal(got[0], mats.to(torch.bfloat16))
    else:
        hi = fd.tf32_round(mats)
        lo = fd.tf32_round(mats - hi)
        assert torch.equal(got[0], hi) and torch.equal(got[1], lo)
        assert ((got[0] + got[1] - mats).abs() <= mats.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("dt", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("wid", [128, *WIDE])
def test_slab_is_one_contiguous_bulk_copy(wid, dt):
    """Each slab (KS k rows of one matrix, both halves in f32) is one
    contiguous run of the pack a bulk copy can take: at most 48 KB, a
    multiple of 16 bytes, KS a multiple of the wgmma k-step dividing W; and
    slab s holds exactly the rows [s KS, s KS + KS)."""
    ks = fd.wide_slab_rows(wid, dt)
    item = 8 if dt == torch.float32 else 2
    slab = ks * wid * item
    assert wid % ks == 0 and ks % (8 if dt == torch.float32 else 16) == 0
    assert slab <= 49152 and slab % 16 == 0
    mats = torch.zeros((1, wid, wid))
    s = wid // ks - 1
    mats[0, s * ks:(s + 1) * ks] = 1.0
    pack = fd.wgmma_pack(mats, dt).reshape(-1).view(torch.uint8)
    nz = torch.nonzero(pack).reshape(-1)
    assert pack.numel() == wid * wid * item
    assert int(nz.min()) >= s * slab and int(nz.max()) < (s + 1) * slab


@pytest.mark.parametrize("wid,want", [(128, 32), (256, 8), (384, 3), (512, 2)])
def test_wgrad_chunks(wid, want):
    """The weight-gradient launch's row chunks: 10 matrices x (W / 128)^2
    output tiles x chunks stays near _WGRAD_BLOCKS (320), at least one."""
    assert fb.wgrad_chunks(wid) == want
    assert 10 * (wid // 128) ** 2 * want <= fb._WGRAD_BLOCKS


@pytest.mark.parametrize("item", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("wid", [128, *WIDE])
def test_design_byte_model_tiles(wid, item):
    """chip_smoke.wide_design_bytes, the byte model phase 6d reports beside
    its times: every tile streams each of its products' packs once (bf16 2
    bytes an entry, f32 8: the TF32 halves); a tile is 128 rows only where
    one warpgroup holds a row's columns (bf16 up to W = 256, f32 at 128),
    and the backward's six replay products run 64-row tiles (its
    warpgroups split the columns) but f32 at W = 128, its projection and
    cotangent products the forward's."""
    import chip_smoke as cs

    g, b, r = build_code("surface", 3), 64, 2
    pack = wid * wid * (8 if item == 4 else 2)

    def tiles(rt):
        return -(-b * g.n_checks // rt) + -(-b * g.n_qubits // rt)

    rt = 128 if wid == 128 or (item == 2 and wid == 256) else 64
    rt_replay = 128 if item == 4 and wid == 128 else 64
    assert cs.wide_design_bytes(g, b, r, wid, item, False)[1] == r * tiles(rt) * 5 * pack
    assert cs.wide_design_bytes(g, b, r, wid, item, True)[1] == (
        r * (4 * tiles(rt) + 6 * tiles(rt_replay)) * pack)


@pytest.mark.parametrize("dt,lib,back", [
    (torch.float32, "wide_rounds_tf32", "wide_backward_tf32"),
    (torch.bfloat16, "wide_rounds", "wide_backward")])
def test_wide_library_by_state_type(dt, lib, back):
    """The forward (K1, K2a, K5) and the backward (K2b) build apart in each
    state type, each a library the build knows."""
    from tpugnn_torch.kernels import _build

    assert fd.wide_library(dt) == lib and fd.wide_library(dt, backward=True) == back
    assert {lib, back} <= set(_build.SOURCES)


# ---------------------------------------------------------------------------
# The wrappers with stubbed libraries (CPU tensors stand in for the card's).

class _Library:
    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, entry):
        if entry.endswith("_scratch_bytes"):
            return lambda *a: 0
        if entry == "wide_rounds_bwd_segments":
            return lambda: 8

        def launch(*args):
            self.calls.append((self.name, entry, args))
            return 0
        return launch


@pytest.fixture
def stubs(monkeypatch):
    """Stub libraries and a record of every pack the wrappers make:
    (calls, packs) with packs [(shape, dtype)]."""
    from tpugnn_torch.kernels import _build

    calls, packs = [], []
    real = fd.wgmma_pack

    def record(mats, dt):
        out = real(mats, dt)
        packs.append((tuple(mats.shape), dt))
        return out

    monkeypatch.setattr(_build, "load_library", lambda name: _Library(name, calls))
    monkeypatch.setattr(fd, "wgmma_pack", record)
    monkeypatch.setattr(rg, "wgmma_pack", record)
    monkeypatch.setattr(fd, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(rg, "_cuda_stream", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    fd.reset_launch_counts()
    rg.reset_launch_counts()
    return calls, packs


def _weights(h, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for f in fd.RoundWeights._fields:
        vec = f.startswith(("b", "ln")) or f in ("uc_s", "uc_b0", "uc_b1", "uq_b0", "uq_b1")
        out[f] = torch.randn((1, h) if vec else (h, h), generator=g) * 0.1
    return fd.RoundWeights(**out)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry,wid", [(e, w) for e in ("k1", "k5", "k2") for w in WIDE] +
                         [("k1", 128), ("k2", 128)])
def test_each_call_packs_once_and_launches_once(entry, wid, dt, stubs):
    """Each wrapper call at width W packs its matrices for wgmma in its state
    type (K2b also their transposes), reaches its library's entry point with
    W once, and counts one launch (K2a and K2b one each), under the wide
    names above 128 columns; f32 K2b at a width it refuses raises before its
    pack and launch.  (K5 at 128 columns keeps csrc/roll_gather.cu.)"""
    calls, packs = stubs
    tdt = fd.STATE_DTYPES[dt]
    g = build_code("surface", 3).to("cpu")
    w = _weights(wid)
    xc = torch.zeros((2, g.n_checks_pad, wid))
    xq = torch.zeros((2, g.n_qubits_pad, wid))
    syn = xc[..., :1]
    ops = fd.make_operators(g)
    wide = "_wide" if wid > fd.WIDTH else ""
    if entry == "k1":
        fd._rounds_cuda(xc, xq, syn, ops, w, 2, dt)
        want = {"fused_rounds" + wide: 1}
    elif entry == "k5":
        r_ops = rg.to_raster(xc, xq, syn, rg.plan_for_graph(g), w, dt)
        rg._roll_rounds_cuda(r_ops, rounds=2)
        want = {"roll_rounds_wide": 1}
    elif tdt == torch.float32 and wid in fb.F32_BWD_REFUSED:
        # f32 K2b refuses this width: K2a packs and launches, K2b raises first
        w = fd.RoundWeights(*[t.clone().requires_grad_(True) for t in w])
        out = fb.trained_rounds(xc, xq, syn, ops, w, 2, dt, kernels=True)
        with pytest.raises(ValueError, match=f"refuses f32 states at {wid} columns"):
            (out[0].sum() + out[1].sum()).backward()
        assert [name for _, name, _ in calls] == ["wide_rounds_launch"]
        assert packs == [((10, wid, wid), tdt)]
        assert fd.launch_counts()["fused_rounds_fwd_stash_wide"] == 1
        assert not fd.launch_counts()["fused_rounds_bwd_wide"]
        return
    else:
        w = fd.RoundWeights(*[t.clone().requires_grad_(True) for t in w])
        out = fb.trained_rounds(xc, xq, syn, ops, w, 2, dt, kernels=True)
        (out[0].sum() + out[1].sum()).backward()
        want = {"fused_rounds_fwd_stash" + wide: 1, "fused_rounds_bwd" + wide: 1}
    assert {lib for lib, _, _ in calls} == {fd.wide_library(tdt)} | (
        {fd.wide_library(tdt, backward=True)} if entry == "k2" else set())
    assert len(calls) == len(want)
    assert packs == [((10, wid, wid), tdt)] * (3 if entry == "k2" else 1)
    counts = {**fd.launch_counts(), **rg.launch_counts()}
    assert {k: v for k, v in counts.items() if v} == want
    for _, name, args in calls:
        if name == "wide_rounds_bwd_launch":
            assert args[35] == wid and args[38] == fb.wgrad_chunks(wid)
        elif name == "wide_roll_launch":
            assert args[17] == wid
        else:
            assert args[20] == wid
