"""The port's edge partitioner against the JAX package's, and what needs no
rank: every table bit-equal to ``tpugnn.dist.partition``'s, the invariants
of ``tests/dist/test_partition.py``, the int8 wire's integers equal to
``tpugnn.dist.exchange._quant_pack``'s, and the refusals that come before
any collective."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugnn.configs import config as jconfig
from tpugnn.dist import build_partitioned_code as jax_build_partitioned_code
from tpugnn.dist.exchange import _dequant as jax_dequant
from tpugnn.dist.exchange import _quant_pack as jax_quant_pack
from tpugnn_torch.configs import MeshConfig, ModelConfig
from tpugnn_torch.dist import build_partitioned_code, partition_graph
from tpugnn_torch.dist.exchange import _dequant, _quant_pack
from tpugnn_torch.dist.partition import ARRAYS
from tpugnn_torch.models import GNNDecoder
from tpugnn_torch.tanner import build_code

torch.set_num_threads(1)

CASES = [("surface", 5, 4), ("toric", 3, 2), ("surface", 3, 8)]
STATICS = ("name", "n_parts", "mb", "nb", "ec_pad", "eq_pad", "n_checks", "n_qubits", "k",
           "halo", "halo_dtype", "hq", "hc")


@pytest.mark.parametrize("halo", ["alltoall", "ring", "gather"])
@pytest.mark.parametrize("family,d,P", CASES)
def test_tables_equal_jax(family, d, P, halo):
    jg, jpg = jax_build_partitioned_code(family, d, P, halo=halo)
    g, pg = build_partitioned_code(family, d, P, halo=halo)
    for f in STATICS:
        assert getattr(pg, f) == getattr(jpg, f), f
    assert jpg.mesh_axis == "graph"
    for f in ARRAYS:
        ref, got = getattr(jpg, f), getattr(pg, f)
        if ref is None:
            assert got is None, f
            continue
        ref = np.asarray(ref)
        assert got.dtype == ref.dtype and got.shape == ref.shape, f
        np.testing.assert_array_equal(got, ref, err_msg=f)


@pytest.mark.parametrize("family,d,P", CASES)
def test_every_edge_assigned_exactly_once_per_direction(family, d, P):
    graph, pg = build_partitioned_code(family, d, P)
    ref = set(zip(np.asarray(graph.edge_check)[: graph.n_edges].tolist(),
                  np.asarray(graph.edge_qubit)[: graph.n_edges].tolist()))
    got_c, got_q = [], []
    for p in range(P):
        m = pg.c_mask[p] > 0
        got_c += list(zip((pg.c_dst[p][m] + p * pg.mb).tolist(), pg.c_src[p][m].tolist()))
        m = pg.q_mask[p] > 0
        got_q += list(zip(pg.q_src[p][m].tolist(), (pg.q_dst[p][m] + p * pg.nb).tolist()))
    assert len(got_c) == graph.n_edges and set(got_c) == ref
    assert len(got_q) == graph.n_edges and set(got_q) == ref


@pytest.mark.parametrize("family,d,P", CASES)
def test_halo_tables_cover_every_edge_once(family, d, P):
    """Interior plus boundary edges are the shard's edges, and each boundary
    edge's halo slot holds its source row on the sending shard."""
    graph, pg = build_partitioned_code(family, d, P)
    for p in range(P):
        for pre, send, block, h in (("c", pg.qsend_idx, pg.nb, pg.hq),
                                    ("q", pg.csend_idx, pg.mb, pg.hc)):
            eid = np.asarray(getattr(pg, f"{pre}_eid")[p])[getattr(pg, f"{pre}_mask")[p] > 0]
            i_m = getattr(pg, f"{pre}i_mask")[p] > 0
            b_m = getattr(pg, f"{pre}b_mask")[p] > 0
            ie = getattr(pg, f"{pre}i_eid")[p][i_m]
            be = getattr(pg, f"{pre}b_eid")[p][b_m]
            assert sorted(np.concatenate([ie, be]).tolist()) == sorted(eid.tolist())
            src_of = np.asarray(graph.edge_qubit if pre == "c" else graph.edge_check)
            for e, s in zip(be, getattr(pg, f"{pre}b_src")[p][b_m]):
                sender, slot = divmod(int(s), h)
                assert sender != p
                assert send[sender, p, slot] + sender * block == src_of[e]


@pytest.mark.parametrize("family,d,P", CASES)
def test_real_halo_rows_come_first(family, d, P):
    """Each peer's real halo slots are a prefix, so the exchange moves only
    them; the views carry their counts both ways."""
    _, pg = build_partitioned_code(family, d, P)
    for mask, field in ((pg.qsend_mask, "q_halo_rows"), (pg.csend_mask, "c_halo_rows")):
        n = mask.sum(-1).astype(np.int64)
        width = mask.shape[-1]
        np.testing.assert_array_equal(mask, np.arange(width) < n[..., None])
        for r in range(P):
            assert getattr(pg.shard(r), field) == (tuple(n[r]), tuple(n[:, r]))
    assert pg.shard(0).q_halo_rows[0][0] == 0          # nothing to itself
    _, pg_gather = build_partitioned_code(family, d, P, halo="gather")
    assert pg_gather.shard(0).q_halo_rows == ()


def test_ownership_is_contiguous_blocks():
    graph, pg = build_partitioned_code("surface", 5, 4)
    assert int(pg.c_dst.max()) < pg.mb and int(pg.q_dst.max()) < pg.nb
    np.testing.assert_array_equal(pg.check_mask.reshape(-1), graph.check_mask)
    np.testing.assert_array_equal(pg.qubit_mask.reshape(-1), graph.qubit_mask)


def test_indivisible_padding_rejected():
    g = build_code("surface", 3, pad_nodes=8)   # 8 % 3 != 0 blocks
    with pytest.raises(ValueError, match="divide"):
        partition_graph(g, 3)


def test_unknown_halo_mode_rejected():
    g = build_code("surface", 3, pad_nodes=16)
    with pytest.raises(ValueError, match="halo mode"):
        partition_graph(g, 2, halo="broadcast")


def test_shard_view_is_one_row_on_the_device():
    graph, pg = build_partitioned_code("surface", 5, 4)
    view = pg.shard(2)
    assert (view.n_checks_pad, view.n_qubits_pad) == (pg.mb, pg.nb)
    assert (view.n_checks, view.n_qubits, view.rank, view.n_parts) == (
        graph.n_checks, graph.n_qubits, 2, 4)
    assert view.partitioned and view.group is None
    for f in ARRAYS:
        got = getattr(view, f)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu", f
        np.testing.assert_array_equal(got.numpy(), getattr(pg, f)[2], err_msg=f)
        assert got.dtype in (torch.int64, torch.float32), f
    with pytest.raises(ValueError, match="shards"):
        pg.shard(4)


def test_mesh_config_equals_tpugnn():
    fields = lambda cls: {f.name: f.default for f in dataclasses.fields(cls)}
    assert fields(MeshConfig) == fields(jconfig.MeshConfig)


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_fused_backends_refuse_a_view(backend):
    """The fused layout has no partitioned rounds: a view raises, naming the
    conversion to the generic layout, before any exchange."""
    _, pg = build_partitioned_code("surface", 3, 2)
    model = GNNDecoder(ModelConfig(hidden=8, msg_hidden=8, rounds=2, backend=backend), k=1)
    with pytest.raises(ValueError, match="convert_fused_round_params"):
        model(pg.shard(0), torch.zeros(2, pg.mb))


def test_int8_wire_equals_jax_quant_pack():
    """The int8 payload, its scale and the dequantised buffer equal the JAX
    package's on the same f32 send buffer, half-way values included."""
    rng = np.random.default_rng(0)
    send = rng.normal(size=(8, 4, 16, 16)).astype(np.float32)
    send[0, 1, 2, :] = 0.0                       # a zero row
    send[1, 2] = 0.0                             # a whole zero slice: scale 1e-30
    send[2, 0] = 0.0                             # scale 1: x * 127 lands on +-63.5
    send[2, 0, 0, :4] = [0.5, -0.5, 0.5, 1.0]
    jq, js = jax_quant_pack(jnp.asarray(send), "int8")
    q, s = _quant_pack(torch.from_numpy(send), "int8")
    assert q.dtype == torch.int8
    assert q[2, 0, 0, :4].tolist() == [64, -64, 64, 127]     # half to even
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_dequant(q, s, "int8").numpy(),
                                  np.asarray(jax_dequant(jq, js, "int8")))
    bq, _ = _quant_pack(torch.from_numpy(send), "bfloat16")
    jb, _ = jax_quant_pack(jnp.asarray(send), "bfloat16")
    np.testing.assert_array_equal(bq.float().numpy(), np.asarray(jb, np.float32))


def test_unknown_halo_dtype_raises():
    with pytest.raises(ValueError, match="halo_dtype"):
        _quant_pack(torch.zeros(2, 2, 8, 4), "float16")
