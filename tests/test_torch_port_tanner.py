"""The port's Tanner graphs equal tpugnn's, field by field."""

import numpy as np
import pytest
import torch

from tpugnn.tanner import build_code as jax_build_code
from tpugnn_torch.tanner import TannerGraph, build_code

torch.set_num_threads(1)

_STATIC = ("name", "n_checks", "n_qubits", "n_edges", "n_checks_x", "n_checks_pad",
           "n_qubits_pad", "n_edges_pad", "k", "deg_max_check", "deg_max_qubit")


def _assert_same_graph(ref, got):
    for f in _STATIC:
        assert getattr(got, f) == getattr(ref, f), f
    for f in TannerGraph.array_fields():
        a, b = getattr(ref, f), getattr(got, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        a = np.asarray(a)
        assert b.dtype == a.dtype and b.shape == a.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("d", [3, 5, 11])
def test_every_field_equals_tpugnn(d):
    _assert_same_graph(jax_build_code("surface", d), build_code("surface", d))


@pytest.mark.parametrize("family,d", [("toric", 3), ("toric", 5), ("toric", 7),
                                      ("repetition", 5), ("steane", 3)])
def test_other_families_equal_tpugnn(family, d):
    """The toric, repetition and Steane codes, field by field."""
    _assert_same_graph(jax_build_code(family, d), build_code(family, d))


def test_to_device_gives_tensors():
    g = build_code("surface", 3)
    dg = g.to("cpu")
    for f in TannerGraph.array_fields():
        v = getattr(dg, f)
        if v is None:
            continue
        assert isinstance(v, torch.Tensor), f
        np.testing.assert_array_equal(v.numpy(), getattr(g, f))
    assert dg.n_checks_pad == g.n_checks_pad and dg.name == g.name


def test_unported_family_raises_naming_ported():
    with pytest.raises(ValueError, match="toric"):
        build_code("circuit", 3)
