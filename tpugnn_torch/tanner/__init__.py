"""Code families -> padded Tanner graphs (surface, toric, repetition, Steane),
and the spacetime detector graphs of one sector."""

from tpugnn_torch.tanner.graph import TannerGraph, build_tanner_graph
from tpugnn_torch.tanner.spacetime import build_spacetime_code, spacetime_matrix
from tpugnn_torch.tanner.repetition import build_repetition_code, repetition_code_checks
from tpugnn_torch.tanner.steane import build_steane_code, steane_code_checks
from tpugnn_torch.tanner.surface import build_surface_code, surface_code_checks
from tpugnn_torch.tanner.toric import build_toric_code, toric_code_checks

_FAMILIES = {
    "surface": build_surface_code,
    "toric": build_toric_code,
    "repetition": build_repetition_code,
    "steane": build_steane_code,
}


def build_code(family: str, distance: int, **kw) -> TannerGraph:
    """Build a ported code family by name."""
    try:
        builder = _FAMILIES[family]
    except KeyError:
        raise ValueError(f"unknown or unported code family {family!r}; "
                         f"ported: {sorted(_FAMILIES)}") from None
    return builder(distance, **kw)


__all__ = ["TannerGraph", "build_tanner_graph", "build_code",
           "build_surface_code", "build_toric_code", "build_repetition_code",
           "build_steane_code", "surface_code_checks", "toric_code_checks",
           "repetition_code_checks", "steane_code_checks",
           "build_spacetime_code", "spacetime_matrix"]
