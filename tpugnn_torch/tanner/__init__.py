"""Code families -> padded Tanner graphs.  Only the surface code is ported."""

from tpugnn_torch.tanner.graph import TannerGraph, build_tanner_graph
from tpugnn_torch.tanner.surface import build_surface_code, surface_code_checks

_FAMILIES = {"surface": build_surface_code}


def build_code(family: str, distance: int, **kw) -> TannerGraph:
    """Build a ported code family by name."""
    try:
        builder = _FAMILIES[family]
    except KeyError:
        raise ValueError(f"unknown or unported code family {family!r}; "
                         f"ported: {sorted(_FAMILIES)}") from None
    return builder(distance, **kw)


__all__ = ["TannerGraph", "build_tanner_graph", "build_code",
           "build_surface_code", "surface_code_checks"]
