"""Monte-Carlo logical-error-rate evaluation: the GNN's heads, the hybrid
GNN + cleanup decoders and the classical baselines."""

from tpugnn_torch.eval.baseline import ler_bp, ler_bp_osd
from tpugnn_torch.eval.hybrid import (
    gnn_cleanup_corrections,
    ler_best_of,
    ler_gnn_cleanup,
    logical_head_correction,
)
from tpugnn_torch.eval.ler import count_failures, decode_corrections, ler_monte_carlo

__all__ = [
    "count_failures",
    "decode_corrections",
    "gnn_cleanup_corrections",
    "ler_best_of",
    "ler_bp",
    "ler_bp_osd",
    "ler_gnn_cleanup",
    "ler_monte_carlo",
    "logical_head_correction",
]
