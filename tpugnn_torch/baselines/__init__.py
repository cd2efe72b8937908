"""Classical baseline decoders: union-find and exact MWPM on the host (C++
through ctypes, NumPy around it), and the on-device residual repair."""

from tpugnn_torch.baselines.mwpm import MWPMDecoder, MWPMSectorDecoder
from tpugnn_torch.baselines.union_find import UnionFindDecoder, uf_decode_py

__all__ = ["UnionFindDecoder", "uf_decode_py", "MWPMDecoder", "MWPMSectorDecoder"]
