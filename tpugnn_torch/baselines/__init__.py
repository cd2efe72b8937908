"""Classical baseline decoders: union-find and exact MWPM on the host (C++
through ctypes, NumPy around it), min-sum BP on the device, BP+OSD-0 (BP on
the device, OSD on the host), and the on-device residual repair."""

from tpugnn_torch.baselines.bp import bp_decode, bp_posteriors
from tpugnn_torch.baselines.mwpm import MWPMDecoder, MWPMSectorDecoder
from tpugnn_torch.baselines.osd import BPOSDDecoder, osd0_py
from tpugnn_torch.baselines.union_find import UnionFindDecoder, uf_decode_py

__all__ = ["UnionFindDecoder", "uf_decode_py", "MWPMDecoder", "MWPMSectorDecoder",
           "bp_decode", "bp_posteriors", "BPOSDDecoder", "osd0_py"]
