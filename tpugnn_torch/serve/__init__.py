from tpugnn_torch.serve.engine import DecodeEngine

__all__ = ["DecodeEngine"]
