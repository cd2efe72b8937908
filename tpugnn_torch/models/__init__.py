from tpugnn_torch.models.decoder import DecoderOutput, GNNDecoder
from tpugnn_torch.models.pallas_decoder import PallasDecoder

__all__ = ["DecoderOutput", "GNNDecoder", "PallasDecoder"]
