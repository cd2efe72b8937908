from tpugnn_torch.models.decoder import DecoderOutput, GNNDecoder

__all__ = ["DecoderOutput", "GNNDecoder"]
