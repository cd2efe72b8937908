from tpugnn_torch.sampling.noise import (
    SyndromeBatch,
    logical_class_bits,
    sample_batch,
    sample_depolarizing,
    syndrome,
)

__all__ = ["SyndromeBatch", "sample_batch", "sample_depolarizing", "syndrome",
           "logical_class_bits"]
