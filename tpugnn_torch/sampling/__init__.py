from tpugnn_torch.sampling.noise import (
    SyndromeBatch,
    logical_class_bits,
    sample_batch,
    sample_depolarizing,
    syndrome,
    training_rate,
)

__all__ = ["SyndromeBatch", "sample_batch", "sample_depolarizing", "syndrome",
           "logical_class_bits", "training_rate"]
