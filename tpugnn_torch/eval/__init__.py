from tpugnn_torch.eval.ler import count_failures, decode_corrections, ler_monte_carlo

__all__ = ["count_failures", "decode_corrections", "ler_monte_carlo"]
