"""Streaming (sliding-window) decoding over unbounded syndrome streams."""

from tpugnn_torch.streaming.window import SlidingWindowDecoder, sample_stream, stream_ler

__all__ = ["SlidingWindowDecoder", "sample_stream", "stream_ler"]
