"""Device ops of the port: attention and its hand-written CUDA kernels."""

from .attention import causal_attention
from .flash_attention import (
    flash_attention_chunk,
    flash_causal_attention,
    flash_causal_forward,
)

__all__ = [
    "causal_attention",
    "flash_attention_chunk",
    "flash_causal_attention",
    "flash_causal_forward",
]
