"""Operations and bytes computed from shapes, and the card's published peaks.

Copied from the repository's roofline arithmetic (``PERF.md``'s kernel
table, ``chip_smoke.py``'s ``kernel_phase``) so that the yardstick lives
with the benchmark: later changes to the program cannot move it.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

BYTES_PER_ELEMENT = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class Dims:
    """The widths a training step runs at, as the configuration states them."""

    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    batch: int
    seq: int
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq


def layer_matmul_params(d: Dims) -> int:
    """``wqkv`` (d, 3d), ``wo`` (d, d), ``w_in`` (d, f), ``w_out`` (f, d)."""
    return 4 * d.d_model * d.d_model + 2 * d.d_model * d.d_ff


def matmul_params(d: Dims) -> int:
    """Parameters that enter a matrix product: every block's projections
    and the unembedding. The embedding is a gather and the norm scales are
    elementwise, so neither counts."""
    return d.n_layers * layer_matmul_params(d) + d.d_model * d.vocab


def param_count(d: Dims) -> int:
    """Every parameter of the train state: the embedding and unembedding,
    each block's projections and two norm scales, and the final norm."""
    return 2 * d.vocab * d.d_model + d.n_layers * (layer_matmul_params(d) + 2 * d.d_model) + d.d_model


def leaf_count(d: Dims) -> int:
    """Tensors on the card: each parameter and its two AdamW moments."""
    return 3 * (3 + 6 * d.n_layers)


def state_bytes(d: Dims) -> int:
    """Parameters and both AdamW moments, all in the parameter dtype."""
    return 3 * param_count(d) * BYTES_PER_ELEMENT[d.dtype]


def attention_flops_fwd(b: int, h: int, s: int, hd: int) -> float:
    """QK^T and PV of a causal attention: 2 x 2 x b h s^2 hd, halved by the mask."""
    return 4.0 * b * h * s * s * hd / 2


def step_flops(d: Dims) -> float:
    """Model FLOPs of one training step, with no recompute: 6 x matmul
    parameters x tokens, plus causal attention's forward and backward,
    3 x 2 b s^2 d_model a layer."""
    attn = 3 * attention_flops_fwd(d.batch, d.n_heads, d.seq, d.head_dim) * d.n_layers
    return 6.0 * matmul_params(d) * d.tokens_per_step + attn


def flash_chunk_flops(b: int, s: int, h: int, hd: int) -> float:
    """``ts_flash_chunk`` in its causal mode, the forward of a training step."""
    return attention_flops_fwd(b, h, s, hd)


def flash_chunk_bytes(b: int, s: int, h: int, hd: int, itemsize: int = 2) -> int:
    """q, k, v read once in the input dtype; the f32 accumulator (b, h, s, hd)
    and the f32 m and l (b, h, s) written once."""
    return 3 * b * s * h * hd * itemsize + 4 * b * h * s * (hd + 2)


def flash_chunk_bound_s(b: int, s: int, h: int, hd: int, itemsize: int = 2) -> float:
    """The least time the card could take: the larger of the bytes over HBM
    bandwidth and the operations over the bf16 peak."""
    return max(
        flash_chunk_bytes(b, s, h, hd, itemsize) / HBM_BYTES_PER_S,
        flash_chunk_flops(b, s, h, hd) / PEAK_BF16_FLOPS,
    )
