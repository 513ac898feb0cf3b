"""Operations and bytes computed from shapes, and the card's published peaks.

Copied from the repository's roofline arithmetic (``PERF.md``'s kernel
table, ``chip_smoke.py``'s ``kernel_phase``) so that the yardstick lives
with the benchmark: later changes to the program cannot move it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

BYTES_PER_ELEMENT = {"bfloat16": 2, "float16": 2, "float32": 4}


def attention_flops_fwd(b: int, h: int, s: int, hd: int) -> float:
    """QK^T and PV of a causal attention: 2 x 2 x b h s^2 hd, halved by the mask."""
    return 4.0 * b * h * s * s * hd / 2


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


def flash_bwd_flops(b: int, s: int, h: int, hd: int) -> float:
    """The causal attention backward's model work: five b h s^2 hd products
    (S = q k^T again, dV = P^T dO, dP = dO v^T, dQ = dS k, dK = dS^T q), two
    operations a multiply-add, halved by the mask. What an implementation
    adds (``ts_flash_bwd``'s P and dS as two bf16 terms each) is not the
    model's and does not count."""
    return 5 * 2.0 * b * h * s * s * hd / 2


def flash_bwd_bytes(b: int, s: int, h: int, hd: int, itemsize: int = 2) -> int:
    """q, k, v, o and dO read and dq, dk, dv written once in the input
    dtype; the f32 m and l (b, h, s) read once."""
    return 8 * b * s * h * hd * itemsize + 2 * 4 * b * h * s


def flash_bwd_bound_s(b: int, s: int, h: int, hd: int, itemsize: int = 2) -> float:
    """The least time the card could take for one backward call, as
    ``flash_chunk_bound_s`` takes it."""
    return max(
        flash_bwd_bytes(b, s, h, hd, itemsize) / HBM_BYTES_PER_S,
        flash_bwd_flops(b, s, h, hd) / PEAK_BF16_FLOPS,
    )
