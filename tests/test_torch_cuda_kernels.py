"""The port's hand-written CUDA kernels against their plain versions, on
the card.

Every test here is ``cuda_only`` and skips without a card. The file imports
neither jax nor the JAX package, so it runs on a machine with a card and no
jax: ``python -m pytest --noconftest -m cuda_only tests/test_torch_cuda_kernels.py``
(``--noconftest`` skips the suite's jax set-up). chip_smoke.py holds the same
kernels at the main path's shapes.
"""

import pytest
import torch

from torchsnapshot_tpu_torch.ops import flash_attention as fa

# (b, s_q, s_k, h, q/k/v as slices of one fused projection)
CUDA_CASES = {
    "qkv-slices-256": (2, 256, 256, 4, True),
    "half-tile-192": (2, 192, 192, 4, False),
    "chunk-128x256": (2, 128, 256, 4, False),
}


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_kernels_match_plain_versions(case, dtype, d) -> None:
    """The kernels against their plain versions on the card: on the strided
    q/k/v slices of one fused projection as the model passes them, on a
    sequence of 64 but not 128 (the bf16 kernel's half tile), and on a chunk
    whose keys outnumber its queries. The tolerances, and why, sit beside
    ``fa.compare_with_plain``: the chunk outputs are f32 on both sides,
    whatever the input dtype, and bf16 o/l is held to the P-split bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    b, sq, sk, h, fused_qkv = CUDA_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(0)
    if fused_qkv:
        qkv = torch.randn((b, sq, 3, h, d), generator=g, device="cuda").to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((b, sk, h, d), generator=g, device="cuda").to(dtype) for _ in "kv")
    block = 128 if sq % 128 == 0 and sk % 128 == 0 else 64
    before = dict(fa.launch_counts)
    fa.compare_with_plain(q, k, v, block)
    assert fa.launch_counts["flash_fwd"] == before["flash_fwd"] + (sq == sk)
    assert fa.launch_counts["flash_chunk"] == before["flash_chunk"] + 2
