"""The port's flash attention against the JAX package's.

The port's plain versions (what its wrappers run on CPU tensors) are held
against torchsnapshot_tpu's Pallas kernels run in interpreter mode, as
tests/test_flash_attention.py runs them, on the same inputs made with
numpy from a seed. The CUDA kernels themselves are held against the plain
versions on the card (``cuda_only``; chip_smoke.py does the same at the
main path's shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.ops import causal_attention as jax_causal_attention
from torchsnapshot_tpu.ops import flash_causal_attention as jax_flash
from torchsnapshot_tpu.ops.flash_attention import (
    flash_attention_chunk as jax_flash_chunk,
)
from torchsnapshot_tpu_torch.ops import causal_attention
from torchsnapshot_tpu_torch.ops import flash_attention as fa

# One intra-op thread: the suite runs this file beside others in parallel
# workers, and torch's default of a thread per core would starve them (and
# their timing-sensitive tests).
torch.set_num_threads(1)

# f32 throughout: both sides run the same blockwise online softmax in f32,
# the same tiles in the same order, so they differ only by the summation
# order inside each matmul (XLA's against torch's CPU kernels): a few ulps.
TOL = 2e-5
# Gradients sum over every query (dK, dV) or key tile (dQ) on top of that,
# and the backward runs through another program on each side: 1e-4.
GRAD_TOL = 1e-4


def _qkv(seed: int, shape=(2, 256, 4, 32)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 64)])
def test_fused_plain_matches_jax_kernel(block_q, block_k) -> None:
    q, k, v = _qkv(0)
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=block_q, block_k=block_k, interpret=True,
    )
    got = fa.flash_causal_forward(*_t((q, k, v)), block_q=block_q, block_k=block_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 64)])
def test_chunk_plain_matches_jax_kernel(causal, block_q, block_k) -> None:
    q, k, v = _qkv(1)
    want = jax_flash_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block_q, block_k=block_k, interpret=True,
    )
    got = fa.flash_attention_chunk(
        *_t((q, k, v)), causal=causal, block_q=block_q, block_k=block_k
    )
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_chunk_against_a_longer_chunk() -> None:
    """s_q != s_k (a ring step's chunk): the local causal mask."""
    q, _, _ = _qkv(2, (1, 128, 2, 32))
    _, k, v = _qkv(3, (1, 256, 2, 32))
    for causal in (True, False):
        want = jax_flash_chunk(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=64, block_k=64, interpret=True,
        )
        got = fa.flash_attention_chunk(*_t((q, k, v)), causal=causal, block_q=64, block_k=64)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_dense_attention_matches_jax() -> None:
    q, k, v = _qkv(4)
    want = jax_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = causal_attention(*_t((q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 64)])
def test_gradients_match_jax_grad(block_q, block_k) -> None:
    q, k, v = _qkv(5)
    cot = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)

    def jax_loss(q, k, v):
        out = jax_flash(q, k, v, block_q=block_q, block_k=block_k, interpret=True)
        return jnp.sum(out * cot)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    tq, tk, tv = (t.requires_grad_() for t in _t((q, k, v)))
    out = fa.flash_causal_attention(tq, tk, tv, block_q=block_q, block_k=block_k)
    (out * torch.from_numpy(cot)).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_no_grad_takes_the_fused_path_and_grad_the_chunk_path(monkeypatch) -> None:
    calls = []
    monkeypatch.setattr(
        fa, "flash_causal_forward_plain",
        lambda *a, **kw: calls.append("fused") or torch.zeros(a[0].shape),
    )
    monkeypatch.setattr(
        fa, "flash_attention_chunk_plain",
        lambda q, *a, **kw: calls.append("chunk") or (
            torch.zeros(q.shape[0], q.shape[2], q.shape[1], q.shape[3]),
            torch.zeros(q.shape[0], q.shape[2], q.shape[1]),
            torch.ones(q.shape[0], q.shape[2], q.shape[1]),
        ),
    )
    q, k, v = _t(_qkv(7, (1, 128, 2, 32)))
    with torch.no_grad():
        fa.flash_causal_attention(q, k, v)
    fa.flash_causal_attention(q.requires_grad_(), k, v)
    assert calls == ["fused", "chunk"]


# The fused output's tolerance (rtol, atol). f32: TOL. bf16: both sides
# compute in f32 (agreeing to TOL) and round to bf16 once, which moves each
# by at most one bf16 ulp, 2^-7 of the value; 8e-3 is just above that.
FUSED_TOL = {torch.float32: (TOL, TOL), torch.bfloat16: (8e-3, TOL)}


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_kernels_match_plain_versions(dtype, d) -> None:
    """The kernels against their plain versions on the card, on the strided
    q/k/v slices of one fused projection as the model passes them. The
    chunk outputs are f32 on both sides, whatever the input dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((2, 256, 3, 4, d), generator=g, device="cuda").to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = dict(fa.launch_counts)
    torch.testing.assert_close(
        fa.flash_causal_forward(q, k, v).float(),
        fa.flash_causal_forward_plain(q, k, v).float(),
        rtol=FUSED_TOL[dtype][0], atol=FUSED_TOL[dtype][1],
    )
    for causal in (True, False):
        o, m, l = fa.flash_attention_chunk(q, k, v, causal=causal)
        ro, rm, rl = fa.flash_attention_chunk_plain(q, k, v, causal=causal)
        torch.testing.assert_close(o / l[..., None], ro / rl[..., None], rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(m, rm, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(l, rl, rtol=2e-5, atol=0.0)
    assert fa.launch_counts["flash_fwd"] == before["flash_fwd"] + 1
    assert fa.launch_counts["flash_chunk"] == before["flash_chunk"] + 2
