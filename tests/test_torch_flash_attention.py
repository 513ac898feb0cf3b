"""The port's flash attention against the JAX package's.

The port's plain versions (what its wrappers run on CPU tensors) are held
against torchsnapshot_tpu's Pallas kernels run in interpreter mode, as
tests/test_flash_attention.py runs them, on the same inputs made with
numpy from a seed. The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda_kernels.py (``cuda_only``;
chip_smoke.py does the same at the main path's shapes); what the kernels
refuse is tested here.
"""

import math
import re

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


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _offset_by_one(shape):
    """A bf16 tensor whose base lies 2 bytes past an aligned buffer start."""
    buf = _bf16(int(np.prod(shape)) + 8)
    return buf[1 : 1 + int(np.prod(shape))].view(shape)


# What the CUDA kernels refuse; each entry makes (q, k, v) on the CPU and
# names a piece of the message. _check_kernel_inputs is plain Python over
# shapes, strides and addresses, so its refusals are tested here.
KERNEL_REFUSALS = {
    "float16": (lambda: [torch.zeros((2, 128, 2, 64), dtype=torch.float16)] * 3,
                "float32 or bfloat16"),
    "dtype-mismatch": (lambda: (torch.zeros((2, 128, 2, 64)),) + (_bf16((2, 128, 2, 64)),) * 2,
                       "q is torch.float32"),
    "device-mismatch": (lambda: (_bf16((2, 128, 2, 64)),)
                        + (torch.zeros((2, 128, 2, 64), dtype=torch.bfloat16, device="meta"),) * 2,
                        "is on meta"),
    "three-dims": (lambda: [_bf16((2, 128, 64))] * 3, "(batch, seq, heads, dim)"),
    "strided-head-dim": (lambda: [_bf16((2, 128, 2, 128))[..., ::2]] * 3, "contiguous head dim"),
    "head-dim-32": (lambda: [_bf16((2, 128, 2, 32))] * 3, "head dims (64, 128)"),
    "kv-shapes-differ": (lambda: (_bf16((2, 128, 2, 64)), _bf16((2, 128, 2, 64)),
                                  _bf16((2, 192, 2, 64))), "same shape and strides"),
    "kv-heads-differ": (lambda: (_bf16((2, 128, 2, 64)),) + (_bf16((2, 128, 4, 64)),) * 2,
                        "does not match q"),
    "seq-96": (lambda: [_bf16((2, 96, 2, 64))] * 3, "divisible by 64"),
    "bf16-base-off-16-bytes": (lambda: (_offset_by_one((2, 128, 2, 64)),)
                               + (_bf16((2, 128, 2, 64)),) * 2, "16-byte-aligned"),
    # seq stride of 132 elements = 264 bytes, 8 past a multiple of 16
    "bf16-seq-stride-off-16-bytes": (
        lambda: [_bf16(2 * 128 * 132).as_strided((2, 128, 2, 64), (128 * 132, 132, 64, 1))] * 3,
        "16-byte-aligned"),
}


@pytest.mark.parametrize("case", sorted(KERNEL_REFUSALS))
def test_kernel_input_check_refuses(case) -> None:
    make, message = KERNEL_REFUSALS[case]
    with pytest.raises(ValueError, match=re.escape(message)):
        fa._check_kernel_inputs(*make())


# What they take: the model's strided slices, a half tile, a chunk of
# another length, f32 at any address (the pre-pass reads f32 through its
# strides; only its scratch goes through TMA), and a size-1 dimension whose
# stride is unaligned (it is never used).
KERNEL_ACCEPTS = {
    "qkv-slices-d64": lambda: _bf16((2, 128, 3, 2, 64)).unbind(2),
    "qkv-slices-d128": lambda: _bf16((2, 128, 3, 2, 128)).unbind(2),
    "half-tile-192": lambda: [_bf16((2, 192, 2, 64))] * 3,
    "chunk-128x256": lambda: (_bf16((2, 128, 2, 64)),) + (_bf16((2, 256, 2, 64)),) * 2,
    "f32-base-off-16-bytes": lambda: (torch.zeros(2 * 128 * 2 * 64 + 1)[1:].view(2, 128, 2, 64),)
    + (torch.zeros((2, 128, 2, 64)),) * 2,
    "bf16-batch-1-odd-stride": lambda: [_bf16(128 * 2 * 64).as_strided((1, 128, 2, 64),
                                                                       (3, 128, 64, 1))] * 3,
    # f32: the pre-pass reads q, k, v through their strides and only its
    # scratch goes through TMA, so any stride and address will do.
    "f32-qkv-slices-d64": lambda: torch.zeros((2, 128, 3, 2, 64)).unbind(2),
    "f32-seq-stride-off-16-bytes": lambda: [
        torch.zeros(2 * 128 * 129).as_strided((2, 128, 2, 64), (128 * 129, 129, 64, 1))] * 3,
}


@pytest.mark.parametrize("case", sorted(KERNEL_ACCEPTS))
def test_kernel_input_check_accepts(case) -> None:
    fa._check_kernel_inputs(*KERNEL_ACCEPTS[case]())


# The chunk entry's o/l tolerance (fa.chunk_atol): f32 inputs keep the f32
# tolerance; bf16 inputs add the P split's residual, 2^-16 of the largest
# |v|, up to the cap. (dtype, the largest |v| with its sign, expected atol)
CHUNK_ATOL_CASES = {
    "f32": (torch.float32, 100.0, fa.F32_TOL),
    "bf16-max-1": (torch.bfloat16, 1.0, 2.0**-16 + fa.F32_TOL),
    "bf16-max-minus-4": (torch.bfloat16, -4.0, 4 * 2.0**-16 + fa.F32_TOL),
    "bf16-capped": (torch.bfloat16, 64.0, fa.SPLIT_TOL_CAP),
}


@pytest.mark.parametrize("case", sorted(CHUNK_ATOL_CASES))
def test_chunk_atol(case) -> None:
    dtype, vmax, want = CHUNK_ATOL_CASES[case]
    v = torch.zeros((1, 64, 1, 64), dtype=dtype)
    v[0, 3, 0, 5] = vmax
    assert fa.chunk_atol(v) == pytest.approx(want, rel=1e-12)


def test_split_wrapper_runs_the_plain_version_on_the_cpu() -> None:
    q, k, v = _t(_qkv(14, (1, 128, 2, 64)))
    before = dict(fa.launch_counts)
    for got, want in zip(fa.flash_split(q, k, v), fa.flash_split_plain(q, k, v)):
        assert torch.equal(got, want)
    assert fa.launch_counts == before


def test_compare_with_plain_runs_every_entry() -> None:
    """On CPU tensors both sides are the plain versions: every entry runs and
    agrees exactly, and no kernel launch is counted."""
    q, k, v = _t(_qkv(0, (1, 128, 2, 64)))
    before = dict(fa.launch_counts)
    assert fa.compare_with_plain(q, k, v, 64) == {
        "chunk_atol": fa.F32_TOL,
        "flash_fwd": 0.0,
        "flash_chunk_causal": 0.0,
        "flash_chunk_unmasked": 0.0,
    }
    assert fa.launch_counts == before


# ----------------------------------------------------------------------
# The f32 kernel: 3xTF32 split and the permuted vᵀ
# ----------------------------------------------------------------------


def test_tf32_split_is_exact() -> None:
    x = torch.from_numpy(
        np.random.default_rng(8).standard_normal(4096).astype(np.float32) * 1e3
    )
    hi, lo = fa.tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()  # low 13 mantissa bits zero
    assert torch.equal(hi + lo, x)
    assert (lo.abs() <= 2.0**-11 * x.abs()).all()  # rounded: half a tf32 ulp
    # ties go away from zero: 1 + 2^-11 lies halfway between two tf32 values
    tie = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)])
    assert fa.tf32_split(tie)[0].tolist() == [1 + 2.0**-10, -(1 + 2.0**-10)]


def test_key_permutation_is_undone_by_its_inverse() -> None:
    x = torch.arange(2 * 64, dtype=torch.float32).view(2, 64)
    p = fa.permute_keys(x)
    assert not torch.equal(p, x)
    assert p[0, :8].tolist() == [float(c) for c in fa.KEY_PERM]
    assert torch.equal(fa.unpermute_keys(p), x)


@pytest.mark.parametrize("d", [64, 128])
def test_split_plain_layout(d) -> None:
    q, k, v = _t(_qkv(9, (2, 128, 2, d)))
    qs, ks, vts = fa.flash_split_plain(q, k[:, :64], v[:, :64])
    assert qs.shape == (2, 2, 2, 128, d) and ks.shape == (2, 2, 2, 64, d)
    assert vts.shape == (2, 2, 2, d, 64)
    assert all(t.is_contiguous() for t in (qs, ks, vts))
    assert torch.equal(qs[0] + qs[1], q.transpose(1, 2))
    assert torch.equal(ks[0] + ks[1], k[:, :64].transpose(1, 2))
    assert torch.equal(fa.unpermute_keys(vts[0] + vts[1]), v[:, :64].transpose(1, 2).transpose(-1, -2))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an f32 operand: its tf32 bits (the low
    13 mantissa bits dropped)."""
    return (x.contiguous().view(torch.int32) & -(1 << 13)).view(torch.float32)


def _x3(a_hi, a_lo, b_hi, b_lo) -> torch.Tensor:
    """a @ b as the kernel's 3xTF32 product: hi·hi + hi·lo + lo·hi, each lo
    read as the tensor cores read it; lo·lo left out."""
    return a_hi @ b_hi + a_hi @ _tf32(b_lo) + _tf32(a_lo) @ b_hi


# Keys per K/V tile of the f32 kernel, by head dim (hopper::Tf32<D>::kKeys).
TF32_KEYS = {64: 64, 128: 32}


def _tf32x3_flash(q, k, v, causal: bool):
    """The f32 kernel's arithmetic, emulated in torch f32: the pre-pass's
    split scratch, key tiles of 64 (d = 64) or 32 (d = 128), S = Q Kᵀ as
    three tf32 products, the online softmax, P split into tf32 (hi, lo) in
    the registers and put into P V in the accumulator's key order against
    the permuted vᵀ. Returns ``(acc, m, l)`` as the chunk entry does."""
    keys = TF32_KEYS[q.shape[-1]]
    qs, ks, vts = fa.flash_split_plain(q, k, v)
    scale = q.shape[-1] ** -0.5
    sq, sk = q.shape[1], k.shape[1]
    rows = torch.arange(sq)[:, None]
    m = torch.full(qs.shape[1:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(qs.shape[1:])
    for t in range(sk // keys):
        cols = slice(t * keys, (t + 1) * keys)
        s = _x3(qs[0], qs[1], ks[0, ..., cols, :].transpose(-1, -2), ks[1, ..., cols, :].transpose(-1, -2))
        if causal:
            s = torch.where(t * keys + torch.arange(keys)[None, :] > rows, -torch.inf, s)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * scale)
        p = torch.exp(s * scale - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        p_hi, p_lo = fa.tf32_split(fa.permute_keys(p))  # the registers, in vᵀ's key order
        vt_hi, vt_lo = (x[..., cols].transpose(-1, -2) for x in vts)
        acc = acc * alpha + _x3(p_hi, p_lo, vt_hi, vt_lo)
        m = m_new
    return acc, m[..., 0], l[..., 0]


# (q shape, s_k, causal): d = 64 and 128, both masks, s_k != s_q
TF32X3_CHUNK_CASES = {
    "causal-256": ((1, 256, 2, 64), 256, True),
    "unmasked-256": ((1, 256, 2, 64), 256, False),
    "causal-128x256": ((1, 128, 2, 64), 256, True),
    "unmasked-128x256": ((1, 128, 2, 64), 256, False),
    "d128-causal-256": ((1, 256, 2, 128), 256, True),
    "d128-unmasked-256": ((1, 256, 2, 128), 256, False),
    "d128-causal-128x256": ((1, 128, 2, 128), 256, True),
    "d128-unmasked-128x256": ((1, 128, 2, 128), 256, False),
}


@pytest.mark.parametrize("case", sorted(TF32X3_CHUNK_CASES))
def test_tf32x3_emulation_matches_jax_chunk_kernel(case) -> None:
    shape, sk, causal = TF32X3_CHUNK_CASES[case]
    q, _, _ = _qkv(10, shape)
    _, k, v = _qkv(11, shape[:1] + (sk,) + shape[2:])
    want = jax_flash_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=64, block_k=64, interpret=True,
    )
    got = _tf32x3_flash(*_t((q, k, v)), causal)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=fa.F32_TOL, atol=fa.F32_TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 64)])
def test_tf32x3_emulation_matches_jax_fused_kernel(block_q, block_k, d) -> None:
    q, k, v = _qkv(12, (2, 256, 2, d))
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=block_q, block_k=block_k, interpret=True,
    )
    acc, _, l = _tf32x3_flash(*_t((q, k, v)), True)
    got = (acc / l[..., None]).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=fa.F32_TOL, atol=fa.F32_TOL)


def test_tf32x3_emulation_needs_both_the_split_and_the_permutation() -> None:
    """The test above has teeth: one tf32 product (no split), or P in the
    accumulator's key order against an unpermuted vᵀ, misses F32_TOL."""
    q, k, v = _t(_qkv(13, (1, 128, 2, 64)))
    want, _, l = fa.flash_attention_chunk_plain(q, k, v, causal=False)
    got, _, l_got = _tf32x3_flash(q, k, v, causal=False)
    assert (got / l_got[..., None] - want / l[..., None]).abs().max() < fa.F32_TOL
    one = _tf32(q.transpose(1, 2)) @ _tf32(k.transpose(1, 2)).transpose(-1, -2)
    exact = q.transpose(1, 2) @ k.transpose(1, 2).transpose(-1, -2)
    assert (one - exact).abs().max() > 100 * fa.F32_TOL
    vts = fa.flash_split_plain(q, k, v)[2]
    p = torch.softmax(exact / 8.0, dim=-1)
    wrong = fa.permute_keys(p) @ fa.unpermute_keys(vts[0] + vts[1]).transpose(-1, -2)
    right = fa.permute_keys(p) @ (vts[0] + vts[1]).transpose(-1, -2)
    assert (wrong - right).abs().max() > 100 * fa.F32_TOL
    assert (right - p @ v.transpose(1, 2)).abs().max() < fa.F32_TOL


# ----------------------------------------------------------------------
# The backward: which path each input takes, what the kernel refuses, and
# the kernel's split arithmetic against the plain backward
# ----------------------------------------------------------------------

# (device type, dtype, seq, head dim) -> whether the backward kernel takes it
BWD_ROUTES = {
    "card-bf16-d64": ("cuda", torch.bfloat16, 2048, 64, True),
    "card-bf16-half-tile-192": ("cuda", torch.bfloat16, 192, 64, True),
    "card-f32": ("cuda", torch.float32, 2048, 64, False),
    "cpu-bf16": ("cpu", torch.bfloat16, 2048, 64, False),
    "card-bf16-d128": ("cuda", torch.bfloat16, 2048, 128, False),
    "card-bf16-d32": ("cuda", torch.bfloat16, 256, 32, False),
    "card-bf16-seq-96": ("cuda", torch.bfloat16, 96, 64, False),
}


@pytest.mark.parametrize("case", sorted(BWD_ROUTES))
def test_backward_routes_by_what_it_observes(case) -> None:
    device_type, dtype, s, d, takes = BWD_ROUTES[case]
    assert fa._bwd_kernel_takes(device_type, dtype, s, d) is takes


# (dtype, head dim, whether the router sees a card) -> the path taken
BWD_PATHS = {
    "card-like-bf16": (torch.bfloat16, 64, True, "kernel"),
    "card-like-f32": (torch.float32, 64, True, "plain"),
    "card-like-bf16-d32": (torch.bfloat16, 32, True, "plain"),
    "cpu-bf16": (torch.bfloat16, 64, False, "plain"),
}


@pytest.mark.parametrize("case", sorted(BWD_PATHS))
def test_backward_takes_the_kernel_entry_or_the_blockwise_one(monkeypatch, case) -> None:
    """Under autograd, the backward of flash_causal_attention goes to the
    kernel entry (flash_bwd) for bf16 at d = 64 on a card, and to
    flash_bwd_blockwise for anything else; backward_paths counts each.
    The router is shown CPU tensors as a card's (device type "cuda") where
    the case says so; the kernel entry is recorded, not run."""
    dtype, d, card, path = BWD_PATHS[case]
    calls = []
    real_takes, real_blockwise = fa._bwd_kernel_takes, fa.flash_bwd_blockwise
    if card:
        monkeypatch.setattr(fa, "_bwd_kernel_takes", lambda _, *a: real_takes("cuda", *a))
    monkeypatch.setattr(
        fa, "flash_bwd",
        lambda q, *a: calls.append("kernel") or tuple(torch.zeros_like(q) for _ in "qkv"),
    )
    monkeypatch.setattr(
        fa, "flash_bwd_blockwise", lambda *a: calls.append("plain") or real_blockwise(*a)
    )
    q, k, v = (t.to(dtype).requires_grad_() for t in _t(_qkv(15, (1, 128, 2, d))))
    fa.reset_launch_counts()
    fa.flash_causal_attention(q, k, v).float().sum().backward()
    assert calls == [path]
    assert fa.backward_paths == {"kernel": int(path == "kernel"), "plain": int(path == "plain")}
    assert q.grad.shape == q.shape and q.grad.dtype == dtype
    fa.reset_launch_counts()
    assert fa.backward_paths == {"kernel": 0, "plain": 0}


def _bf16_qkvg(seed: int, shape=(1, 128, 2, 64)):
    """bf16 q, k, v and an upstream gradient on the CPU, from a seed."""
    return [t.to(torch.bfloat16) for t in _t(_qkv(seed, shape) + _qkv(seed + 1, shape)[:1])]


def test_backward_counts_no_launch_on_the_cpu() -> None:
    """The kernel entry on CPU tensors runs the plain version and counts no
    launch; reset_launch_counts zeroes the backward's counters too."""
    q, k, v, do = _bf16_qkvg(16)
    o_u, m, l = fa.flash_attention_chunk(q, k, v, causal=True)
    o = o_u / l[..., None]
    fa.reset_launch_counts()
    got = fa.flash_bwd(q, k, v, m, l, o, do)
    want = fa.flash_bwd_plain(q, k, v, m, l, o, do)
    assert all(torch.equal(g, w) and g.dtype == torch.bfloat16 for g, w in zip(got, want))
    assert fa.launch_counts["flash_bwd"] == 0
    fa.launch_counts["flash_bwd"] = 3
    fa.backward_paths["kernel"] = 2
    fa.reset_launch_counts()
    assert fa.launch_counts["flash_bwd"] == 0 and fa.backward_paths["kernel"] == 0


def test_compare_bwd_with_plain_runs_on_the_cpu() -> None:
    """On CPU tensors both sides are the plain version: they agree exactly."""
    q, k, v, do = _bf16_qkvg(18)
    before = dict(fa.launch_counts)
    assert fa.compare_bwd_with_plain(q, k, v, do) == {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    assert fa.launch_counts == before


def _bwd_args(shape=(2, 128, 2, 64), do=None, o=None, m=None, l=None, qkv=None):
    """(q, k, v, m, l, o, do) that the backward kernel takes, on the CPU,
    with any of them replaced."""
    b, s, h, d = shape
    q, k, v = qkv if qkv is not None else [_bf16(shape)] * 3
    stats = torch.zeros((b, h, s))
    return (
        q, k, v, stats if m is None else m, stats if l is None else l,
        torch.zeros((b, h, s, d)) if o is None else o, _bf16(shape) if do is None else do,
    )


# What the backward kernel refuses (beside what the forward kernels refuse,
# which its check runs first); each names a piece of the message.
BWD_REFUSALS = {
    "f32": (lambda: _bwd_args(qkv=[torch.zeros((2, 128, 2, 64))] * 3), "takes bfloat16"),
    "head-dim-128": (lambda: _bwd_args((2, 128, 2, 128)), "head dims (64,)"),
    "q-strided-head-dim": (lambda: _bwd_args(qkv=[_bf16((2, 128, 2, 128))[..., ::2]] * 3),
                           "contiguous head dim"),
    "kv-longer-than-q": (lambda: _bwd_args(qkv=(_bf16((2, 128, 2, 64)),) + (_bf16((2, 256, 2, 64)),) * 2),
                         "as long as q"),
    "do-shape": (lambda: _bwd_args(do=_bf16((2, 192, 2, 64))), "do must match q"),
    "do-f32": (lambda: _bwd_args(do=torch.zeros((2, 128, 2, 64))), "do must match q"),
    "do-strided-head-dim": (lambda: _bwd_args(do=_bf16((2, 128, 2, 128))[..., ::2]), "contiguous head dim"),
    "do-base-off-16-bytes": (lambda: _bwd_args(do=_offset_by_one((2, 128, 2, 64))), "16-byte-aligned"),
    "do-seq-stride-off-16-bytes": (
        lambda: _bwd_args(do=_bf16(2 * 128 * 132).as_strided((2, 128, 2, 64), (128 * 132, 132, 64, 1))),
        "16-byte-aligned"),
    "o-in-the-inputs-layout": (lambda: _bwd_args(o=torch.zeros((2, 128, 2, 64))), "o must be contiguous float32"),
    "m-bf16": (lambda: _bwd_args(m=_bf16((2, 2, 128))), "m must be contiguous float32"),
    "l-not-contiguous": (lambda: _bwd_args(l=torch.zeros((2, 128, 2)).transpose(1, 2)),
                         "l must be contiguous float32"),
}


@pytest.mark.parametrize("case", sorted(BWD_REFUSALS))
def test_bwd_input_check_refuses(case) -> None:
    make, message = BWD_REFUSALS[case]
    with pytest.raises(ValueError, match=re.escape(message)):
        fa._check_bwd_inputs(*make())


def test_bwd_input_check_accepts_the_models_slices() -> None:
    """q, k, v as the strided slices of one fused projection, as the model
    passes them, and a half tile."""
    fa._check_bwd_inputs(*_bwd_args(qkv=_bf16((2, 128, 3, 2, 64)).unbind(2)))
    fa._check_bwd_inputs(*_bwd_args((2, 192, 2, 64)))


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split_bf16(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel feeds an f32 operand to the tensor cores: two bf16
    terms, hi = bf16(x) and lo = bf16(x - hi), summed in f32."""
    hi = _round_bf16(x)
    return hi + _round_bf16(x - hi)


def _split_bwd(q, k, v, m, l, o, do, operand=_split_bf16):
    """The backward kernel's arithmetic, emulated in f32 (all (b, h, s, d)):
    bf16 operands, P from lse2 = m log2(e) + log2(l) through exp2, and P, dS
    into their products as ``operand`` makes them (two bf16 terms each)."""
    s, d = q.shape[2], q.shape[3]
    scale = d**-0.5
    lse2 = m * math.log2(math.e) + torch.log2(l)
    logits = scale * (q @ k.transpose(-1, -2))
    p = torch.exp2(logits * math.log2(math.e) - lse2[..., None])
    p = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), p, 0.0)
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True))
    p2, ds2 = operand(p), operand(ds)
    return scale * ds2 @ k, scale * ds2.transpose(-1, -2) @ q, p2.transpose(-1, -2) @ do


def test_split_backward_emulation_is_within_grad_tol() -> None:
    """GRAD_TOL has room: the kernel's split arithmetic lands within it of
    flash_bwd_blockwise on the same bf16 inputs upcast to f32, while one
    bf16 rounding of P and dS (no lo term) misses it in every gradient."""
    q, k, v, do = _bf16_qkvg(20, (1, 512, 2, 64))
    o_u, m, l = fa.flash_attention_chunk(q, k, v, causal=True)
    o = o_u / l[..., None]
    up = [x.transpose(1, 2).float() for x in (q, k, v, do)]
    want = fa.flash_bwd_blockwise(*up[:3], m, l, o, up[3], 128)
    got = _split_bwd(*up[:3], m, l, o, up[3])
    once = _split_bwd(*up[:3], m, l, o, up[3], operand=_round_bf16)
    for g, g_once, w in zip(got, once, want):
        assert (g - w).abs().max() <= fa.GRAD_TOL * w.abs().max()
        assert (g_once - w).abs().max() > fa.GRAD_TOL * w.abs().max()
