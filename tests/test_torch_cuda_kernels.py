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
    whatever the input dtype, and bf16 o/l is held to the P-split bound. f32
    runs the split pre-pass before each entry's kernel."""
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
    split = dtype == torch.float32
    assert fa.launch_counts["flash_split"] == before["flash_split"] + split * ((sq == sk) + 2)


def _f32_qkv(case: str, d: int):
    b, sq, sk, h, fused_qkv = CUDA_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(3)
    if fused_qkv:
        return torch.randn((b, sq, 3, h, d), generator=g, device="cuda").unbind(2)
    return (torch.randn((b, n, h, d), generator=g, device="cuda") for n in (sq, sk, sk))


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
@pytest.mark.parametrize("d", [64, 128])
def test_split_pre_pass_matches_plain_version_bitwise(case, d) -> None:
    """The f32 pre-pass (hi and lo of q and k, and of vᵀ with its keys
    permuted) against its plain version, bit for bit, on the strided
    fused-qkv slices, a half tile and a chunk of another length."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _f32_qkv(case, d)
    for got, want in zip(fa.flash_split(q, k, v), fa.flash_split_plain(q, k, v)):
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
@pytest.mark.parametrize("d", [64, 128])
def test_f32_kernels_are_deterministic(case, d) -> None:
    """f32: two calls on the same inputs give the same bits (no atomics, a
    fixed summation order), for both entries and both masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v = _f32_qkv(case, d)
    runs = []
    for _ in range(2):
        out = [] if q.shape[1] != k.shape[1] else [fa.flash_causal_forward(q, k, v, 64, 64)]
        for causal in (True, False):
            out += fa.flash_attention_chunk(q, k, v, causal, 64, 64)
        runs.append(out)
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# The digest kernel's cases: every dtype the port serializes and the digest
# takes, odd lengths, row ranges (unaligned starts), an unaligned tail, an
# empty tensor and a non-contiguous view.
DIGEST_DTYPES = [
    torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int64,
    torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
    torch.float8_e4m3fn, torch.uint16, torch.uint32,
]


def _digest_specs(dtype: torch.dtype) -> list:
    g = torch.Generator(device="cuda").manual_seed(1)
    if dtype == torch.bool:
        make = lambda *s: torch.rand(s, generator=g, device="cuda") > 0.5  # noqa: E731
    elif dtype.is_floating_point:
        make = lambda *s: (100 * torch.randn(s, generator=g, device="cuda")).to(dtype)  # noqa: E731
    else:
        make = lambda *s: torch.randint(0, 100, s, generator=g, device="cuda").to(dtype)  # noqa: E731
    big = make(1031, 77)  # odd rows and row bytes, more than one tile
    return [
        (big, None),
        (big, ((0, 1), (3, 517), (517, 1031), (9, 9))),
        (make(3, 5), None),  # a tail shorter than one 16-byte load
        (make(0), None),
        (make(64, 33)[:, 1::2], None),  # non-contiguous: its contiguous image
        (make(200_003), ((7, 199_999),)),
    ]


@pytest.mark.cuda_only
@pytest.mark.parametrize("dtype", DIGEST_DTYPES, ids=str)
def test_digest_kernel_matches_plain_version(dtype) -> None:
    """Bit for bit: the kernel against the plain torch version on the card
    and the host digest of the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torchsnapshot_tpu_torch.ops import device_digest as dd

    specs = _digest_specs(dtype)
    before = dd.launch_counts["device_digest"]
    kernel = dd.materialize_many(dd.digest_many_async(specs))
    assert dd.launch_counts["device_digest"] == before + 1
    assert (kernel == dd.materialize_many(dd.digest_many_plain(specs))).all()
    host = [(t.cpu(), r) for t, r in specs]
    assert (kernel == dd.materialize_many(dd.digest_many_plain(host))).all()
    first = dd.digest_host(specs[0][0].cpu())
    assert (int(kernel[0][0]), int(kernel[0][1])) == first


def _digest_kernel_equals_plain(specs) -> None:
    from torchsnapshot_tpu_torch.ops import device_digest as dd

    kernel = dd.materialize_many(dd.digest_many_async(specs))
    plain = dd.materialize_many(dd.digest_many_plain(specs))
    assert kernel.shape == plain.shape and (kernel == plain).all()


@pytest.mark.cuda_only
def test_digest_kernel_on_the_train_state_table() -> None:
    """The chunk table an incremental take digests for the d_model-1024
    transformer's train state (171 rows: 16, 8, 6 and 2 MiB chunks and
    2 KiB vectors, sharing windows), against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torchsnapshot_tpu_torch.flatten import flatten
    from torchsnapshot_tpu_torch.incremental import IncrementalTakeContext
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, init_train_state

    cfg = TransformerConfig(
        vocab_size=32768, d_model=1024, n_heads=16, n_layers=8, d_ff=4096,
        dtype=torch.bfloat16, attn_impl="flash",
    )
    state = init_train_state(cfg, seed=3)
    _, flat = flatten(state.state_dict(), prefix="train")
    specs = IncrementalTakeContext(None, None, None, 0).collect(flat)[torch.device("cuda", 0)].specs
    assert sum(1 if r is None else len(r) for _, r in specs) == 171
    _digest_kernel_equals_plain(specs)


@pytest.mark.cuda_only
def test_digest_kernel_on_512_equal_rows() -> None:
    """512 bf16 segments of 1 MiB each: 32 windows, each shared by all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(4)
    t = torch.randn((512, 512 * 1024), generator=g, device="cuda").to(torch.bfloat16)
    _digest_kernel_equals_plain([(t, tuple((i, i + 1) for i in range(512)))])


@pytest.mark.cuda_only
def test_digest_kernel_rows_come_back_in_spec_order() -> None:
    """Specs smallest first (the kernel sorts them longest first): the rows
    follow the specs, each equal to the host digest of its bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torchsnapshot_tpu_torch.ops import device_digest as dd

    g = torch.Generator(device="cuda").manual_seed(5)
    specs = [
        (torch.randn(n, generator=g, device="cuda").to(dtype), None)
        for n, dtype in ((3, torch.float32), (1000, torch.bfloat16), (70_001, torch.bfloat16),
                         (70_003, torch.float32), (300_007, torch.bfloat16), (2_000_000, torch.float32))
    ]
    big = torch.randint(0, 255, (4097, 129), generator=g, device="cuda", dtype=torch.uint8)
    specs.append((big, ((4000, 4001), (100, 300), (0, 4097))))
    kernel = dd.materialize_many(dd.digest_many_async(specs))
    host = [dd.digest_host(t.cpu()) for t, r in specs if r is None]
    host += [dd.digest_host(big[a:b].cpu()) for a, b in specs[-1][1]]
    assert [(int(a), int(b)) for a, b in kernel] == host


@pytest.mark.cuda_only
def test_async_take_of_a_source_mutated_after_return(tmp_path) -> None:
    """The on-device clone is the consistency point: the live CUDA tensors
    are overwritten right after async_take returns (and freed), and the
    snapshot still restores the bytes of the call; an incremental take
    against it references the unchanged leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torchsnapshot_tpu_torch import Snapshot, TensorTreeState

    g = torch.Generator(device="cuda").manual_seed(2)
    w = torch.randn((16384, 1024), generator=g, device="cuda").to(torch.bfloat16)  # 2 chunks
    b = torch.randn(1024, generator=g, device="cuda")
    expected = {"w": w.cpu().clone(), "b": b.cpu().clone()}
    pending = Snapshot.async_take(
        str(tmp_path / "a"), {"s": TensorTreeState({"w": w, "b": b})}, record_digests=True
    )
    w.mul_(-3).add_(1)
    b.zero_()
    del w
    snapshot = pending.wait()
    fresh = {"w": torch.zeros((16384, 1024), dtype=torch.bfloat16, device="cuda"),
             "b": torch.zeros(1024, device="cuda")}
    snapshot.restore({"s": TensorTreeState(fresh)})
    for k in fresh:
        assert torch.equal(fresh[k].cpu().view(torch.uint8), expected[k].view(torch.uint8)), k
    Snapshot.take(
        str(tmp_path / "b"), {"s": TensorTreeState({"w": fresh["w"], "b": b})},
        incremental_base=str(tmp_path / "a"),
    )
    manifest = Snapshot(str(tmp_path / "b")).get_manifest()
    assert all(c.array.location.startswith("../") for c in manifest["0/s/w"].chunks)
    assert not manifest["0/s/b"].location.startswith("../")


def _pack_cases():
    """(label, specs) of the pack kernel's checks on the card."""
    g = torch.Generator(device="cuda").manual_seed(5)
    dtypes = [torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int64,
              torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool, torch.float8_e4m3fn]

    def make(shape, dtype):
        if dtype == torch.bool:
            return torch.rand(shape, generator=g, device="cuda") > 0.5
        if dtype.is_floating_point:
            return (10 * torch.randn(shape, generator=g, device="cuda")).to(dtype)
        return torch.randint(-100, 100, shape, generator=g, device="cuda").to(dtype)

    big = make((1031, 77), torch.uint8)
    tile = 16 * 1024  # ops.device_pack.TILE_BYTES
    fill = [(make((tile - 3,), torch.uint8), None), (make((3,), torch.uint8), None)]
    return [
        ("dtypes", [(make((33, 7), d), None) for d in dtypes]),
        ("row-slices", [(big, (0, 1)), (big, (3, 517)), (make((64, 9), torch.float32), (5, 60))]),
        ("odd-and-empty", [(make((1,), torch.uint8), None), (make((0,), torch.float32), None),
                           (make((3, 5), torch.bfloat16), None), (make((17,), torch.int8), None)]),
        ("non-contiguous", [(make((64, 33), torch.float32)[:, 1::2], None), (big, None)]),
        ("one", [(make((4096,), torch.float32), None)]),
        ("many", [(make((1024,), torch.float32), None) for _ in range(10_000)]),
        # Every member after the first at an odd distance from its slab
        # offset's alignment, and row ranges at odd rows of odd-width rows.
        ("odd-distances", [(make((n,), d), None) for n, d in zip(
            (1, 3, 17, 4093, 255, 16, 31, 1000, 7, 2049),
            (torch.uint8, torch.bool, torch.bfloat16, torch.uint8, torch.int8, torch.float32,
             torch.bfloat16, torch.bool, torch.uint8, torch.float16))]
         + [(big, (5, 333)), (big, (333, 1030))]),
        # One member longer than several tiles, at an odd distance.
        ("long-member", [(make((3,), torch.uint8), None), (make((5 * tile + 7,), torch.uint8), None),
                         (make((9,), torch.bool), None)]),
        # Members of zero bytes on a tile boundary, then a tile of members.
        ("empty-on-tile-boundary", fill + [(make((0,), torch.float32), None), (make((0, 4), torch.bfloat16), None)]
         + [(make((1024,), torch.float32), None) for _ in range(5)]),
        ("many-4093", [(make((4093,), torch.uint8), None) for _ in range(10_000)]),
    ]


PACK_CASES = [
    "dtypes", "row-slices", "odd-and-empty", "non-contiguous", "one", "many", "odd-distances",
    "long-member", "empty-on-tile-boundary", "many-4093",
]


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", PACK_CASES)
def test_cuda_pack_matches_plain_version(case) -> None:
    """The pack kernel bit for bit against ``pack_plain``, one launch per
    call; a non-contiguous member is copied first, and counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    specs = dict(_pack_cases())[case]
    before, copies = dp.launch_counts["device_pack"], dp.copy_counts["device_pack_contiguous"]
    packed = dp.pack_async(specs)
    plain = dp.pack_plain(specs)
    torch.cuda.synchronize()
    assert packed.dtype == torch.uint8 and packed.is_cuda
    assert torch.equal(packed, plain)
    assert dp.launch_counts["device_pack"] == before + 1
    assert dp.copy_counts["device_pack_contiguous"] == copies + (case == "non-contiguous")


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", PACK_CASES)
def test_cuda_pack_with_a_layout_matches_plain_version(case) -> None:
    """The batcher's launch: a ``PackLayout`` made once from the members'
    sizes and row offsets (a member that is not contiguous named for a
    copy), then a launch that reads only their addresses, bit for bit
    against ``pack_plain`` in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from torchsnapshot_tpu_torch.ops import device_pack as dp

    specs = dict(_pack_cases())[case]
    planned, _ = dp.PackLayout.from_specs(specs)
    copies = [i for i, (t, _) in enumerate(specs) if not t.is_contiguous()]
    layout = dp.PackLayout(planned.device, np.diff(planned.table[: planned.n + 1]), planned.src_offsets, copies)
    before = dp.launch_counts["device_pack"], dp.copy_counts["device_pack_contiguous"]
    packed = dp.pack_async(specs, layout=layout)
    plain = dp.pack_plain(specs)
    torch.cuda.synchronize()
    assert torch.equal(packed, plain)
    assert dp.launch_counts["device_pack"] == before[0] + 1
    assert dp.copy_counts["device_pack_contiguous"] == before[1] + len(copies)


# The backward kernel's cases: (b, s, h, q/k/v as slices of one fused
# projection). The cells' shapes (Pythia-160M and -410M micro-batches), one
# 64-row tile, sequences of 64 but not 128 (a half tile), and the model's
# strided slices.
BWD_CASES = {
    "pythia-160m": (8, 2048, 12, True),
    "pythia-410m": (4, 2048, 16, True),
    "one-tile-64": (2, 64, 4, False),
    "half-tile-192": (2, 192, 4, False),
    "half-tile-320": (1, 320, 2, False),
    "qkv-slices-256": (2, 256, 4, True),
}


def _bwd_inputs(case: str, seed: int = 0):
    """bf16 q, k, v (the fused layout's slices where the case says so) and
    an upstream gradient, on the card."""
    b, s, h, fused_qkv = BWD_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused_qkv:
        q, k, v = torch.randn((b, s, 3, h, 64), generator=g, device="cuda").to(torch.bfloat16).unbind(2)
    else:
        q, k, v = (torch.randn((b, s, h, 64), generator=g, device="cuda").to(torch.bfloat16) for _ in "qkv")
    return q, k, v, torch.randn((b, s, h, 64), generator=g, device="cuda").to(torch.bfloat16)


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_bwd_kernel_matches_plain_version(case) -> None:
    """dQ, dK, dV of the backward kernel against flash_bwd_blockwise on the
    same bf16 inputs upcast to f32: the kernel's f32 sums within GRAD_TOL of
    each gradient's largest magnitude, its bf16 outputs those sums rounded
    (``fa.compare_bwd_with_plain``; the reasoning beside ``fa.GRAD_TOL``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    before = dict(fa.launch_counts)
    errs = fa.compare_bwd_with_plain(*_bwd_inputs(case))
    assert sorted(errs) == ["dk", "dq", "dv"]
    assert fa.launch_counts["flash_bwd"] == before["flash_bwd"] + 2
    assert fa.launch_counts["flash_chunk"] == before["flash_chunk"] + 1


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", ["pythia-160m", "half-tile-192", "qkv-slices-256"])
def test_bwd_kernel_is_deterministic(case) -> None:
    """Two calls on the same inputs give the same bits (no atomics, a fixed
    summation order), in bf16 and in f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, do = _bwd_inputs(case, seed=1)
    o_u, m, l = fa.flash_attention_chunk(q, k, v, True, 64, 64)
    o = o_u / l[..., None]
    for out_dtype in (torch.bfloat16, torch.float32):
        first = fa.flash_bwd(q, k, v, m, l, o, do, out_dtype)
        second = fa.flash_bwd(q, k, v, m, l, o, do, out_dtype)
        for a, b in zip(first, second):
            assert a.dtype == out_dtype and a.is_contiguous()
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", ["qkv-slices-256", "pythia-160m"])
def test_bwd_autograd_matches_the_dense_op(case) -> None:
    """flash_causal_attention(...).backward(g) on bf16 inputs takes the
    kernel, and its gradients match the dense causal_attention's on f32
    copies of the same inputs: within one bf16 rounding (2^-8 of the value
    covers half an ulp with room) plus GRAD_TOL of the largest gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torchsnapshot_tpu_torch.ops import causal_attention

    q, k, v, g = _bwd_inputs(case, seed=2)
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    before = dict(fa.backward_paths)
    fa.flash_causal_attention(q, k, v).backward(g)
    causal_attention(*ref).backward(g.float())
    assert fa.backward_paths == {"kernel": before["kernel"] + 1, "plain": before["plain"]}
    for got, want in zip((q, k, v), ref):
        assert got.grad.dtype == torch.bfloat16
        torch.testing.assert_close(
            got.grad.float(), want.grad, rtol=2.0**-8, atol=fa.GRAD_TOL * want.grad.abs().max().item()
        )


# ts_short_conv's cases (b, s, d): the LFM2-8B-A1B cell's call, LFM2's width
# at a short sequence, a sequence that ends inside both kernels' tiles at a
# width of 17 loads a row, and a width under one block's 128 loads with a
# sequence of one.
SHORT_CONV_CASES = {
    "lfm2-cell": (4, 4096, 2048), "lfm2-2048": (2, 512, 2048), "ragged-300": (3, 300, 136), "narrow-1": (2, 1, 64),
}


def _short_conv_inputs(case: str):
    b, s, d = SHORT_CONV_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(s)
    p = torch.randn((b, s, 3 * d), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((3, d), generator=g, device="cuda") / 3**0.5).to(torch.bfloat16)
    dy = torch.randn((b, s, d), generator=g, device="cuda").to(torch.bfloat16)
    return p, w, dy


def _within_bf16_rounding(got: torch.Tensor, want: torch.Tensor) -> bool:
    """A bf16 result against the f32 value it rounds: at most 2^-8 of it (a
    rounding is 2^-9; f32 sums in another order add ~1e-7), plus 1e-6."""
    return bool(((got.float() - want).abs() <= 2**-8 * want.abs() + 1e-6).all())


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", sorted(SHORT_CONV_CASES))
def test_short_conv_kernels_match_plain_versions(case) -> None:
    """The forward and the backward kernels against the plain versions in
    f32 on the same bf16 inputs: y and dP element by element within bf16's
    rounding, the f32 tap gradient (sums over b x s positions in another
    order) within 1e-4 of its largest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torchsnapshot_tpu_torch.ops import short_conv as sc

    p, w, dy = _short_conv_inputs(case)
    before = dict(sc.launch_counts)
    y = sc.short_conv_fwd(p, w)
    dp, dw = sc.short_conv_bwd(p, w, dy)
    assert sc.launch_counts["short_conv_fwd"] == before["short_conv_fwd"] + 1
    assert sc.launch_counts["short_conv_bwd"] == before["short_conv_bwd"] + 1
    want_y = sc.short_conv_plain(p.float(), w.float())
    want_dp, want_dw = sc.short_conv_bwd_plain(p.float(), w.float(), dy.float())
    assert y.dtype == dp.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert _within_bf16_rounding(y, want_y)
    assert _within_bf16_rounding(dp, want_dp)
    assert (dw - want_dw).abs().max() <= 1e-4 * want_dw.abs().max()


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", sorted(SHORT_CONV_CASES))
def test_short_conv_kernels_are_bitwise_repeatable(case) -> None:
    """Two calls give the same bits: the tap gradient's partials are
    reduced over tiles in a fixed order, with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torchsnapshot_tpu_torch.ops import short_conv as sc

    p, w, dy = _short_conv_inputs(case)
    first = (sc.short_conv_fwd(p, w), *sc.short_conv_bwd(p, w, dy))
    second = (sc.short_conv_fwd(p, w), *sc.short_conv_bwd(p, w, dy))
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda_only
def test_short_conv_autograd_runs_the_kernels() -> None:
    """``gated_short_conv`` on bf16 card tensors: the forward kernel, then
    on backward the backward kernel's dP and its tap gradient rounded to
    the weight's dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torchsnapshot_tpu_torch.ops import short_conv as sc

    p, w, dy = _short_conv_inputs("lfm2-2048")
    before = dict(sc.launch_counts)
    pl, wl = p.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = sc.gated_short_conv(pl, wl)
    got_dp, got_dw = torch.autograd.grad(y, (pl, wl), dy)
    want_dp, want_dw = sc.short_conv_bwd(p, w, dy)
    assert torch.equal(y, sc.short_conv_fwd(p, w))
    assert torch.equal(got_dp, want_dp) and torch.equal(got_dw, want_dw.to(torch.bfloat16))
    assert sc.launch_counts["short_conv_fwd"] == before["short_conv_fwd"] + 2
    assert sc.launch_counts["short_conv_bwd"] == before["short_conv_bwd"] + 2


@pytest.mark.cuda_only
@pytest.mark.parametrize("layout", ["strided", "width-not-a-multiple-of-8"])
def test_short_conv_refuses_a_bf16_card_input_it_does_not_take(layout) -> None:
    """A bf16 card input routes to the kernels, whose entries raise on a
    layout they do not take: ``gated_short_conv`` never falls back to the
    plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torchsnapshot_tpu_torch.ops import short_conv as sc

    d = 64 if layout == "strided" else 60
    g = torch.Generator(device="cuda").manual_seed(d)
    wide = torch.randn((2, 16, 6 * d), generator=g, device="cuda").to(torch.bfloat16)
    p = wide[..., : 3 * d] if layout == "strided" else wide[..., : 3 * d].contiguous()
    w = torch.randn((3, d), generator=g, device="cuda").to(torch.bfloat16)
    before = dict(sc.launch_counts)
    with pytest.raises(ValueError, match="ts_short_conv_fwd takes"):
        sc.gated_short_conv(p, w)
    assert sc.launch_counts == before


# ts_cross_entropy's cases (rows, V): a small call with a row of 8 logits'
# loads short of the block's 256, and the training steps' calls (Pythia-160M,
# Pythia-410M, LFM2-8B-A1B).
CROSS_ENTROPY_CASES = {
    "small-200": (200, 1000), "pythia-160m": (16376, 50304), "pythia-410m": (8188, 50304),
    "lfm2-8b-a1b": (16380, 65536),
}


def _cross_entropy_inputs(case: str):
    rows, vocab = CROSS_ENTROPY_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(rows)
    x = (2 * torch.randn((rows, vocab), generator=g, device="cuda")).to(torch.bfloat16)
    t = torch.randint(0, vocab, (rows,), generator=g, device="cuda")
    return x, t


@pytest.mark.cuda_only
@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("case", sorted(CROSS_ENTROPY_CASES))
def test_cross_entropy_kernels_match_plain_version(case, reduction) -> None:
    """The forward and backward kernels against the plain version in f32 on
    the same bf16 logits, with an incoming gradient of 0.75: the loss and
    each row's log-sum-exp within 1e-5 relative (f32 sums in another
    order, exp2 by the special-function unit), the gradient element by
    element within one bf16 rounding of the f32 value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torchsnapshot_tpu_torch.ops import cross_entropy as ce

    x, t = _cross_entropy_inputs(case)
    upstream = torch.tensor(0.75, device="cuda")
    before = dict(ce.launch_counts)
    loss, lse = ce.cross_entropy_fwd(x, t, reduction)
    grad = ce.cross_entropy_bwd(x, t, lse, upstream, reduction)
    assert ce.launch_counts["cross_entropy_fwd"] == before["cross_entropy_fwd"] + 1
    assert ce.launch_counts["cross_entropy_bwd"] == before["cross_entropy_bwd"] + 1
    xf = x.float().requires_grad_(True)
    want = ce.cross_entropy_plain(xf, t, reduction)
    want.backward(upstream)
    assert loss.dtype == lse.dtype == torch.float32 and grad.dtype == torch.bfloat16
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    want_lse = xf.detach().logsumexp(-1)
    assert ((lse - want_lse).abs() <= 1e-5 * want_lse.abs()).all()
    assert ((grad.float() - xf.grad).abs() <= 2**-8 * xf.grad.abs() + 1e-12).all()


@pytest.mark.cuda_only
@pytest.mark.parametrize("case", sorted(CROSS_ENTROPY_CASES))
def test_cross_entropy_kernels_are_bitwise_repeatable(case) -> None:
    """Two calls give the same bits: the rows' losses are reduced in a fixed
    order, with no atomics, and the backward is elementwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torchsnapshot_tpu_torch.ops import cross_entropy as ce

    x, t = _cross_entropy_inputs(case)
    upstream = torch.tensor(1.0, device="cuda")
    first = ce.cross_entropy_fwd(x, t)
    second = ce.cross_entropy_fwd(x, t)
    grads = [ce.cross_entropy_bwd(x, t, lse, upstream) for _, lse in (first, second)]
    for a, b in zip((*first, grads[0]), (*second, grads[1])):
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.cuda_only
def test_cross_entropy_autograd_launches_each_kernel_once() -> None:
    """``cross_entropy`` on bf16 card logits: one forward launch, and on
    backward one backward launch whose gradient is the kernel's, bit for
    bit; the rows are counted under ``route="kernel"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torchsnapshot_tpu_torch import telemetry
    from torchsnapshot_tpu_torch.ops import cross_entropy as ce
    from torchsnapshot_tpu_torch.telemetry import names

    x, t = _cross_entropy_inputs("small-200")
    key = f'{names.LOSS_ROWS_TOTAL}{{route="kernel"}}'
    counted = telemetry.metrics().collect()["counters"].get(key, 0.0)
    before = dict(ce.launch_counts)
    xl = x.clone().requires_grad_(True)
    loss = ce.cross_entropy(xl, t, "sum")
    loss.backward()
    assert ce.launch_counts["cross_entropy_fwd"] == before["cross_entropy_fwd"] + 1
    assert ce.launch_counts["cross_entropy_bwd"] == before["cross_entropy_bwd"] + 1
    want_loss, lse = ce.cross_entropy_fwd(x, t, "sum")
    want_grad = ce.cross_entropy_bwd(x, t, lse, torch.ones((), device="cuda"), "sum")
    assert torch.equal(loss.detach(), want_loss) and torch.equal(xl.grad, want_grad)
    assert telemetry.metrics().collect()["counters"][key] - counted == x.shape[0]


@pytest.mark.cuda_only
@pytest.mark.parametrize("layout", ["strided", "vocab-not-a-multiple-of-8"])
def test_cross_entropy_refuses_a_layout_it_does_not_take(layout) -> None:
    """bf16 card logits route to the kernels, whose entry raises on a layout
    they do not take: ``cross_entropy`` never falls back on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torchsnapshot_tpu_torch.ops import cross_entropy as ce

    vocab = 64 if layout == "strided" else 60
    wide = torch.randn((4, 2 * vocab), device="cuda").to(torch.bfloat16)
    x = wide[:, :vocab] if layout == "strided" else wide[:, :vocab].contiguous()
    before = dict(ce.launch_counts)
    with pytest.raises(ValueError, match="ts_cross_entropy_fwd takes"):
        ce.cross_entropy(x, torch.zeros(4, dtype=torch.int64, device="cuda"))
    assert ce.launch_counts == before


_OUT_OF_RANGE = """
import torch
from torchsnapshot_tpu_torch.ops import cross_entropy as ce
x = torch.zeros((4, 64), dtype=torch.bfloat16, device="cuda")
ce.cross_entropy(x, torch.tensor([0, 1, {target}, 2], device="cuda"))
torch.cuda.synchronize()
print("finished")
"""


@pytest.mark.cuda_only
@pytest.mark.parametrize("target", [64, -1])
def test_cross_entropy_target_out_of_range_trips_the_device_assert(target) -> None:
    """A target outside [0, V) trips the forward kernel's device-side assert,
    as ``F.cross_entropy``'s does; the context is lost, so it runs in a
    process of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import os
    import subprocess
    import sys

    from torchsnapshot_tpu_torch.ops import kernels

    kernels.build(["cross_entropy"])  # the child finds the library built
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _OUT_OF_RANGE.format(target=target)], cwd=repo, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0 and "finished" not in out.stdout
    assert "device-side assert" in out.stderr or "Assertion" in out.stderr + out.stdout, out.stderr[-2000:]
