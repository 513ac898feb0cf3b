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
