"""The port stands alone: torchsnapshot_tpu_torch and chip_smoke.py import
neither jax (nor flax or orbax) nor anything of torchsnapshot_tpu, and the
builders run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from torchsnapshot_tpu_torch.models import transformer as tt
from torchsnapshot_tpu_torch.ops import flash_attention as fa
from torchsnapshot_tpu_torch.ops import kernels

# One intra-op thread: the suite runs this file beside others in parallel
# workers, and torch's default of a thread per core would starve them (and
# their timing-sensitive tests).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "torchsnapshot_tpu_torch")


def _port_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    for script in ("chip_smoke.py", "chip_paired.py", "chip_pack_probe.py"):
        yield os.path.join(REPO, script)


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "flax", "orbax", "torchsnapshot_tpu")


def test_no_jax_or_reference_import_in_sources() -> None:
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_import_loads_no_jax() -> None:
    """Importing every module of the port adds no jax and no
    torchsnapshot_tpu module to the interpreter (measured against what the
    interpreter held before, in case site customization imports jax)."""
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_sources()
        if p.startswith(PKG)
    )
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'flax', 'orbax', 'torchsnapshot_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(new))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr[-2000:]


def test_import_loads_no_cloud_client_library() -> None:
    """Importing every module of the port and ``chip_smoke.py`` loads none
    of the cloud plugins' client libraries (aiobotocore, botocore,
    google-auth, google-resumable-media, requests): the card's machine may
    lack them, and the plugins import them only when they are built."""
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_sources()
        if p.startswith(PKG)
    ) + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "roots = ('aiobotocore', 'botocore', 'google', 'requests')\n"
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in roots)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr[-2000:]


def _tiny_cfg() -> tt.TransformerConfig:
    return tt.TransformerConfig(
        vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64, dtype=torch.float32
    )


@pytest.mark.parametrize(
    "build",
    [
        lambda cfg, **kw: tt.Transformer(cfg, **kw),
        lambda cfg, **kw: tt.init_train_state(cfg, seed=0, **kw),
    ],
    ids=["Transformer", "init_train_state"],
)
def test_builders_need_cuda_unless_cpu_asked(build, monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(_tiny_cfg())
    built = build(_tiny_cfg(), device="cpu")
    model = built if isinstance(built, tt.Transformer) else built.model
    assert model.embed.device.type == "cpu"


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "q_shape,dtype,match",
    [
        ((1, 128, 2, 64), torch.float16, "float32 or bfloat16"),
        ((1, 128, 2, 32), torch.float32, "head dims"),
        ((1, 96, 2, 64), torch.float32, "divisible by 64"),
    ],
)
def test_kernel_wrappers_refuse_unsupported_inputs(q_shape, dtype, match) -> None:
    """Off the CPU a wrapper launches its kernel or raises; it never falls
    back to the plain version."""
    q = _meta(q_shape, dtype)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_chunk(q, q, q, causal=True, block_q=32, block_k=32)


def test_kernel_wrapper_raises_without_a_kernel_build(monkeypatch, tmp_path) -> None:
    """A well-formed non-CPU input goes to the CUDA kernel; with no nvcc
    that is an error, not a silent plain run."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_library_path", lambda name: str(tmp_path / "missing.so"))
    q = _meta((1, 128, 2, 64))
    before = dict(fa.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_causal_forward(q, q, q)
    assert fa.launch_counts == before


# The modules of the sharded-state slice, of the chunk-store and fan-out
# slice, of the telemetry slice, the bridge, the pipeline, ring attention
# and the cloud plugins: walked by the import checks above.
SHARDED_SLICE_MODULES = [
    "torchsnapshot_tpu_torch/parallel/overlap.py",
    "torchsnapshot_tpu_torch/resharding.py",
    "torchsnapshot_tpu_torch/sharded_io_preparer.py",
    "torchsnapshot_tpu_torch/batcher.py",
    "torchsnapshot_tpu_torch/ops/device_pack.py",
    # The chunk store and fan-out restore.
    "torchsnapshot_tpu_torch/cas/__init__.py",
    "torchsnapshot_tpu_torch/cas/store.py",
    "torchsnapshot_tpu_torch/cas/plugin.py",
    "torchsnapshot_tpu_torch/fanout.py",
    # Reports, sinks, heartbeats, history, the run ledger, goodput and
    # the trace export.
    "torchsnapshot_tpu_torch/telemetry/report.py",
    "torchsnapshot_tpu_torch/telemetry/sink.py",
    "torchsnapshot_tpu_torch/telemetry/progress.py",
    "torchsnapshot_tpu_torch/telemetry/history.py",
    "torchsnapshot_tpu_torch/telemetry/ledger.py",
    "torchsnapshot_tpu_torch/telemetry/goodput.py",
    "torchsnapshot_tpu_torch/telemetry/trace.py",
    # The migration bridge and the int8 codecs.
    "torchsnapshot_tpu_torch/lowp.py",
    "torchsnapshot_tpu_torch/tricks/__init__.py",
    "torchsnapshot_tpu_torch/tricks/torch.py",
    "torchsnapshot_tpu_torch/tricks/torchsnapshot_reader.py",
    "torchsnapshot_tpu_torch/tricks/torchsnapshot_writer.py",
    "torchsnapshot_tpu_torch/tricks/convert.py",
    "torchsnapshot_tpu_torch/utils/device.py",
    # The GPipe schedule.
    "torchsnapshot_tpu_torch/parallel/pipeline.py",
    # Ring attention and the cloud plugins.
    "torchsnapshot_tpu_torch/ops/ring_attention.py",
    "torchsnapshot_tpu_torch/storage_plugins/s3.py",
    "torchsnapshot_tpu_torch/storage_plugins/gcs.py",
    # Interop with torch.distributed.checkpoint and the train-state adapter.
    "torchsnapshot_tpu_torch/tricks/dcp.py",
    "torchsnapshot_tpu_torch/tricks/train_state.py",
]


@pytest.mark.parametrize("module", SHARDED_SLICE_MODULES)
def test_sharded_slice_modules_are_checked(module) -> None:
    assert os.path.join(REPO, module) in set(_port_sources())
    assert os.path.exists(os.path.join(PKG, "csrc", "device_pack.cu"))


def test_pack_wrapper_refuses_other_devices() -> None:
    """Off the CPU the pack wrapper launches its kernel or raises: a
    device it has no kernel for is refused, never packed by the plain
    version."""
    from torchsnapshot_tpu_torch.ops import device_pack as dp

    t = _meta((4, 4))
    before = dp.launch_counts["device_pack"]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dp.pack_async([(t, None), (t, None)])
    assert dp.launch_counts["device_pack"] == before
