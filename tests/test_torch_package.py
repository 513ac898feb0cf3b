"""The port stands alone: torchsnapshot_tpu_torch and chip_smoke.py import
neither jax nor anything of torchsnapshot_tpu, and the builders run on the
card unless the caller asks for the CPU."""

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
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    return (
        module == "jax"
        or module.startswith("jax.")
        or module == "torchsnapshot_tpu"
        or module.startswith("torchsnapshot_tpu.")
    )


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
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.') "
        "or m == 'torchsnapshot_tpu' or m.startswith('torchsnapshot_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(new))\n"
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
