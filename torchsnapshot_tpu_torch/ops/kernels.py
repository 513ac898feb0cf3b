"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into a shared library at first use, then loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds, not
minutes). Libraries are named by a hash of their source and flags, so an
edited source rebuilds; they land in ``csrc/build/`` (ignored by git) or,
when the package directory is read-only, in a per-user temp directory.

Nothing here runs at import time: the CPU-only test environment imports
every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> the compiler's register / shared-memory / spill report
build_logs: Dict[str, str] = {}


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of torchsnapshot_tpu_torch build at first use and need the "
        "CUDA toolkit"
    )


def _library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    fname = f"lib{name}_{tag}.so"
    for d in (
        os.path.join(CSRC_DIR, "build"),
        os.path.join(tempfile.gettempdir(), f"torchsnapshot_tpu_torch_{os.getuid()}"),
    ):
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            continue
        if os.access(d, os.W_OK) or os.path.exists(os.path.join(d, fname)):
            return os.path.join(d, fname)
    raise RuntimeError("no writable directory for the kernel build")


def build(names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile every named kernel source that has no up-to-date library,
    one ``nvcc`` per source, all started together. Returns each built
    library's compile seconds (absent when it was already built); raises
    with the compiler's output when a build fails."""
    names = list(names) if names is not None else kernel_names()
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.monotonic(),
        )
    seconds: Dict[str, float] = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log[-4000:]}")
            continue
        os.replace(tmp, out)  # atomic: a racing process sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = _library_path(name)
            if not os.path.exists(path):
                build([name])
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]
