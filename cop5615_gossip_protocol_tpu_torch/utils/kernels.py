"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` into a
shared library with a plain C interface under ``build/torch_kernels/`` at
the checkout's root, named by a hash of its sources and flags so an edited
source is rebuilt, and loaded with ctypes. There is no fallback: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# One shared library per CUDA source.
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

# No fast math: -fmad=false keeps a * b + c from contracting into an FMA,
# and denormals stay (no -ftz), so float32 results round as the JAX
# engines' do. ptxas -v writes register and spill counts to the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use and need "
        "the CUDA toolkit (nvcc on PATH, CUDA_HOME, or /usr/local/cuda)"
    )


def _sources(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build_id() -> str:
    """The identity of this checkout's kernel build: a hash of every
    source under csrc/ and the nvcc flags (what ``library_path`` names each
    library by). An engine that holds built kernels is keyed by it
    (serving/keys.py)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def build(name: str) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the
    library path and the seconds spent compiling (0.0 when cached)."""
    lib = library_path(name)
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))


def entry(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` (built on first
    use), typed with ``argtypes`` and returning its cudaError_t as int."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
