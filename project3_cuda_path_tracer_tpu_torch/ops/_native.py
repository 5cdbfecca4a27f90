"""Build and bind the CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

The library is built at first use from the package's own sources
(csrc/*.cu) into `project3_cuda_path_tracer_tpu_torch/_build/`, under a
name keyed by a hash of the sources and the flags, so an edited source
builds anew and an unchanged one is reused. A failed build raises with
nvcc's stderr; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "full_iteration.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


@dataclass(frozen=True)
class NativeLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # nvcc wall time; 0.0 when an earlier build was reused


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels are built from source at first use and need the CUDA toolkit"
    )


def _library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"pt_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> tuple[Path, float]:
    """Compile the sources unless this exact build exists (or `force`).
    Returns the library path and the nvcc wall time (0.0 if reused)."""
    out = _library_path()
    if out.exists() and not force:
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out, seconds


@functools.lru_cache(maxsize=None)
def load() -> NativeLibrary:
    """Build if needed, load, and declare the C signatures."""
    path, seconds = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.pt_full_iteration
    fn.argtypes = [p, p, p, p, p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return NativeLibrary(lib=lib, path=path, build_seconds=seconds)
