"""Build and bind the CUDA kernels: nvcc into shared libraries with a
plain C interface, loaded with ctypes.

Each source (csrc/*.cu) builds at first use into its own library under
`project3_cuda_path_tracer_tpu_torch/_build/`, one nvcc per source, all
started together. A library's name is keyed by a hash of every file
under csrc/ (the shared header included) and the flags, so an edited
source or header builds anew and an unchanged tree is reused. A failed
build raises with nvcc's stderr; nothing falls back to the plain version.
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
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "full_iteration.cu", CSRC / "bounce.cu", CSRC / "nee.cu",
           CSRC / "mesh.cu", CSRC / "sorted.cu", CSRC / "radix.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    # tables, n_geoms, cam, acc, iteration0, n_iters, resx, resy, depth,
    # rr_start, flags, counter, device, stream
    "pt_full_iteration": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                          _P],
    # tables, n_geoms, cam, pool, iteration, resx, resy, rr_start, flags,
    # device, stream
    "pt_first_bounce": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # tables, n_geoms, pool, num_alive, n, iteration, depth, rr_start,
    # flags, device, stream
    "pt_bounce_step": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # tables, n_geoms, pool_in, isect, pool_out, n, iteration, depth,
    # rr_start, flags, device, stream
    "pt_shade_step": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # tables, n_geoms, n_lights, aw, mesh, n_mesh, pool (14 lanes + 2
    # aux), n, iteration, depth, is_last, rr_start, flags, counter, device,
    # stream
    "pt_bounce_step_nee": [_P, _I, _I, _F, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                           _P, _I, _P],
    # tables, n_geoms, n_lights, aw, mesh, n_mesh, cam, acc, iteration0,
    # n_iters, resx, resy, depth, rr_start, flags, counter, device, stream
    "pt_full_iteration_nee": [_P, _I, _I, _F, _P, _I, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _P, _I, _P],
    # tables, n_geoms, mesh, n_mesh, rays, num_alive, n, all_lanes,
    # analytic, list, count, device, stream
    "pt_mesh_candidates": [_P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _P],
    # tables, n_geoms, mesh, n_mesh, wide, stack, walked, rays, t_a, list,
    # count, n, hits, next, device, stream
    "pt_mesh_sweep": [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                      _I, _P],
    # tables, n_geoms, pool, num_alive, n, analytic, hits, iteration,
    # depth, rr_start, flags, device, stream
    "pt_bounce_step_mesh": [_P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    # analytic, hits, n, out, device, stream
    "pt_intersect_mesh": [_P, _P, _I, _P, _I, _P],
    # tables, n_geoms, mesh, rays, t_a, t_m, list, count, n, geom,
    # super_start, n_supers, E, keys, q, bt0, hist, device, stream
    "pt_super_keys": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                      _P, _P, _P, _I, _P],
    # keys, count, n, E, n_supers, hist, cursor, out_key, out_entry, total,
    # device, stream
    "pt_place_entries": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    # mesh, sweep, key, entry, total, q, n, E, super_start, n_supers,
    # chunk_start, n_chunks, tri_start, tri_count, t, tri, u, v, device,
    # stream
    "pt_window_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _I, _P],
    # mesh, sweep, key, total, q, n, super_start, n_supers, chunk_start,
    # n_chunks, tri_start, tri_count, t, tri, u, v, device, stream
    "pt_window_sweep_stream": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _P, _P, _P, _P, _I, _P],
    # tables, n_geoms, mesh, rays, list, count, n, E, n_supers, geom,
    # has_uv, keys, t, tri, u, v, q, bt0, hits, device, stream
    "pt_merge_entries": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                         _P, _P, _P, _P, _P, _P, _I, _P],
    # key, count, hist, capacity, n, E, shift, width, dead, in, out,
    # n_words, key_out, entry_out, length_out, hist_out, tiles, status,
    # clear, clear_words, probe, device, stream
    "pt_radix_split": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P,
                       _P, _P, _P, _I, _P, _I, _P],
    # entry, length, capacity, in, out, n_words, device, stream
    "pt_radix_unscatter": [_P, _P, _I, _P, _P, _I, _I, _P],
}


@dataclass(frozen=True)
class NativeLibrary:
    libs: dict  # source stem -> ctypes.CDLL
    paths: tuple  # the libraries' paths
    build_seconds: float  # nvcc wall time of the parallel build; 0.0 if reused

    def fn(self, name: str):
        for lib in self.libs.values():
            if hasattr(lib, name):
                return getattr(lib, name)
        raise AttributeError(f"no CUDA entry point {name}")


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


def _tree_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(f.relative_to(CSRC).as_posix().encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_paths() -> tuple:
    key = _tree_hash()
    return tuple(BUILD_DIR / f"pt_{src.stem}_{key}.so" for src in SOURCES)


def build(force: bool = False) -> tuple[tuple, float]:
    """Compile every source whose library is missing (all of them with
    `force`), one nvcc process per source, run in parallel. Returns the
    library paths and the wall time of the build (0.0 if all reused)."""
    outs = library_paths()
    todo = [(src, out) for src, out in zip(SOURCES, outs)
            if force or not out.exists()]
    if not todo:
        return outs, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    failures = []
    for cmd, tmp, out, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{stderr}{stdout}"
            )
        else:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load() -> NativeLibrary:
    """Build if needed, load, and declare the C signatures."""
    paths, seconds = build()
    libs = {src.stem: ctypes.CDLL(str(p)) for src, p in zip(SOURCES, paths)}
    lib = NativeLibrary(libs=libs, paths=paths, build_seconds=seconds)
    for name, argtypes in SIGNATURES.items():
        fn = lib.fn(name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
