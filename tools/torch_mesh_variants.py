"""Time variants of #7 (`mesh_candidates`, csrc/mesh.cu) and B
(`place_entries`, csrc/sorted.cu) at each depth of their paths on one
NVIDIA GPU, to find where their time goes.

    python tools/torch_mesh_variants.py [--out FILE]

Each variant is its source with named lines replaced (each replaced line
must be found, or the tool stops), built with the port's own nvcc flags
into `_build/variants/`. The inputs are made by the port's kernels from
the camera pool of iteration 2 and one bounce per depth (800x800, depth
8, AA): #7's rays and alive lanes at every depth of mesh.txt (path (j)),
and A's keys at every depth of mesh_big.txt (path (n)). For each variant
and depth, its kernel runs 10 times under torch.profiler, routed to the
variant's library, and its mean device ms per launch is printed with
whether its output is bit for bit the committed kernel's (#7: the
analytic lanes and flags of the live lanes, the list as a set; B: the
stream per key and the total). "no_append_7" writes the list at wrong
places on purpose (its time is what the list's atomics cost) and is not
compared. Also per depth: #7's live lanes and the warps of 32 lanes that
hold one, B's listed lanes and entries. Prints one JSON line per variant
and the card's name and power limit; writes them to FILE when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEPTH = 8
# name -> (source, [(line in it, its replacement)])
VARIANTS = {
    "committed_7": ("mesh.cu", []),
    # a thread per lane in place: no packing of the live lanes
    "unpacked_7": ("mesh.cu", [
        ("    const bool sweep = i < end && (live || all_lanes);",
         "    const bool sweep = i < end;"),
        ("    const bool live = (packed & kLiveBit) != 0;\n",
         "    const bool live = (packed & kLiveBit) != 0;\n"
         "    if (!live && !all_lanes) continue;\n")]),
    "pack1_7": ("mesh.cu", [("constexpr int kCandPer = 2;", "constexpr int kCandPer = 1;")]),
    "pack4_7": ("mesh.cu", [("constexpr int kCandPer = 2;", "constexpr int kCandPer = 4;")]),
    "pack8_7": ("mesh.cu", [("constexpr int kCandPer = 2;", "constexpr int kCandPer = 8;")]),
    "no_append_7": ("mesh.cu", [("s_base = atomicAdd(count, n_cands);", "s_base = 0;")]),
    # the analytic geoms' ids listed once per block in shared memory, so
    # that the sweep loop meets no mesh geom
    "geom_list_7": ("mesh.cu", [
        ("__device__ __forceinline__ Hit intersect_analytic(",
         "__shared__ int s_analytic[1024];\n__shared__ int s_n_analytic;\n"
         "__device__ __forceinline__ Hit intersect_analytic("),
        ("  for (int g = 0; g < s.n_geoms; ++g) {\n    if (__ldg(s.gtype + g) == kMesh) continue;\n",
         "  for (int k = 0; k < s_n_analytic; ++k) {\n    const int g = s_analytic[k];\n"),
        ("  if (first >= end) return;  // the whole block\n",
         "  if (first >= end) return;  // the whole block\n"
         "  if (threadIdx.x < 32) {\n"
         "    int listed = 0;\n"
         "    for (int g0 = 0; g0 < s.n_geoms; g0 += 32) {\n"
         "      const int g = g0 + threadIdx.x;\n"
         "      const bool analytic = g < s.n_geoms && __ldg(s.gtype + g) != kMesh;\n"
         "      const unsigned ballot = __ballot_sync(0xffffffffu, analytic);\n"
         "      if (analytic) s_analytic[listed + __popc(ballot & ((1u << threadIdx.x) - 1u))] = g;\n"
         "      listed += __popc(ballot);\n"
         "    }\n"
         "    if (threadIdx.x == 0) s_n_analytic = listed;\n"
         "  }\n")]),
    "threads64_7": ("mesh.cu", [("constexpr int kCandThreads = 128;",
                                 "constexpr int kCandThreads = 64;")]),
    "threads64_pack4_7": ("mesh.cu", [
        ("constexpr int kCandThreads = 128;", "constexpr int kCandThreads = 64;"),
        ("constexpr int kCandPer = 2;", "constexpr int kCandPer = 4;")]),
    "threads256_pack1_7": ("mesh.cu", [
        ("constexpr int kCandThreads = 128;", "constexpr int kCandThreads = 256;"),
        ("constexpr int kCandPer = 2;", "constexpr int kCandPer = 1;")]),
    "committed_b": ("sorted.cu", []),
    "per6_b": ("sorted.cu", [("constexpr int kPlacePer = 8;", "constexpr int kPlacePer = 6;")]),
    "per16_b": ("sorted.cu", [("constexpr int kPlacePer = 8;",
                               "constexpr int kPlacePer = 16;")]),
    "threads128_b": ("sorted.cu", [("constexpr int kPlaceThreads = 256;",
                                    "constexpr int kPlaceThreads = 128;")]),
    # registers capped for 4 resident blocks of 256 threads an SM
    "min4blocks_b": ("sorted.cu", [(
        "__global__ void __launch_bounds__(kPlaceThreads)\n    place_entries_kernel",
        "__global__ void __launch_bounds__(kPlaceThreads, 4)\n    place_entries_kernel")]),
    # each entry stored at its place from its thread, not staged in runs
    "scatter_b": ("sorted.cu", [
        ("""          s_key[p] = key[i];
          s_id[p] = slot * n + j0 + k * kPlaceThreads;""",
         """          out_key[s_base[key[i]] + p] = key[i];
          out_entry[s_base[key[i]] + p] = slot * n + j0 + k * kPlaceThreads;"""),
        ("    for (int p = threadIdx.x; p < in_tile; p += kPlaceThreads) {",
         "    for (int p = threadIdx.x; p < 0 * in_tile; p += kPlaceThreads) {")]),
}
WRONG = ("no_append_7",)
KERNEL = {"mesh.cu": ("pt_mesh_candidates", "mesh_candidates_kernel"),
          "sorted.cu": ("pt_place_entries", "place_entries_kernel")}


def build(out_dir: str) -> dict:
    """{variant: library path}, all built in parallel."""
    from project3_cuda_path_tracer_tpu_torch.ops import _native

    os.makedirs(out_dir, exist_ok=True)
    procs, libs = [], {}
    for name, (src, subs) in VARIANTS.items():
        text = (_native.CSRC / src).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in csrc/{src}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out_dir, f"{name}.so")
        procs.append(subprocess.Popen(
            [_native.find_nvcc(), *_native.NVCC_FLAGS, "-I", str(_native.CSRC), "-o",
             libs[name], cu], stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {err[-2000:]}")
    return libs


def inputs(dev):
    """Per depth of iteration 2 (800x800 AA): mesh.txt's (scene, tables,
    rays, alive) for #7, and mesh_big.txt's (A's keys, #7's count) for B."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.models.scene import load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
    from project3_cuda_path_tracer_tpu_torch.render import (
        Renderer,
        RenderSettings,
        _camera_pool,
    )

    settings = RenderSettings(trace_depth=DEPTH, antialias=True)
    out = {}
    for name in ("mesh.txt", "mesh_big.txt"):
        r = Renderer(load_scene(os.path.join(ROOT, "scenes", name)), settings, device=dev)
        ds, tables = r.dev_scene, r.tables
        pool = _camera_pool(r.dev_camera, 2, settings)
        rows = []
        for d in range(DEPTH):
            o, dirs, alive = pool[0], pool[1], pool[4]
            if name == "mesh.txt":
                # the pool is bounced in place: keep this depth's lanes
                rows.append((Vec3(*(c.clone() for c in o)), Vec3(*(c.clone() for c in dirs)),
                             alive.clone()))
            else:
                cands = pl.mesh_candidates(o, dirs, alive, ds, tables=tables)
                hits = pl.mesh_sweep(o, dirs, cands, ds, tables=tables)
                (g,) = pl.sorted_geoms(ds)
                sk = pl.super_keys(o, dirs, cands, hits, ds, g, tables=tables)
                rows.append((sk, cands.count.clone()))
            pool = pl.bounce_step_pipeline(pool, ds, 2, d, settings, tables=tables)
        torch.cuda.synchronize()
        out[name] = (ds, tables, rows)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from project3_cuda_path_tracer_tpu_torch.ops import _native
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl

    if not torch.cuda.is_available():
        print("torch_mesh_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi_line()
    libs = build(os.path.join(str(_native.BUILD_DIR), "variants"))
    data = inputs(dev)
    ds7, tables7, rows7 = data["mesh.txt"]
    _, _, rows_b = data["mesh_big.txt"]
    P = rows7[0][2].shape[0]

    def run7(row):
        o, d, alive = row
        return pl.mesh_candidates(o, d, alive, ds7, tables=tables7)

    def same7(got, want, alive):
        live = alive != 0
        lanes = lambda c: set(c.lanes[:int(c.count[0])].tolist())  # noqa: E731
        return (all(torch.equal(chip_smoke.bitwise(a[live]), chip_smoke.bitwise(b[live]))
                    for a, b in zip((got.t, *got.normal, got.material_id, got.cand),
                                    (want.t, *want.normal, want.material_id, want.cand)))
                and lanes(got) == lanes(want))

    def run_b(row):
        sk, count = row
        return pl.place_entries(sk, count)

    def same_b(got, want):
        m = int(want.total[0])
        pairs = lambda s: torch.sort(  # noqa: E731
            s.key[:m].long() * (1 << 32) + s.entry[:m].long()).values
        return int(got.total[0]) == m and torch.equal(pairs(got), pairs(want))

    want7 = [run7(row) for row in rows7]
    want_b = [run_b(row) for row in rows_b]
    torch.cuda.synchronize()
    work = {
        "lanes_in": [int((row[2] != 0).sum()) for row in rows7],
        "warps_with_live": [int((row[2] != 0).view(-1, 32).any(1).sum()) for row in rows7],
        "listed": [int(row[1][0]) for row in rows_b],
        "entries": [int(w.total[0]) for w in want_b]}
    committed = pl._launch
    rows = []
    for name, path in libs.items():
        src, _ = VARIANTS[name]
        entry, symbol = KERNEL[src]
        lib = ctypes.CDLL(path)
        getattr(lib, entry).argtypes = _native.SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int

        def launch(fn, what, *a, lib=lib, entry=entry):
            if fn != entry:
                return committed(fn, what, *a)
            if getattr(lib, fn)(*a) != 0:
                raise RuntimeError(f"{what}: launch failed")

        pl._launch = launch
        try:
            if src == "mesh.cu":
                exact = all(same7(run7(row), w, row[2]) for row, w in zip(rows7, want7))
                cases = [lambda row=row: run7(row) for row in rows7]
            else:
                exact = all(same_b(run_b(row), w) for row, w in zip(rows_b, want_b))
                cases = [lambda row=row: run_b(row) for row in rows_b]
            per_depth = []
            for fn in cases:
                for _ in range(2):  # a profile that recorded nothing is taken once more
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        for _ in range(10):
                            fn()
                        torch.cuda.synchronize()
                    ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and symbol in e.name]
                    if ms:
                        break
                else:
                    raise RuntimeError(f"{name}: the profiler saw no launch, twice")
                per_depth.append(sum(ms) / len(ms))
        finally:
            pl._launch = committed
        row = {"variant": name, "source": f"csrc/{src}", "replaced": VARIANTS[name][1],
               "path": "(j) mesh.txt" if src == "mesh.cu" else "(n) mesh_big.txt",
               "pool": P, "bit_for_bit": None if name in WRONG else exact,
               "ms_per_depth": per_depth, "ms_mean": sum(per_depth) / len(per_depth),
               "work_per_depth": {k: v for k, v in work.items()
                                  if (k in ("lanes_in", "warps_with_live")) == (src == "mesh.cu")},
               "device": smi}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if all(r["bit_for_bit"] for r in rows if r["variant"].startswith("committed")) else 1


if __name__ == "__main__":
    sys.exit(main())
