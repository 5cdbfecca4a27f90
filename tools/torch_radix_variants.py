"""Time variants of the radix route's kernels (csrc/radix.cu) on one
NVIDIA GPU, to find where their time goes.

    python tools/torch_radix_variants.py [--out FILE]

Each variant is csrc/radix.cu with named lines replaced (each replaced
line must be found, or the tool stops), built with the port's own nvcc
flags into `_build/variants/`. The inputs are mesh_big.txt's at 800x800,
depth 8, AA, iteration 2: A's keys at depth `--depth` (1 by default, the
route's longest stream), made by the port's kernels from the camera pool
and one bounce per depth before it. For each variant, the route's radix
launches (the compaction split, the 8-bit pass, the unscatter of C's
results) run 10 times under torch.profiler, routed to the variant's
library, and each kernel's mean device ms per launch is printed with
whether the variant's sorted stream (keys, rays, ids) and unscatter are
bit for bit the committed kernels'. "no_lookback" and "no_hist" compute
wrong places on purpose (their time is what the look-back and the
histograms cost) and are not compared. The committed unscatter is also replayed 10 times into
its own output (`chip_smoke.replay_ms`: warm in L2) beside its time in
the route (a fresh output each call). Prints one JSON line per variant and
the card's name and power limit; writes them to FILE when given.
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

# the write loops as first written: each load paired with its
# store, element by element (compaction, unscatter) and word by word (a
# pass's stage)
PAIRS = [
    ("""      for (int k = 0; k < w.n; ++k) {
        unsigned val[kKeys];
#pragma unroll
        for (int i = 0; i < kKeys; ++i) val[i] = at[i] < 0 ? 0u : __ldg(w.in[k] + src[i]);
#pragma unroll
        for (int i = 0; i < kKeys; ++i) {
          if (at[i] >= 0) w.out[k][s_base[0] + at[i]] = val[i];
        }
      }""", """#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        if (at[i] < 0) continue;
        for (int k = 0; k < w.n; ++k) w.out[k][s_base[0] + at[i]] = __ldg(w.in[k] + src[i]);
      }"""),
    ("""          if (at[i] >= 0) s_stage[at[i]] = val[i];""",
     """          if (at[i] >= 0) s_stage[at[i]] = __ldg(w.in[k] + src[i]);"""),
    ("""        if (k + 1 < w.n) {
#pragma unroll
          for (int i = 0; i < kKeys; ++i) val[i] = at[i] < 0 ? 0u : __ldg(w.in[k + 1] + src[i]);
        }
""", ""),
    ("""    unsigned val[kMaxWords];  // every load before the first store
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) val[k] = k < w.n ? __ldg(w.in[k] + i) : 0u;
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) {
      if (k < w.n) w.out[k][id] = val[k];
    }""", """    for (int k = 0; k < w.n; ++k) w.out[k][id] = __ldg(w.in[k] + i);"""),
]
# name -> [(line in csrc/radix.cu, its replacement)], RADIX_TILE's elements
# per thread
VARIANTS = {
    "committed": ([], 8),
    "keys4": ([("constexpr int kKeys = 8;", "constexpr int kKeys = 4;")], 4),
    "keys16": ([("constexpr int kKeys = 8;", "constexpr int kKeys = 16;")], 16),
    "window1": ([("constexpr int kWindow = 4;", "constexpr int kWindow = 1;")], 8),
    "window2": ([("constexpr int kWindow = 4;", "constexpr int kWindow = 2;")], 8),
    "window8": ([("constexpr int kWindow = 4;", "constexpr int kWindow = 8;")], 8),
    "window32": ([("constexpr int kWindow = 4;", "constexpr int kWindow = 32;")], 8),
    "backoff": ([("    spins += used == 0;",
                  "    spins += used == 0;\n    if (used == 0) __nanosleep(100);")], 8),
    "load_store_pairs": (PAIRS, 8),
    "no_lookback": ([("earlier = look_back(work.status + d, R, tile, work.probe);",
                      "earlier = 0;")], 8),
    "no_hist": ([("atomicAdd(&s_hist[p][(key[i] >> (kMaxWidth * p)) & ((1 << bits) - 1)], 1);",
                  "(void)bits;")], 8),
}
WRONG = ("no_lookback", "no_hist")  # places wrong on purpose: no comparison
KERNELS = {"compaction": "radix_split_kernel<true>", "pass": "radix_split_kernel<false>",
           "unscatter": "radix_unscatter_kernel"}


def build(out_dir: str) -> dict:
    """{variant: library path}, all built in parallel."""
    from project3_cuda_path_tracer_tpu_torch.ops import _native

    src = (_native.CSRC / "radix.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    procs, libs = [], {}
    for name, (subs, _) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in csrc/radix.cu")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"radix_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out_dir, f"radix_{name}.so")
        procs.append(subprocess.Popen([_native.find_nvcc(), *_native.NVCC_FLAGS, "-o",
                                       libs[name], cu], stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {err[-2000:]}")
    return libs


def inputs(dev, depth):
    """(device scene, tables, geom, candidates, A's keys) of mesh_big
    800x800 AA at `depth` of iteration 2."""
    from project3_cuda_path_tracer_tpu_torch.models.scene import load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.render import (
        Renderer,
        RenderSettings,
        _camera_pool,
    )

    settings = RenderSettings(trace_depth=8, antialias=True)
    r = Renderer(load_scene(os.path.join(ROOT, "scenes", "mesh_big.txt")), settings,
                 device=dev)
    ds, tables = r.dev_scene, r.tables
    (g,) = pl.sorted_geoms(ds)
    pool = _camera_pool(r.dev_camera, 2, settings)
    for d in range(depth + 1):
        o, dirs, alive = pool[0], pool[1], pool[4]
        cands = pl.mesh_candidates(o, dirs, alive, ds, tables=tables)
        hits = pl.mesh_sweep(o, dirs, cands, ds, tables=tables)
        sk = pl.super_keys(o, dirs, cands, hits, ds, g, tables=tables)
        if d < depth:
            pool = pl.bounce_step_pipeline(pool, ds, 2, d, settings, tables=tables)
    return ds, tables, g, cands, sk


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from project3_cuda_path_tracer_tpu_torch.ops import _native
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl

    if not torch.cuda.is_available():
        print("torch_radix_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi_line()
    libs = build(os.path.join(str(_native.BUILD_DIR), "variants"))
    ds, tables, g, cands, sk = inputs(dev, args.depth)
    E, P = sk.keys.shape
    dead = sk.hist.shape[0]
    bits = pl.radix_key_bits(dead)
    committed = pl._launch

    def route():
        work = pl.radix_work(E * P, bits, dev)
        stream = pl.radix_split(pl.RadixSplit(sk.keys, cands.count, -1, dead), sk.rays,
                                work=work)
        srt = pl.radix_sort_stream(stream, bits, work=work)
        return srt, pl.radix_unscatter(srt, srt.payload[:4])

    want = route()
    torch.cuda.synchronize()
    m = int(want[0].length[0])
    real = (sk.keys < dead) & (torch.arange(P, device=dev) < cands.count)[None]
    rows = []
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        for fn, argtypes in _native.SIGNATURES.items():
            if fn.startswith("pt_radix"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int

        def launch(fn, what, *a, lib=lib):
            if not fn.startswith("pt_radix"):
                return committed(fn, what, *a)
            if getattr(lib, fn)(*a) != 0:
                raise RuntimeError(f"{what}: launch failed")

        pl._launch, tile = launch, pl.RADIX_TILE
        pl.RADIX_TILE = pl.RADIX_THREADS * VARIANTS[name][1]
        try:
            got = route()
            torch.cuda.synchronize()
            exact = (torch.equal(got[0].key[:m], want[0].key[:m])
                     and torch.equal(got[0].payload[:, :m], want[0].payload[:, :m])
                     and torch.equal(got[0].entry[:m], want[0].entry[:m])
                     and torch.equal(got[1].view(4, E, P)[:, real],
                                     want[1].view(4, E, P)[:, real]))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    route()
                torch.cuda.synchronize()
        finally:
            pl._launch, pl.RADIX_TILE = committed, tile
        ms = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for k, sym in KERNELS.items():
                    if sym in e.name:
                        ms.setdefault(k, []).append(e.time_range.elapsed_us() / 1e3)
        row = {"variant": name, "replaced": VARIANTS[name][0], "tile": pl.RADIX_THREADS
               * VARIANTS[name][1], "depth": args.depth, "listed": int(cands.count[0]),
               "entries": m, "bit_for_bit": None if name in WRONG else exact,
               "ms_per_launch": {k: sum(v) / len(v) for k, v in ms.items()}}
        if name == "committed":
            srt = want[0]
            row["unscatter_replay_ms"] = chip_smoke.replay_ms(
                lambda srt=srt: pl.radix_unscatter(srt, srt.payload[:4]), 10)
        row["device"] = smi
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
