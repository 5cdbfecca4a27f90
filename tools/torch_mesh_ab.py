"""Time the PyTorch/CUDA port's per-bounce and mesh paths against those
of another checkout of this repository, in turns on one NVIDIA GPU, and
hold the renders bit for bit: #2 (`first_bounce`) and #3 (`bounce_step`)
on the per-bounce paths,
#7 (`mesh_candidates`) and #9 (`bounce_step_mesh`) on every mesh path, A
(`super_keys`), B (`place_entries`) with its glue and D
(`merge_entries`) on the big-mesh counting route.

    python tools/torch_mesh_ab.py --other DIR [--paths a,b,c,d,e,j,k,l,n,p] [--out FILE]

DIR is another checkout (or `git archive`) of the repository. Its port
package is loaded beside this one under the name `other_port`
(`tools/torch_nee_ab.py::load_port`) and builds its own sources into its
own build directory. Each side drives its own `Renderer` on its own
device scene made from this checkout's scene files, 800x800, depth 8:

- (a) cornell.txt AA through `Renderer.step()` (#2, then #3 at depths
  1-7); (b) AA with --compact, (c) --cache-first-bounce and (d) AA with
  --motion-blur (the sphere moving, as chip_smoke.py makes the scene)
  and (e) AA with --direct-lighting through `Renderer.step_batch` (#2 on
  all but (c); #3 after the compaction glue, after #4, after the re-pack,
  and at depths 1-6 before (e)'s plain last bounce);
- (j) mesh.txt AA through `step_batch` (#7 -> #8 -> #9 at every depth),
  (k) the same through `step()`, (l) with --cache-first-bounce through
  `step_batch` (#4 at depth 0 after the cache fill, #7 -> #8 -> #9 at
  depths 1-7);
- (n) mesh_big.txt and (p) bunny.txt AA through `step_batch` (#7 -> #8
  -> A -> B -> C -> D -> #9 at every depth, the counting route).

Both sides render 2 iterations first and their images are compared bit
for bit. Then, in turns (other, this, this, other): 3 iterations to warm,
20 timed on the host clock (ms per frame, closed by a synchronize), and 5
under torch.profiler: device busy ms per iteration (the union of the
device spans), the idle share against the host-timed frame, device events
per iteration and per depth, #2's, #3's, #7's, #9's, A's, B's, C's and D's
device ms per launch and at each depth (launch k of an iteration is its
k-th depth: #3's first is depth 1), and per depth the device ms and
events of B's glue
(every device event between A and C other than B itself). It prints one
JSON line per path and the card's name and power limit, writes them to
FILE when given, and exits non-zero if the images differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_nee_ab import ORDER, PKG, ROOT, bits_differ, load_port  # noqa: E402

AA = {"antialias": True}
PATHS = {  # label -> (scene, settings, route), each at its own 800x800
    "a": ("cornell.txt", AA, "step"),
    "b": ("cornell.txt", dict(AA, compact=True), "step_batch"),
    "c": ("cornell.txt", {"cache_first_bounce": True}, "step_batch"),
    "d": ("cornell_moving.txt", dict(AA, motion_blur=True), "step_batch"),
    "e": ("cornell.txt", dict(AA, direct_lighting=True), "step_batch"),
    "j": ("mesh.txt", AA, "step_batch"),
    "k": ("mesh.txt", AA, "step"),
    "l": ("mesh.txt", {"cache_first_bounce": True}, "step_batch"),
    "n": ("mesh_big.txt", AA, "step_batch"),
    "p": ("bunny.txt", AA, "step_batch"),
}
DEPTH = 8
KERNELS = {"first_bounce": "first_bounce_kernel", "bounce_step": "bounce_step_kernel",
           "mesh_candidates": "mesh_candidates_kernel",
           "bounce_step_mesh": "bounce_step_mesh_kernel",
           "place_entries": "place_entries_kernel", "super_keys": "super_keys_kernel",
           "window_sweep": "window_sweep_kernel", "merge_entries": "merge_entries_kernel"}


def renderer(port, name, kw, dev):
    """`port`'s Renderer of scene `name` at its own 800x800, depth 8
    (cornell_moving.txt: cornell.txt with its sphere moving, as
    chip_smoke.py's (d) makes it)."""
    if name == "cornell_moving.txt":
        import chip_smoke

        path = chip_smoke.moving_cornell(tempfile.mkdtemp(prefix="mesh_ab_"))
    else:
        path = os.path.join(ROOT, "scenes", name)
    scene = port["scene"].load_scene(path)
    settings = port["render"].RenderSettings(trace_depth=DEPTH, **kw)
    return port["render"].Renderer(scene, settings, device=dev)


def iterate(r, route, n):
    if route == "step":
        for _ in range(n):
            r.step()
    else:
        r.step_batch(n)


def profile(fn, n_iters):
    """(busy ms per iteration, device events per iteration, {kernel: device
    ms per launch}, {kernel: [device ms at each depth]}, B's glue {ms,
    events} per depth) of fn() (n_iters iterations) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        raise RuntimeError("the profiler saw no device activity")
    busy, end = 0.0, float("-inf")
    for e in events:  # the union of the device spans
        a, b = e.time_range.start, e.time_range.end
        if b > end:
            busy += b - max(a, end)
            end = b
    times = {k: [] for k in KERNELS}
    glue_ms, glue_events, after_a = 0.0, 0, False
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3
        kernel = next((k for k, sym in KERNELS.items() if sym in e.name), None)
        if kernel is not None:
            times[kernel].append(ms)
        # B's glue: what runs between A and C, but B
        if kernel == "super_keys":
            after_a = True
        elif kernel == "window_sweep":
            after_a = False
        elif after_a and kernel != "place_entries":
            glue_ms += ms
            glue_events += 1
    per_launch = {k: sum(v) / len(v) for k, v in times.items() if v}
    # a kernel launched the same number of times each iteration: its k-th
    # launch of an iteration is its k-th depth
    per_depth = {k: [sum(v[d::len(v) // n_iters]) / n_iters for d in range(len(v) // n_iters)]
                 for k, v in times.items() if v and len(v) % n_iters == 0}
    glue = {"ms": glue_ms / (n_iters * DEPTH), "events": glue_events / (n_iters * DEPTH)}
    return busy / 1e3 / n_iters, len(events) / n_iters, per_launch, per_depth, glue


def path_ab(ports, dev, label, name, kw, route):
    import torch

    sides = {who: renderer(port, name, kw, dev) for who, port in ports.items()}
    for r in sides.values():
        iterate(r, route, 2)
    torch.cuda.synchronize()
    imgs = {who: torch.from_numpy(r.image().copy()) for who, r in sides.items()}
    differ = bits_differ(imgs["other"].float(), imgs["this"].float())
    timed = {k: {who: [] for who in ports} for k in (
        "ms_per_frame", "busy_ms_per_iteration", "idle_share",
        "device_events_per_iteration", "device_events_per_depth",
        "kernel_ms_per_launch", "kernel_ms_per_depth", "b_glue_per_depth")}
    for who in ORDER:
        r = sides[who]
        iterate(r, route, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterate(r, route, 20)
        torch.cuda.synchronize()
        frame = 1e3 * (time.perf_counter() - t0) / 20
        busy, events, launch, depth, glue = profile(lambda r=r: iterate(r, route, 5), 5)
        for k, v in (("ms_per_frame", frame), ("busy_ms_per_iteration", busy),
                     ("idle_share", max(0.0, 1.0 - busy / frame)),
                     ("device_events_per_iteration", events),
                     ("device_events_per_depth", events / DEPTH),
                     ("kernel_ms_per_launch", launch), ("kernel_ms_per_depth", depth),
                     ("b_glue_per_depth", glue)):
            timed[k][who].append(v)
    return {"path": label, "scene": name, "settings": kw,
            "res": "800x800", "depth": DEPTH, "route": f"Renderer.{route}",
            "image_values_differing": differ, **timed}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another checkout of the repository")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help=f"the paths to run, of {','.join(PATHS)}")
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args()
    labels = [p for p in args.paths.split(",") if p]
    if not set(labels) <= set(PATHS):
        ap.error(f"--paths: of {','.join(PATHS)}")

    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    ports = {"this": load_port(PKG, ROOT),
             "other": load_port("other_port", os.path.abspath(args.other))}
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    results = []
    for label in labels:
        row = path_ab(ports, dev, label, *PATHS[label])
        row["device"] = smi
        results.append(row)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r["path"] for r in results if r["image_values_differing"]]
    if bad:
        print(f"torch_mesh_ab: the images differ on paths {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
