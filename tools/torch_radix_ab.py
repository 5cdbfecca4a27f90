"""Time the PyTorch/CUDA port's radix route (PT_TPU_SORT_RADIX=1) against
that of another checkout of this repository, in turns on one NVIDIA GPU,
and hold the two renders bit for bit.

    python tools/torch_radix_ab.py --other DIR [--out FILE]

DIR is another checkout (or `git archive`) of the repository. Its port
package is loaded beside this one under the name `other_port`
(`tools/torch_nee_ab.py::load_port`), and builds its own sources into
its own build directory. Each side drives its own `Renderer` under its
own SORT_RADIX, on its own device scene made from this checkout's scene
files, so the two radix routes may launch in any way:

- (q) mesh_big.txt and (r) bunny.txt, 800x800, depth 8, AA, through
  `Renderer.step_batch` (#7 -> #8 -> A -> the radix route -> D -> #9 at
  every depth).

Both sides render 2 iterations first and their images are compared bit
for bit (the radix route is bit-equal to the counting route on both).
Then, in turns (other, this, this, other): 3 iterations to warm, 20
timed on the host clock (ms per frame, closed by a synchronize), and 5
under torch.profiler: device busy ms per iteration (the union of the
device spans), the idle share against the host-timed frame, device
events per iteration, and per depth the device ms of the radix kernels
(names holding `radix_`), of scans (names holding `scan`, any case: the
cumsums of a route that scans on the host's behalf) and of memsets, each
radix kernel's device ms per launch, and D's (`merge_entries`, once a
depth) device ms at each depth. It
prints one JSON line per path and the card's name and power limit,
writes them to FILE when given, and exits non-zero if the images differ.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_nee_ab import ORDER, PKG, ROOT, bits_differ, load_port  # noqa: E402

PATHS = {"q": "mesh_big.txt", "r": "bunny.txt"}  # label -> scene, 800x800 AA
DEPTH = 8


def renderer(port, name, dev):
    """`port`'s Renderer of scene `name` at its own 800x800, depth 8, AA,
    with SORT_RADIX set on `port`'s pipeline."""
    import importlib

    package = port["mk"].__name__.rsplit(".", 2)[0]
    importlib.import_module(f"{package}.ops.pipeline").SORT_RADIX = True
    scene = port["scene"].load_scene(os.path.join(ROOT, "scenes", name))
    settings = port["render"].RenderSettings(trace_depth=DEPTH, antialias=True)
    return port["render"].Renderer(scene, settings, device=dev)


def profile(fn, n_iters):
    """(busy ms per iteration, device events per iteration, {radix, scan,
    memset: device ms per depth}, {radix kernel: device ms per launch}, [D's
    device ms at each depth]) of fn() (n_iters iterations) under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, parts, kernels, merge = [], {"radix": 0.0, "scan": 0.0, "memset": 0.0}, {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if "merge_entries_kernel" in e.name:
            merge.append((e.time_range.start, e.time_range.elapsed_us() / 1e3))
        name = e.name.lower()
        for part in parts:
            if part in name:
                parts[part] += e.time_range.elapsed_us() / 1e3
        m = re.search(r"radix_\w*kernel(<\w+>|ILb[01]E)?", e.name)
        if m:
            kernels.setdefault(m.group(0), []).append(e.time_range.elapsed_us() / 1e3)
    if not spans:
        raise RuntimeError("the profiler saw no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # the union of the device spans
        if b > end:
            busy += b - max(a, end)
            end = b
    merge = [ms for _, ms in sorted(merge)]  # launch k of an iteration: depth k
    per_depth = ([sum(merge[d::DEPTH]) / n_iters for d in range(DEPTH)]
                 if len(merge) == n_iters * DEPTH else None)
    return (busy / 1e3 / n_iters, len(spans) / n_iters,
            {k: v / (n_iters * DEPTH) for k, v in parts.items()},
            {k: sum(v) / len(v) for k, v in kernels.items()}, per_depth)


def route_ab(ports, dev, label, name):
    import torch

    sides = {who: renderer(port, name, dev) for who, port in ports.items()}
    for r in sides.values():
        r.step_batch(2)
    torch.cuda.synchronize()
    imgs = {who: torch.from_numpy(r.image().copy()) for who, r in sides.items()}
    differ = bits_differ(imgs["other"].float(), imgs["this"].float())
    timed = {k: {who: [] for who in ports} for k in (
        "ms_per_frame", "busy_ms_per_iteration", "idle_share",
        "device_events_per_iteration", "radix_kernels_ms_per_depth",
        "scan_ms_per_depth", "memset_ms_per_depth", "radix_kernel_ms_per_launch",
        "merge_entries_ms_per_depth")}
    for who in ORDER:
        r = sides[who]
        r.step_batch(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step_batch(20)
        torch.cuda.synchronize()
        frame = 1e3 * (time.perf_counter() - t0) / 20
        busy, events, parts, kernels, merge = profile(lambda r=r: r.step_batch(5), 5)
        for k, v in (("ms_per_frame", frame), ("busy_ms_per_iteration", busy),
                     ("idle_share", max(0.0, 1.0 - busy / frame)),
                     ("device_events_per_iteration", events),
                     ("radix_kernels_ms_per_depth", parts["radix"]),
                     ("scan_ms_per_depth", parts["scan"]),
                     ("memset_ms_per_depth", parts["memset"]),
                     ("radix_kernel_ms_per_launch", kernels),
                     ("merge_entries_ms_per_depth", merge)):
            timed[k][who].append(v)
    return {"path": label, "scene": name, "settings": {"antialias": True},
            "res": "800x800", "depth": DEPTH, "route": "Renderer.step_batch, SORT_RADIX",
            "image_values_differing": differ, **timed}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another checkout of the repository")
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_radix_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    ports = {"this": load_port(PKG, ROOT),
             "other": load_port("other_port", os.path.abspath(args.other))}
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    results = []
    for label, name in PATHS.items():
        row = route_ab(ports, dev, label, name)
        row["device"] = smi
        results.append(row)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r["path"] for r in results if r["image_values_differing"]]
    if bad:
        print(f"torch_radix_ab: the images differ on paths {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
