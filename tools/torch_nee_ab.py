"""Hold the PyTorch/CUDA port's NEE kernels #5 and #6 against those of
another checkout of this repository, bit for bit, and time both in turns
on one NVIDIA GPU.

    python tools/torch_nee_ab.py --other DIR [--out FILE]

DIR is another checkout (or `git archive`) of the repository. Its port
package is loaded into this process beside this one, under the name
`other_port` (the package imports its own modules relatively), and
builds its own sources with its own ops/_native.py into its own build
directory. Each side is driven through its own public wrappers,
`ops/megakernel.full_iteration_nee` and `bounce_step_nee`, on its own
device scene made from this checkout's scene files, so the two kernels
may launch in any way (per iteration or per run, with or without
counters):

- (f) Cornell 800x800 depth 8 AA --nee: #6 over 25 iterations in one
  wrapper call, the accumulators compared on every value;
- (h) many_materials 1920x1080 depth 8 RR --nee: the same over 40
  iterations;
- (g), (i): the same two scenes, #5 at every depth of one iteration from
  the camera pool (plain `generate_rays`, aux at zeros), each depth's
  input given to both wrappers: every value of the 16 lanes (pool and
  aux) compared, and each side's slots dead on entry against the input;
- on mesh scenes (the mesh instantiations on MeshOf<Tables> and
  MeshOf<TexTables>): (aa) mesh.txt 800x800 depth 8 AA --nee, #6 over 25
  iterations; (ab) the same scene, #5 as on (g); (ac) mesh_big.txt
  800x800 AA, #6 over 25 iterations; (ad) mesh_textured.txt 800x800 AA,
  #6 over 25 iterations; (ae) the same scene, #5 as on (g). `--paths`
  picks some (all by default; a checkout from before the mesh
  instantiations refuses the mesh paths).

The analytic paths (f)-(i) must agree bit for bit. On the mesh paths
two walks of one BVH may pick other triangles where a triangle's t lies
an ulp inside a box's slab entry (a binary and a wide walk, say), so
there the tool counts the values and lanes (pixels for #6, pool slots for
#5) that differ in any bit and holds them to a rule instead: #6's
accumulators to the NEE image rule (at most 3% of values off by more
than 1e-3, the median difference under 1e-5), #5's 16 lanes at each
depth to the lane rule of tests/test_megakernel.py:57-76 (each lane at
most 1% of slots off by more than 1e-4, pix exactly, alive on at most
1%), and each side's dead slots unchanged.

Then it times both in turns (other, this, this, other) under
torch.profiler: the device time of the kernels whose names hold the
wrapper's name, per iteration for #6 (summed over the call's launches)
and per launch for #5 (each depth's launch repeated on fresh copies of
its input). It prints one JSON line per path and the card's name and
power limit, writes them all to FILE when given, and exits non-zero if
a path breaks its rule.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "project3_cuda_path_tracer_tpu_torch"
PATHS = {  # label -> (scene, settings, kernel, iterations)
    "f": ("cornell.txt", {"antialias": True}, "full_iteration_nee", 25),
    "h": ("many_materials.txt", {"russian_roulette": True}, "full_iteration_nee", 40),
    "g": ("cornell.txt", {"antialias": True}, "bounce_step_nee", 1),
    "i": ("many_materials.txt", {"russian_roulette": True}, "bounce_step_nee", 1),
    "aa": ("mesh.txt", {"antialias": True}, "full_iteration_nee", 25),
    "ab": ("mesh.txt", {"antialias": True}, "bounce_step_nee", 1),
    "ac": ("mesh_big.txt", {"antialias": True}, "full_iteration_nee", 25),
    "ad": ("mesh_textured.txt", {"antialias": True}, "full_iteration_nee", 25),
    "ae": ("mesh_textured.txt", {"antialias": True}, "bounce_step_nee", 1),
}
MESH_PATHS = ("aa", "ab", "ac", "ad", "ae")  # held to a rule, not bit for bit
ORDER = ("other", "this", "this", "other")


def load_port(name: str, path: str) -> dict:
    """The port package under `path` imported as `name`: its modules that
    this tool drives."""
    if name == PKG:
        sys.path.insert(0, path)
    else:
        pkg_dir = os.path.join(path, PKG)
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg_dir, "__init__.py"),
            submodule_search_locations=[pkg_dir])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod  # its submodules import it by this name
        spec.loader.exec_module(mod)
    return {k: importlib.import_module(f"{name}.{m}") for k, m in (
        ("mk", "ops.megakernel"), ("vec", "ops.vec"), ("device", "models.device"),
        ("scene", "models.scene"), ("render", "render"))}


def setup(port, name, kw, dev):
    scene = port["scene"].load_scene(os.path.join(ROOT, "scenes", name))
    ds = port["device"].scene_to_device(scene, dev)
    cam = port["device"].camera_to_device(scene.state.camera, dev)
    settings = port["render"].RenderSettings(trace_depth=8, nee_mis=True, **kw)
    return ds, cam, settings, port["mk"].pack_scene_tables(ds, nee=True)


def bits_differ(a, b) -> int:
    import torch

    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def lanes_differ(xs, ys):
    """(lanes where any of the lanes' arrays differ in a bit, lanes)."""
    import torch

    off = torch.zeros_like(xs[0], dtype=torch.bool)
    for a, b in zip(xs, ys):
        off |= a.view(torch.int32) != b.view(torch.int32)
    return int(off.sum()), off.numel()


def off_frac(a, b, atol) -> float:
    """The share of values of a and b further apart than atol."""
    return float(((a.double() - b.double()).abs() > atol).double().mean())


def kernel_ms(fn, kernel: str, tries: int = 3) -> tuple[float, int]:
    """(device ms summed over the kernels whose names hold `kernel`,
    their launches) of fn() under torch.profiler. A profile that saw no
    such kernel (the profiler can miss a whole window of device activity
    in a long process) is taken again, up to `tries` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if us:
            return sum(us) / 1e3, len(us)
    raise RuntimeError(f"the profiler saw no {kernel} kernel in {tries} tries")


def full_iteration_ab(ports, dev, label, name, kw, n):
    """#6: bits differing between the two accumulators after n
    iterations, and each side's device ms per iteration in turns."""
    import torch

    sides = {who: setup(port, name, kw, dev) for who, port in ports.items()}
    resx, resy = sides["this"][1].resolution
    P = resx * resy

    def run(who):
        ds, cam, settings, t = sides[who]
        acc = ports[who]["vec"].Vec3.zeros(P, dev)
        ports[who]["mk"].full_iteration_nee(ds, cam, 1, settings, acc, n_iters=n,
                                            tables=t)
        return acc

    accs = {who: run(who) for who in ports}
    torch.cuda.synchronize()
    differ = sum(bits_differ(a, b) for a, b in zip(accs["other"], accs["this"]))
    pixels_off, _ = lanes_differ(accs["other"], accs["this"])
    diff = torch.cat([(a - b).abs() for a, b in zip(accs["other"], accs["this"])])
    image_rule = {"frac_off_1e-3": float((diff > 1e-3).double().mean()),
                  "median": float(diff.median()), "rule": "frac<0.03, median<1e-5"}
    image_rule["held"] = image_rule["frac_off_1e-3"] < 0.03 and image_rule["median"] < 1e-5
    ms = {who: [] for who in ports}
    launches = {}
    for who in ORDER:
        total, launches[who] = kernel_ms(lambda: run(who), "full_iteration_nee")  # noqa: B023
        ms[who].append(total / n)
    return {"path": label, "kernel": "full_iteration_nee", "scene": name,
            "settings": kw, "res": f"{resx}x{resy}", "iterations": n,
            "values_differing": differ, "values": 3 * P,
            "pixels_differing": pixels_off, "image_rule": image_rule,
            "ms_per_iteration": ms, "launches": launches}


def bounce_step_ab(ports, dev, label, name, kw, reps=3):
    """#5 at every depth of one iteration: values differing between the
    two sides' outputs (all 16 lanes) and in each side's dead slots
    against the input, and each side's device ms per launch in turns."""
    import torch

    sides = {who: setup(port, name, kw, dev) for who, port in ports.items()}
    it = 2
    pool = ports["this"]["render"]._camera_pool(sides["this"][1], it, sides["this"][2])
    P = pool[5].shape[0]
    lanes = ports["this"]["mk"].pool_lanes(pool) + [torch.zeros(P, device=dev),
                                                   torch.zeros(P, device=dev)]
    D = sides["this"][2].trace_depth

    def bounce(who, src, depth):
        """One call of `who`'s wrapper on a copy of `src` (16 lanes)."""
        ds, _, settings, t = sides[who]
        V = ports[who]["vec"].Vec3
        w = [a.clone() for a in src]
        state = (V(*w[0:3]), V(*w[3:6]), V(*w[6:9]), V(*w[9:12]), w[12], w[13])
        ports[who]["mk"].bounce_step_nee(state, (w[14], w[15]), ds, it, depth,
                                         settings, depth == D - 1, tables=t)
        return w

    rows = []
    for depth in range(D):
        out = {who: bounce(who, lanes, depth) for who in ports}
        torch.cuda.synchronize()
        dead = lanes[12] == 0
        by_lane = [bits_differ(a, b) for a, b in zip(out["other"], out["this"])]
        slots_off, _ = lanes_differ(out["other"], out["this"])
        fracs = [off_frac(a, b, 1e-4) for a, b in zip(out["other"], out["this"])]
        row = {
            "depth": depth, "live_in": int((~dead).sum()),
            "values_differing": sum(by_lane), "values_differing_by_lane": by_lane,
            "slots_differing": slots_off,
            "lane_rule": {"worst_frac_off_1e-4": max(fracs[:12] + fracs[14:]),
                          "alive_frac": fracs[12], "pix_differing": by_lane[13],
                          "held": (max(fracs[:12] + fracs[14:]) <= 0.01
                                   and fracs[12] <= 0.01 and by_lane[13] == 0)},
            "dead_values_changed": {who: sum(bits_differ(a[dead], b[dead])
                                             for a, b in zip(out[who], lanes))
                                    for who in ports},
            "ms": {who: [] for who in ports},
        }
        for who in ORDER:
            total, k = kernel_ms(lambda: [bounce(who, lanes, depth)  # noqa: B023
                                          for _ in range(reps)], "bounce_step_nee")
            row["ms"][who].append(total / k)
        rows.append(row)
        lanes = out["this"]
    return {"path": label, "kernel": "bounce_step_nee", "scene": name,
            "settings": kw, "res": "x".join(map(str, sides["this"][1].resolution)),
            "per_depth": rows,
            "values_differing": sum(r["values_differing"] for r in rows),
            "slots_differing": sum(r["slots_differing"] for r in rows),
            "lane_rule_held": all(r["lane_rule"]["held"] for r in rows),
            "dead_values_changed": sum(sum(r["dead_values_changed"].values())
                                       for r in rows),
            "ms_per_launch": {who: [sum(r["ms"][who][j] for r in rows) / D
                                    for j in range(2)] for who in ports}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another checkout of the repository")
    ap.add_argument("--out", help="write the results here as JSON")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated labels of the paths to run (default: all)")
    args = ap.parse_args()
    labels = args.paths.split(",")
    if not set(labels) <= set(PATHS):
        ap.error(f"--paths: known labels are {', '.join(PATHS)}")

    import torch

    if not torch.cuda.is_available():
        print("torch_nee_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    ports = {"this": load_port(PKG, ROOT),
             "other": load_port("other_port", os.path.abspath(args.other))}
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    results = []
    for label in labels:
        name, kw, kernel, n = PATHS[label]
        if kernel == "full_iteration_nee":
            row = full_iteration_ab(ports, dev, label, name, kw, n)
        else:
            row = bounce_step_ab(ports, dev, label, name, kw)
        row["device"] = smi
        results.append(row)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r["path"] for r in results if r.get("dead_values_changed") or (
        not (r["image_rule"]["held"] if "image_rule" in r else r["lane_rule_held"])
        if r["path"] in MESH_PATHS else r["values_differing"])]
    if bad:
        print(f"torch_nee_ab: paths {bad} break their rule (bits on (f)-(i), "
              "the image or lane rule on the mesh paths)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
