"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds
it against its plain PyTorch version on the card, renders the analytic
smoke configs against the XLA goldens (tools/goldens/smoke_128.npz),
drives the main path (Cornell 800x800, depth 8, AA, progressive) through
`Renderer.step_batch` and times it, and renders through the CLI. Every
phase prints one line; any failure raises and exits non-zero before the
result lines are printed. Imports nothing of JAX or of the JAX package.

The last three lines are the card's name and power limit (nvidia-smi),
one JSON object describing each kernel of the path, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "project3_cuda_path_tracer_tpu_torch/csrc/full_iteration.cu"
REPLACES = "project3_cuda_path_tracer_tpu/ops/megakernel.py:2848"
# image rule of tests/test_megakernel.py:143-145 (seam-tie outliers only)
PARITY_BAD = 1e-3
PARITY_FRAC = 0.02
PARITY_MEDIAN = 1e-5
# tools/smoke_pallas.py's golden rule
GOLDEN_BAD = 0.05
GOLDEN_FRAC = 0.04
ANALYTIC_SMOKE = [
    ("cornell.txt", {}),
    ("sphere.txt", {}),
    ("cornell_glass.txt", {"russian_roulette": True}),
    ("cornell_dof.txt", {"antialias": True, "depth_of_field": True}),
    ("env.txt", {}),
    ("many_materials.txt", {"russian_roulette": True}),
]
PARITY_CONFIGS = [
    ("cornell.txt", {"antialias": True}),
    ("cornell_glass.txt", {"russian_roulette": True}),
    ("cornell_dof.txt", {"antialias": True, "depth_of_field": True}),
    ("many_materials.txt", {"russian_roulette": True}),
]


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def small_scene(name: str, res):
    from project3_cuda_path_tracer_tpu_torch.models.scene import (
        derive_camera,
        load_scene,
    )

    s = load_scene(os.path.join(HERE, "scenes", name))
    c = s.state.camera
    s.state.camera = derive_camera(
        res, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    return s


def parity(dev, name, settings_kw, res, iteration=3):
    """One iteration through the kernel and through its plain version on
    the same device tables. Returns (badfrac, median, max_abs_err)."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.models.device import (
        camera_to_device,
        scene_to_device,
    )
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
    from project3_cuda_path_tracer_tpu_torch.render import RenderSettings

    scene = small_scene(name, res)
    settings = RenderSettings(trace_depth=8, **settings_kw)
    ds = scene_to_device(scene, dev)
    cam = camera_to_device(scene.state.camera, dev)
    accum = Vec3.zeros(res[0] * res[1], dev)
    megakernel.full_iteration(ds, cam, iteration, settings, accum)
    plain = megakernel.full_iteration_reference(ds, cam, iteration, settings)
    torch.cuda.synchronize()
    got = torch.stack(list(accum), -1).cpu().numpy()
    want = torch.stack(list(plain), -1).cpu().numpy()
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        raise RuntimeError(f"{name}: non-finite radiance")
    diff = np.abs(got - want)
    return float((diff > PARITY_BAD).mean()), float(np.median(diff)), float(diff.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from project3_cuda_path_tracer_tpu_torch.ops import _native, megakernel
    from project3_cuda_path_tracer_tpu_torch.render import Renderer, RenderSettings
    from project3_cuda_path_tracer_tpu_torch.models.scene import load_scene

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    # ---- 1. environment ----
    try:
        import triton  # noqa: F401

        triton_version = triton.__version__
    except ImportError as e:
        triton_version = f"not importable ({e})"
    nvcc = _native.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, timeout=60,
        check=True,
    ).stdout.strip().splitlines()[-1]
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=kind, device_count=torch.cuda.device_count(), nvidia_smi=smi,
        triton=triton_version, nvcc=nvcc_version, python=sys.version.split()[0])

    # ---- 2. build the kernel from this checkout's sources ----
    lib_path, build_s = _native.build(force=True)
    _native.load()
    usage = "not measured"
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if os.path.exists(cuobjdump):
        res = subprocess.run([cuobjdump, "--dump-resource-usage", str(lib_path)],
                             capture_output=True, text=True, timeout=60)
        usage = " | ".join(
            ln.strip() for ln in res.stdout.splitlines() if "REG" in ln
        ) or f"cuobjdump rc {res.returncode}"
    say("build", nvcc_seconds=build_s, library=os.path.relpath(lib_path, HERE),
        resource_usage=usage)

    # ---- 3. kernel vs plain version on the card ----
    for name, kw in PARITY_CONFIGS:
        frac, med, mx = parity(dev, name, kw, (64, 64))
        say("parity", config=name, settings=kw, res="64x64", badfrac=frac,
            median=med, max_abs_err=mx,
            rule=f"frac(|d|>{PARITY_BAD})<{PARITY_FRAC}, median<{PARITY_MEDIAN}")
        if not (frac < PARITY_FRAC and med < PARITY_MEDIAN):
            raise RuntimeError(f"kernel disagrees with its plain version on {name}")
    # at the main path's shapes: Cornell 800x800, depth 8, AA
    main_frac, main_med, main_err = parity(
        dev, "cornell.txt", {"antialias": True}, (800, 800), iteration=1
    )
    say("parity", config="cornell.txt", settings={"antialias": True},
        res="800x800", badfrac=main_frac, median=main_med, max_abs_err=main_err)
    if not (main_frac < PARITY_FRAC and main_med < PARITY_MEDIAN):
        raise RuntimeError("kernel disagrees with its plain version at 800x800")

    # ---- 4. analytic smoke configs against the XLA goldens ----
    goldens = np.load(os.path.join(HERE, "tools", "goldens", "smoke_128.npz"))
    for name, kw in ANALYTIC_SMOKE:
        scene = small_scene(name, (128, 128))
        settings = RenderSettings(
            trace_depth=min(scene.state.trace_depth or 8, 8), **kw
        )
        r = Renderer(scene, settings, device=dev)
        r.step_batch(2)
        img = r.image()
        if not (np.isfinite(img).all() and img.max() > 0):
            raise RuntimeError(f"{name}: non-finite or black render")
        diff = np.abs(np.clip(img / 2, 0.0, 1.0) - goldens[name].astype(np.float32))
        badfrac = float((diff > GOLDEN_BAD).mean())
        say("golden", config=name, settings=kw, badfrac=badfrac,
            mad=float(diff.mean()), rule=f"badfrac<={GOLDEN_FRAC}")
        if badfrac > GOLDEN_FRAC:
            raise RuntimeError(f"{name}: badfrac {badfrac} > {GOLDEN_FRAC}")

    # ---- 5. the main path at full size ----
    scene = load_scene(os.path.join(HERE, "scenes", "cornell.txt"))
    settings = RenderSettings(trace_depth=8, antialias=True)
    megakernel.full_iteration.launches = 0
    r = Renderer(scene, settings, device=dev)
    batch = 25
    r.step_batch(batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        r.step_batch(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = megakernel.full_iteration.launches
    if launches != r.iteration or launches != 9 * batch:
        raise RuntimeError(
            f"kernel launches {launches} != iterations rendered {r.iteration}"
        )
    img = r.image()
    if img.shape != (800, 800, 3) or not np.isfinite(img).all():
        raise RuntimeError(f"main path image bad: shape {img.shape}")
    mean = float(img.mean() / r.iteration)
    if not 0.05 < mean < 2.0:
        raise RuntimeError(f"main path mean radiance {mean} out of range")
    n_timed = 8 * batch
    pixels = scene.state.camera.pixel_count
    ms_per_frame = 1e3 * dt / n_timed
    mrays = pixels * settings.trace_depth * n_timed / dt / 1e6

    # the plain version at the same shape, on the same card
    from project3_cuda_path_tracer_tpu_torch.models.device import (
        camera_to_device,
        scene_to_device,
    )

    ds = scene_to_device(scene, dev)
    cam = camera_to_device(scene.state.camera, dev)
    megakernel.full_iteration_reference(ds, cam, 1, settings)  # warm-up
    torch.cuda.synchronize()
    n_plain = 5
    t0 = time.perf_counter()
    for k in range(n_plain):
        megakernel.full_iteration_reference(ds, cam, 2 + k, settings)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / n_plain
    device_str = f"{smi}"
    print(json.dumps({
        "metric": "Mrays/sec (Cornell 800x800 depth-8 AA, one GPU)",
        "value": mrays,
        "unit": "Mrays/s",
        "ms_per_frame": ms_per_frame,
        "time_to_5000spp_s": ms_per_frame * 5000 / 1e3,
        "device": device_str,
        "plain_ms_per_frame": plain_ms,
        "kernel_launches": launches,
        "iterations": r.iteration,
        "mean_radiance": mean,
    }), flush=True)

    # ---- 6. the CLI ----
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "project3_cuda_path_tracer_tpu_torch",
             os.path.join(HERE, "scenes", "cornell.txt"), "--iterations", "50",
             "--out-dir", out_dir],
            cwd=HERE, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        pngs = [f for f in os.listdir(out_dir) if f.endswith(".50samp.png")]
        if len(pngs) != 1:
            raise RuntimeError(f"CLI wrote {os.listdir(out_dir)}")
        say("cli", rc=proc.returncode, png=pngs[0],
            seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    say("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "full_iteration",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": main_err,
        "ms": ms_per_frame,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
