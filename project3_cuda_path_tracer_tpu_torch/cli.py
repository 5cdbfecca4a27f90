"""Command-line entry point: the main()/runCuda() equivalent.

The same argument surface as the JAX package's CLI, plus `--device`
(default `cuda`; the CPU renders with the plain PyTorch path only when
asked with `--device cpu`). `--no-pallas` runs the plain PyTorch versions
on the card as well (the JAX package's XLA pipeline; on the CPU the same
render as without it); `--pallas` is accepted and changes nothing.
`--stats` logs the alive curve and the stage breakdown
(utils/profiling.py) before the render; `--profile DIR` writes a
torch.profiler Chrome trace of the render into DIR. `--debug` runs the
bounds sweep at startup, checks every kernel launch and the
accumulator's finiteness after each chunk; `--debug-nans` checks every
stage's outputs for NaN and names the aten op that made it
(utils/debug.py). `--preview` opens the viewer (viewer.py, matplotlib).
`--shard spp=S,px=N,tri=T` renders through
parallel/shard.py::ShardedRenderer, one shard on each visible card
(`--device cuda`) or every shard on the CPU; it drops `--preview` and
`--stats` with a warning, as the JAX package's CLI does.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from .models.scene import load_scene, scene_summary
from .render import Renderer, RenderSettings
from .utils import debug, profiling

log = logging.getLogger("pathtracer")

def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="project3_cuda_path_tracer_tpu_torch",
        description="progressive path tracer, PyTorch/CUDA port",
    )
    p.add_argument("scene", help="scene file (reference text format)")
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cuda: the hand-written kernels; cpu: their plain PyTorch versions",
    )
    p.add_argument("--iterations", type=int, default=None, help="override spp")
    p.add_argument("--depth", type=int, default=None, help="override trace depth")
    p.add_argument("--sort-materials", action="store_true")
    p.add_argument("--compact", action="store_true")
    p.add_argument("--cache-first-bounce", action="store_true")
    p.add_argument("--antialias", action="store_true")
    p.add_argument("--dof", action="store_true")
    p.add_argument("--russian-roulette", action="store_true")
    p.add_argument("--direct-lighting", action="store_true")
    p.add_argument("--nee", action="store_true")
    p.add_argument("--stratified", action="store_true")
    p.add_argument("--sobol", action="store_true")
    p.add_argument("--motion-blur", action="store_true")
    p.add_argument(
        "--rr-start-depth",
        type=int,
        default=3,
        help="first bounce at which Russian roulette may kill paths",
    )
    p.add_argument(
        "--shard",
        default=None,
        metavar="SPEC",
        help="sharded rendering: 'spp=S' sample batches, 'px=N' pixel "
        "slices, 'tri=T' triangle slices, composable ('px=2,tri=2'); one "
        "shard a card under --device cuda, all on the CPU under --device cpu",
    )
    p.add_argument("--no-bvh", action="store_true",
                   help="the plain path sweeps every triangle instead of "
                        "walking the BVH (the CUDA mesh kernel always walks it)")
    p.add_argument("--pallas", action="store_true",
                   help="accepted; CUDA runs the hand-written kernels by default")
    p.add_argument("--no-pallas", action="store_true",
                   help="the plain PyTorch versions on the card too (the JAX "
                        "package's XLA pipeline); no kernel is launched")
    p.add_argument("--hdr", action="store_true", help="also save Radiance HDR")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--checkpoint", default=None, help="resume from / save to .npz")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--preview", action="store_true",
                   help="interactive viewer (matplotlib)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render into DIR")
    p.add_argument("--debug", action="store_true",
                   help="bounds sweep at startup, every kernel launch checked, "
                        "finite-accumulator assertions per chunk (utils/debug.py)")
    p.add_argument("--debug-nans", action="store_true",
                   help="every stage's outputs checked for NaN; a NaN names its "
                        "stage and the aten op that made it")
    p.add_argument("--stats", action="store_true",
                   help="log the alive rays per bounce and the stage times first")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def settings_from_args(args, scene) -> RenderSettings:
    return RenderSettings(
        trace_depth=args.depth or scene.state.trace_depth or 8,
        antialias=args.antialias,
        depth_of_field=args.dof,
        russian_roulette=args.russian_roulette,
        rr_start_depth=args.rr_start_depth,
        sort_by_material=args.sort_materials,
        compact=args.compact,
        cache_first_bounce=args.cache_first_bounce,
        direct_lighting=args.direct_lighting,
        nee_mis=args.nee,
        motion_blur=args.motion_blur,
        stratified=args.stratified,
        sobol=args.sobol,
        use_bvh=not args.no_bvh,
        plain=args.no_pallas,
    )


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    try:
        return _run(args)
    except FileNotFoundError as e:
        log.error("file not found: %s", e.filename or e)
        return 1
    except Exception as e:  # clean CLI errors; -v for the traceback
        from .models.scene import SceneParseError

        if isinstance(e, SceneParseError):
            log.error("scene parse error: %s", e)
            return 1
        if args.verbose:
            raise
        log.error("%s: %s (re-run with -v for the traceback)", type(e).__name__, e)
        return 1


def _run(args) -> int:
    if args.shard and (args.preview or args.stats):
        log.warning("--shard does not support --preview/--stats; ignoring them")
        args.preview = False
        args.stats = False
    with debug.checks(launches=args.debug, nans=args.debug_nans):
        if args.debug_nans:
            log.info("debug: every stage's outputs checked for NaN")
        return _run_checked(args)


def _run_checked(args) -> int:
    import contextlib
    import os

    scene = load_scene(args.scene)
    log.info(scene_summary(scene))
    settings = settings_from_args(args, scene)
    if args.shard:
        from .parallel.shard import ShardedRenderer, parse_shard_spec

        spp, px, tri = parse_shard_spec(args.shard)
        renderer = ShardedRenderer(scene, settings, spp=spp, px=px, tri=tri,
                                   device=args.device)
        log.info("sharded rendering: spp=%d px=%d tri=%d, %d shard(s) on %s",
                 spp, px, tri, len(renderer.devices),
                 ", ".join(str(d) for d in renderer.devices))
    else:
        renderer = Renderer(scene, settings, device=args.device)
        log.info("device %s", renderer.device)

    if args.debug:
        log.info("debug: running the bounds sweep (one iteration)...")
        debug.bounds_sweep(renderer)
        log.info("debug: bounds sweep clean")

    if args.checkpoint:
        # np.savez_compressed appends .npz; normalize once so the resume
        # existence check and the save target agree on the filename.
        if not args.checkpoint.endswith(".npz"):
            args.checkpoint += ".npz"
        if os.path.exists(args.checkpoint):
            renderer.load_checkpoint(args.checkpoint)
            log.info("resumed from %s at iteration %d", args.checkpoint, renderer.iteration)

    target = args.iterations if args.iterations is not None else scene.state.iterations

    if args.preview:
        from .viewer import run_viewer

        run_viewer(renderer, target, out_dir=args.out_dir)
        return 0

    with contextlib.ExitStack() as stack:
        prof = _start_profile(args.profile, renderer.device, stack)
        if args.stats:
            _log_stats(renderer)
        _render(args, renderer, settings, target)
    if prof is not None:
        path = os.path.join(args.profile, f"trace.{renderer.start_time_string}.json")
        prof.export_chrome_trace(path)
        log.info("profile written to %s", path)

    path = renderer.save(out_dir=args.out_dir)
    log.info("saved %s", path)
    if args.hdr:
        log.info("saved %s", renderer.save(out_dir=args.out_dir, hdr=True))
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)
    return 0


def _start_profile(out_dir, device, stack):
    """A torch.profiler session over the rest of the render (the JAX
    package's jax.profiler.start_trace), entered on `stack`; None without
    --profile."""
    if not out_dir:
        return None
    import os

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return stack.enter_context(profile(activities=activities))


def _log_stats(renderer) -> None:
    """--stats: one step() and its live rays after each depth, then each
    stage's time (the JAX package's cli.py:266-279)."""
    log.info("alive rays per bounce (iter %d): %s", renderer.iteration + 1,
             profiling.alive_curve(renderer).tolist())
    for stage, secs in profiling.stage_breakdown(renderer, reps=3).items():
        log.info("stage %-16s %8.3f ms", stage, 1e3 * secs)


def _sync(renderer) -> None:
    """Wait for the renderer's cards (every card of a sharded grid)."""
    if hasattr(renderer, "synchronize"):
        renderer.synchronize()
    else:
        profiling.sync(renderer.device)


def _render(args, renderer, settings, target) -> None:
    """Step in batches to `target`, logging Mrays/s and checkpointing."""
    t0 = time.perf_counter()
    last_t, last_iter = t0, renderer.iteration
    last_ckpt_iter = renderer.iteration
    rays_per_iter = renderer.camera.pixel_count * settings.trace_depth

    chunk = max(1, min(args.log_every or 50, 50))
    while renderer.iteration < target:
        n = min(chunk, target - renderer.iteration)
        renderer.step_batch(n)
        it = renderer.iteration
        if args.debug:
            accums = renderer.accums if hasattr(renderer, "accums") else [renderer.accum]
            for accum in accums:
                debug.assert_finite(accum, it)
        if args.log_every and (it % args.log_every == 0 or it >= target):
            _sync(renderer)
            now = time.perf_counter()
            dt = now - last_t
            n_done = it - last_iter
            mrays = rays_per_iter * n_done / dt / 1e6 if dt > 0 else 0.0
            log.info(
                "iter %d/%d  %.1f ms/iter  %.1f Mrays/s (%s)",
                it, target, 1e3 * dt / max(n_done, 1), mrays, renderer.device,
            )
            last_t, last_iter = now, it
        # iterations advance in chunks: checkpoint whenever a boundary
        # was crossed since the last checkpoint
        if (
            args.checkpoint
            and args.checkpoint_every
            and it // args.checkpoint_every > last_ckpt_iter // args.checkpoint_every
        ):
            renderer.save_checkpoint(args.checkpoint)
            last_ckpt_iter = it

    _sync(renderer)
    total = time.perf_counter() - t0
    log.info("rendered %d spp in %.2fs", renderer.iteration, total)


if __name__ == "__main__":
    sys.exit(main())
