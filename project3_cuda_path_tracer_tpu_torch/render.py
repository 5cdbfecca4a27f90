"""The render core: settings, the shading steps, the per-bounce paths and
the renderer.

The PyTorch counterpart of the JAX package's `render.py`. The CUDA
reference's shape
    generateRayFromCamera -> while(depth) { computeIntersections; shade }
    -> finalGather -> tonemap
has these tiers here, as in the JAX package:
- the whole-iteration kernel (ops/megakernel.py::full_iteration, #1),
  which `render_batch` runs whenever no per-bounce feature is on;
- the per-bounce wavefront path, `trace_paths`: first_bounce (#2) or, on
  a first-bounce cache, shade_step (#4) over the cached depth-0
  intersections, then bounce_step (#3) for depths 1..D-1, with stream
  compaction between bounces and the motion-blur shutter time. It runs
  under `Renderer.step()` always and under `render_batch` with
  --compact, --cache-first-bounce, --motion-blur or --direct-lighting;
- the mesh path (a scene with mesh geoms), `trace_paths` too: plain
  `generate_rays` for the depth-0 rays, as the JAX package's mesh route,
  then the mesh pipeline (ops/pipeline.py::bounce_step_pipeline: #7
  candidates -> #8 BVH sweep -> the sorted route #11-#14 for each geom
  above 16,384 triangles -> #9 merge + shade) at every depth, with
  the same compaction, cache (#4 over `intersect_scene_any`'s depth 0),
  motion blur, RR and QMC as the analytic path; `render_batch` takes it
  on a mesh scene but under --nee (#1 sweeps analytic geoms only);
- --sort-materials (the JAX package's `_maybe_sort_by_material`): at every
  depth `intersect_scene_any` (#7 -> [#8 -> A-D ->] #10), a stable sort of
  the pool and its Intersections by material (`_maybe_sort_by_material`:
  a `radix_split` digit pass, #15 + #16, over the slot iota; dead lanes
  last), then shade_step (#4) over the sorted pool; from plain
  `generate_rays` at depth 0, or from the first-bounce cache, which stays
  in pixel order (the sort permutes a copy). It never reaches #1, #2, #3,
  #6 or #9; --nee refuses it (ValueError), as the JAX package does;
- --direct-lighting (final-bounce NEE): the per-bounce path for depths
  0..D-2, then `_nee_final_step` at depth D-1 (one shadow ray to a
  sampled light point from each diffuse lane, RNG stream 254). That step
  is plain PyTorch on every device, as the JAX package runs it in XLA
  outside any Pallas kernel; its two intersect calls go through
  `intersect_scene_any` (the mesh pipeline #7 -> #8 [-> A-D] -> #10 on a
  mesh scene on CUDA);
- --nee (NEE + MIS at every non-delta vertex, `_nee_mis_bounce`): under
  `render_batch` the whole-iteration NEE kernel
  (megakernel.full_iteration_nee, #6), one launch per run of up to
  ITERATIONS_PER_LAUNCH iterations; under
  `Renderer.step()`, and under `render_batch` with --motion-blur, the
  per-bounce NEE kernel (megakernel.bounce_step_nee, #5) once per depth
  0..D-1 from plain `generate_rays`, the MIS aux state (previous pdf,
  previous non-delta flag) riding as two pool lanes. On a mesh scene
  both kernels run their mesh instantiations, which walk each mesh geom's
  binary BVH for the nearest hit and for the shadow ray (every mesh geom,
  the big-mesh route's included: no mesh pipeline launch on this path).
  --nee takes precedence over --direct-lighting and refuses compaction
  and the first-bounce cache (ValueError), as the JAX package does;
- the tri-shard tier (--shard tri=N, `settings.tri_axis`; the JAX
  package's `kernel_plan.shard_shade`): `trace_paths` with a group of
  `TriShard`s, each a triangle slice of the scene
  (parallel/shard.py::tri_sharded_device_scenes). Every depth is
  `intersect_scene_any` over the group (each shard's #7 -> #8 [-> A-D] ->
  #10 on its own tables, then `merge_isect_shards`, the min-t merge), the
  optional material sort, and #4 over the merged pool with shard 0's
  tables (materials, analytic geoms and lights are in every slice). #1,
  #2, #3, #5, #6 and #9 intersect inside themselves and never run there
  (megakernel.check_supported refuses them); --nee runs the plain
  `_nee_mis_bounce`, whose intersects are the merged kernels' chain.
Between the kernels runs only the glue the JAX package runs in XLA: the
compaction permutation, the material sort's keys, digit counts and
gathers, the alive sums, the radiance scatter (`index_add_`), the
per-iteration re-pack of the moved transforms, and the tri tier's merge.

`trace_paths` also takes a slice of the frame's pixels (`pix`, the
sharded renderer's px and spp shards): depth 0 then starts from the
slice's camera rays (`generate_rays(pix)`) and a bounce, as the JAX
package's non-fused first bounce; #2 renders only the whole frame.

Every wrapper launches its hand-written kernel on CUDA tensors and runs
its plain PyTorch version on CPU tensors, so the same functions render
on both devices; under `RenderSettings.plain` (--no-pallas, the JAX
package's XLA pipeline) the plain versions run on the card too, and the
Renderer says so in the log.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from .models.device import (
    DeviceCamera,
    DeviceScene,
    advance_time,
    camera_to_device,
    scene_to_device,
)
from .models.scene import Scene, derive_camera
from .ops import rng
from .ops.bsdf import reflect, scatter
from .ops.camera import generate_rays
from .ops.intersect import Intersections
from .ops.lights import lights_area_weight, sample_lights
from .ops.megakernel import (
    SceneTables,
    bounce_step,
    bounce_step_nee,
    draw_slots,
    first_bounce,
    full_iteration,
    full_iteration_nee,
    pack_geom_tables,
    pack_scene_tables,
    runs_plain,
    shade_step,
)
from .ops.pipeline import bounce_step_pipeline, intersect_pipeline, sort_permutation
from .ops.sweep import intersect_scene
from .ops.texture import apply_textures, env_radiance
from .ops.vec import Vec3, take as vtake, where as vwhere
from .utils import debug
from .utils import image as image_io

log = logging.getLogger("pathtracer")


@dataclass(frozen=True)
class RenderSettings:
    """Runtime toggles; the same fields and defaults as the JAX
    package's RenderSettings. `tri_axis` is set by
    parallel/shard.py::ShardedRenderer alone, as in the JAX package: the
    tri-shard tier (intersect, merge, #4 at every depth; a Renderer with it
    set renders one shard of the whole scene that way). `use_bvh` selects the plain path's
    mesh traversal (the BVH walk, or the naive sweep over every
    triangle); the mesh kernel always walks the BVH, as the JAX package's
    Pallas pipeline ignores the flag. `use_pallas` selects nothing: it
    keeps the JAX field and default. `plain` (the CLI's --no-pallas, the
    counterpart of the JAX package's XLA pipeline) runs every wrapper's
    plain PyTorch version on the card too; by default CUDA tensors launch
    the kernels and CPU tensors take the plain versions
    (ops/megakernel.py::runs_plain).

    The two light-sampling tiers: `direct_lighting` replaces the last
    bounce's hemisphere sample of diffuse lanes with one shadow ray to a
    sampled light point (per-bounce path, then `_nee_final_step`);
    `nee_mis` samples a light at every non-delta vertex and weights it
    against the BSDF sample by the power heuristic (kernel #6 under
    `step_batch`, kernel #5 per depth under `step()` and with motion
    blur). `nee_mis` wins when both are set; both need an emissive geom,
    and `nee_mis` refuses `compact` and an effective first-bounce
    cache."""

    trace_depth: int = 8
    sort_by_material: bool = False
    compact: bool = False
    cache_first_bounce: bool = False
    antialias: bool = False
    depth_of_field: bool = False
    russian_roulette: bool = False
    rr_start_depth: int = 3
    direct_lighting: bool = False
    nee_mis: bool = False
    stratified: bool = False
    sobol: bool = False
    tri_axis: "str | None" = None
    motion_blur: bool = False
    use_bvh: bool = True
    use_pallas: bool = False
    plain: bool = False

    def effective_cache(self) -> bool:
        # AA and DoF jitter the camera rays, which invalidates a
        # first-bounce cache
        return self.cache_first_bounce and not (
            self.antialias or self.depth_of_field
        )


def _gather_materials(scene: DeviceScene, mat_id: torch.Tensor):
    safe = torch.clamp(mat_id, min=0).to(torch.int64)
    return (
        vtake(scene.mat_color, safe),
        vtake(scene.mat_specular_color, safe),
        scene.mat_has_reflective[safe],
        scene.mat_has_refractive[safe],
        scene.mat_ior[safe],
        scene.mat_emittance[safe],
        scene.mat_specular_exponent[safe] if scene.any_glossy else None,
        scene.mat_sss[safe] if scene.any_sss else None,
    )


def _shade_step(state, isect: Intersections, scene: DeviceScene,
                iteration: int, depth: int, settings: RenderSettings,
                add_emission: bool = True,
                textured_color: Vec3 | None = None):
    """One masked shading step over the whole pool; the JAX package's
    `_shade_step`: textures and bump maps (`apply_textures`, with the
    Intersections' mesh UVs), the environment (constant or lat-long map)
    and subsurface scattering included.

    state = (origins, dirs, throughput, radiance, alive, pix). RNG draws
    follow the scene-specialised slot layout (megakernel.draw_slots),
    keyed (iteration, pixelIndex, depth).

    add_emission=False (the NEE + MIS continuation, `_nee_mis_bounce`):
    emissive hits still end their lane but add nothing, and escaped lanes
    collect no environment; the caller has added both. textured_color:
    the albedo the caller already textured, used as it is; isect.normal is
    then trusted as it is (the caller's bump-perturbed normal)."""
    origins, dirs, throughput, radiance, alive, pix = state
    hit = isect.t > 0.0
    zeros = Vec3.zeros(pix.shape[0], pix.device)

    if (scene.has_env_const or scene.has_env_map) and add_emission:
        # escaped rays collect the environment radiance, then die
        env = env_radiance(scene, dirs)
        radiance = radiance + vwhere(alive & ~hit, throughput * env, zeros)

    n_draws, slot_branch, slot_fresnel, slot_rr = draw_slots(
        scene.any_partial_reflective,
        scene.any_refractive,
        settings.russian_roulette,
    )
    u = rng.uniforms(iteration, pix, depth, n_draws)
    if (settings.stratified or settings.sobol) and depth == 0:
        # padded QMC: the depth-0 hemisphere pair comes from the R2
        # lattice (or the Owen-scrambled Sobol sequence); deeper bounces
        # keep their independent draws (ops/rng.py)
        pair = rng.sobol_pair if settings.sobol else rng.stratified_pair
        u = pair(iteration, pix, 0) + u[2:]

    mats = _gather_materials(scene, isect.material_id)
    normal = isect.normal
    if textured_color is not None:
        mats = (textured_color,) + mats[1:]
    elif scene.any_textured or scene.any_bump:
        p_hit = origins + dirs * (isect.t - 1e-4)
        color, normal = apply_textures(
            scene, p_hit, normal, isect.material_id, mats[0],
            tex_u=isect.tex_u, tex_v=isect.tex_v, has_uv=isect.has_uv,
        )
        mats = (color,) + mats[1:]
    new_origin, new_dir, tint, emitted, at_light = scatter(
        origins,
        dirs,
        isect.t,
        normal,
        isect.outside,
        *mats[:7],
        u_hemi1=u[0],
        u_hemi2=u[1],
        u_branch=None if slot_branch is None else u[slot_branch],
        u_fresnel=None if slot_fresnel is None else u[slot_fresnel],
        m_sss=mats[7],
        t_segment=isect.t,
    )

    live_hit = alive & hit
    # light hit: contribute throughput * (color*emittance), terminate
    lit = live_hit & at_light
    if add_emission:
        radiance = radiance + vwhere(lit, throughput * emitted, zeros)
    cont = live_hit & ~at_light
    throughput = vwhere(cont, throughput * tint, throughput)

    if settings.russian_roulette:
        # kill low-throughput paths with survival prob = max component,
        # compensating survivors
        p_survive = torch.clamp(throughput.max_component(), 0.05, 1.0)
        do_rr = cont & (depth >= settings.rr_start_depth)
        killed = do_rr & (u[slot_rr] >= p_survive)
        throughput = vwhere(do_rr, throughput * (1.0 / p_survive), throughput)
        cont = cont & ~killed

    alive = cont
    origins = vwhere(alive, new_origin, origins)
    dirs = vwhere(alive, new_dir, dirs)
    return (origins, dirs, throughput, radiance, alive, pix)


_INV_PI = 1.0 / math.pi
_HALF_INV_PI = 0.5 / math.pi


class TriShard(NamedTuple):
    """One shard of a --shard tri group: the DeviceScene of one triangle
    slice (parallel/shard.py::tri_sharded_device_scenes), on its device,
    and its kernels' tables (None: packed when needed on CUDA, unused on
    the CPU)."""

    scene: DeviceScene
    tables: SceneTables | None = None


# the merge's key of a miss (t <= 0): the JAX package's 3.4e38
_MERGE_MISS = 3.4e38


def _isect_to(isect: Intersections, device) -> Intersections:
    if isect.t.device == device:
        return isect
    return Intersections(
        t=isect.t.to(device), normal=Vec3(*(c.to(device) for c in isect.normal)),
        material_id=isect.material_id.to(device), outside=isect.outside.to(device),
        tex_u=isect.tex_u.to(device), tex_v=isect.tex_v.to(device),
        has_uv=isect.has_uv.to(device),
    )


def merge_isect_shards(isects, device=None) -> Intersections:
    """The min-t merge of the Intersections of N triangle slices of one
    pool (the JAX package's `_merge_isect_axis` over its tri mesh axis):
    each lane takes the hit of the shard with the least key, the key t
    where t > 0 and 3.4e38 else; ties go to the lowest shard, as there
    (the argmin's first index), and all seven fields come from the winner.
    A lane every shard misses keeps shard 0's miss. Plain PyTorch glue on
    every device, as the JAX package merges in XLA: a strict-< running
    minimum over the shards in order, which is the argmin with its ties
    to the first. Shards on other devices are copied to `device` (by
    default the first shard's) first."""
    if device is None:
        device = isects[0].t.device
    isects = [_isect_to(h, device) for h in isects]
    out = isects[0]
    if len(isects) == 1:
        return out
    best = torch.where(out.t > 0, out.t, _MERGE_MISS)
    t, nx, ny, nz = out.t, *out.normal
    mat, side, tu, tv, uv = (out.material_id, out.outside, out.tex_u,
                             out.tex_v, out.has_uv)
    for h in isects[1:]:
        key = torch.where(h.t > 0, h.t, _MERGE_MISS)
        win = key < best
        best = torch.where(win, key, best)
        t = torch.where(win, h.t, t)
        nx = torch.where(win, h.normal.x, nx)
        ny = torch.where(win, h.normal.y, ny)
        nz = torch.where(win, h.normal.z, nz)
        mat = torch.where(win, h.material_id, mat)
        side = torch.where(win, h.outside, side)
        tu = torch.where(win, h.tex_u, tu)
        tv = torch.where(win, h.tex_v, tv)
        uv = torch.where(win, h.has_uv, uv)
    return Intersections(t=t, normal=Vec3(nx, ny, nz), material_id=mat,
                         outside=side, tex_u=tu, tex_v=tv, has_uv=uv)


def intersect_scene_any(origins: Vec3, dirs: Vec3, scene: DeviceScene,
                        settings: RenderSettings, alive=None,
                        tables: SceneTables | None = None,
                        shards=None) -> Intersections:
    """`intersect_scene` through the mesh pipeline (#7 -> #8 [-> the
    sorted route A-D] -> #10, ops/pipeline.py::intersect_pipeline), as the
    JAX package's `intersect_scene_any` swaps in its Pallas pipeline; on an
    analytic scene #7 -> #10 (no candidate). On the CPU the same chain's
    plain versions (#8's walk with `settings.use_bvh`), which on an
    analytic scene equal plain `intersect_scene` exactly. `alive` (None:
    all alive) marks the lanes the pipeline tests for meshes; dead lanes
    keep their analytic hit.

    `shards` (a sequence of TriShard, --shard tri): the chain runs on each
    shard's scene and tables instead (`scene` and `tables` unused), the
    rays copied to a shard on another device, and `merge_isect_shards`
    merges the hits on the rays' device: the one choke point of the tri
    tier, as the JAX package's merge is (every bounce, the cache fill,
    --direct-lighting's and --nee's intersects)."""
    if shards is None:
        return intersect_pipeline(origins, dirs, alive, scene, tables=tables,
                                  use_bvh=settings.use_bvh, plain=settings.plain)
    device = origins.x.device
    hits = []
    for sh in shards:
        d = sh.scene.device
        o, di, a = origins, dirs, alive
        if d != device:
            o = Vec3(*(c.to(d) for c in origins))
            di = Vec3(*(c.to(d) for c in dirs))
            a = None if alive is None else alive.to(d)
        hits.append(intersect_pipeline(o, di, a, sh.scene, tables=sh.tables,
                                       use_bvh=settings.use_bvh,
                                       plain=settings.plain))
    return merge_isect_shards(hits, device)


@debug.stage
def _nee_final_step(state, scene: DeviceScene, iteration: int,
                    settings: RenderSettings,
                    tables: SceneTables | None = None, shards=None):
    """The last bounce of --direct-lighting (the JAX package's
    `_nee_final_step`): escaped lanes collect the environment, emissive
    hits add their emission, and each live DIFFUSE lane trades its last
    hemisphere sample for one shadow ray to a light point (RNG stream
    NEE_STREAM). Albedo, emission and normal are untextured, as there.
    Every lane ends here. Plain PyTorch on every device (the JAX package runs
    this step in XLA, outside any Pallas kernel), but both intersect
    calls go through `intersect_scene_any` (merged over `shards` under
    --shard tri), as there."""
    origins, dirs, throughput, radiance, alive, pix = state
    P = pix.shape[0]
    zeros = Vec3.zeros(P, pix.device)
    isect = intersect_scene_any(origins, dirs, scene, settings, alive=alive,
                                tables=tables, shards=shards)
    hit = isect.t > 0.0
    m_color, _spec, m_refl, m_refr, _ior, m_emit, _sexp, _sss = (
        _gather_materials(scene, isect.material_id))

    if scene.has_env_const or scene.has_env_map:
        env = env_radiance(scene, dirs)
        radiance = radiance + vwhere(alive & ~hit, throughput * env, zeros)

    live_hit = alive & hit
    lit = live_hit & (m_emit > 0.0)
    radiance = radiance + vwhere(lit, throughput * (m_color * m_emit), zeros)

    diffuse = live_hit & (m_emit <= 0.0) & (m_refl <= 0.0) & (m_refr <= 0.0)
    p_hit = origins + dirs * (isect.t - 1e-4)

    u = rng.uniforms(iteration, pix, rng.NEE_STREAM, 3)
    lp, ln, weight, le = sample_lights(scene, u[0], u[1], u[2])

    to_l = lp - p_hit
    r2 = torch.clamp(to_l.length_sq(), min=1e-8)
    r = torch.sqrt(r2)
    wi = to_l * (1.0 / r)
    cos_s = torch.clamp(isect.normal.dot(wi), min=0.0)
    cos_l = torch.clamp(-ln.dot(wi), min=0.0)

    shadow = intersect_scene_any(p_hit, wi, scene, settings, alive=alive,
                                 tables=tables, shards=shards)
    visible = (shadow.t < 0.0) | (shadow.t >= r - 1e-2)

    g = cos_s * cos_l / r2 * weight * _INV_PI
    contrib = throughput * m_color * le * g
    take = diffuse & visible & (cos_s > 0) & (cos_l > 0)
    radiance = radiance + vwhere(take, contrib, zeros)

    dead = torch.zeros(P, dtype=torch.bool, device=pix.device)
    return (origins, dirs, throughput, radiance, dead, pix)


def _nee_intersect(origins: Vec3, dirs: Vec3, scene: DeviceScene,
                   settings: RenderSettings, shards) -> Intersections:
    """The intersect of `_nee_mis_bounce`: the JAX package calls its
    `intersect_scene_any` there, which on its XLA path is plain
    `intersect_scene` (the BVH or, under --no-bvh, the naive sweep). So
    does the port, no kernel launched, which keeps the estimator the plain
    version #5 and #6 are held to on every device; under --shard tri
    (`shards`) it is `intersect_scene_any` over the group, the kernels'
    chain of every shard merged, so that no shard's triangles are
    missed."""
    if shards is None:
        return intersect_scene(origins, dirs, scene, use_bvh=settings.use_bvh)
    return intersect_scene_any(origins, dirs, scene, settings, shards=shards)


def _nee_mis_bounce(state, aux, scene: DeviceScene, iteration: int,
                    depth: int, settings: RenderSettings, is_last: bool,
                    probe: dict | None = None, shards=None):
    """One bounce of the NEE + MIS estimator (the JAX package's
    `_nee_mis_bounce`, op for op): at every vertex with a non-delta lobe
    one area-sampled shadow ray adds
        throughput * f_mix * Le * G * (A*n) * w_light,
    and an emissive hit of the BSDF-sampled ray adds its emission times
    w_bsdf (power heuristic, beta = 2; both sides use the mean-area light
    pdf model of `ops.lights.lights_area_weight`, so the weights sum to
    one). The camera vertex and delta vertices (SPECEX == 0 mirror picks,
    refraction) keep full weight at an emissive hit. f_mix is the mixed
    BRDF the BSDF sampler implies: (1-p) albedo/pi + p spec
    pdf_lobe/cos_s, p = clip(REFL, 0, 1).

    state = (origins, dirs, throughput, radiance, alive bool, pix); aux =
    (prev_pdf (P,) f32, prev_nondelta (P,) bool), zeros at depth 0.
    is_last: the light sample takes full weight and every lane ends, its
    throughput untouched. Order of the radiance terms: the environment on
    escape, the MIS-weighted emission, the NEE term with the entry
    throughput, then the continuation's tint and Russian roulette.
    Returns (state', aux').

    probe: a dict that, when given, receives the (P,) bool masks that
    decide the kernels' work per lane, for counting it (chip_smoke.py's
    bounds): `live_hit`, `lit` (an emissive hit), `nee_able` (a live
    non-emissive hit with a non-delta lobe), `shadow` (the NEE-able
    lanes whose light sample faces both ways, the ones that cast a shadow
    ray) and `visible`; and the shadow rays themselves as `p_hit`, `wi`
    and the light distance `r`. `shards`: the tri group whose merged hits
    both intersects take (`_nee_intersect`)."""
    origins, dirs, throughput, radiance, alive, pix = state
    prev_pdf, prev_nondelta = aux
    P = pix.shape[0]
    zeros = Vec3.zeros(P, pix.device)

    isect = _nee_intersect(origins, dirs, scene, settings, shards)
    hit = isect.t > 0.0
    live_hit = alive & hit
    m_color, m_spec, m_refl, m_refr, _ior, m_emit, m_sexp, m_sss = (
        _gather_materials(scene, isect.material_id))
    normal = isect.normal
    if scene.any_textured or scene.any_bump:
        # textures and bump once: the light sample and the continuation
        # both shade with this albedo and normal
        p_tex = origins + dirs * (isect.t - 1e-4)
        m_color, normal = apply_textures(
            scene, p_tex, normal, isect.material_id, m_color,
            tex_u=isect.tex_u, tex_v=isect.tex_v, has_uv=isect.has_uv,
        )

    if scene.has_env_const or scene.has_env_map:
        env = env_radiance(scene, dirs)
        radiance = radiance + vwhere(alive & ~hit, throughput * env, zeros)

    # --- emissive hit: MIS-weighted by the previous vertex's strategy ---
    lit = live_hit & (m_emit > 0.0)
    area_weight = lights_area_weight(scene)
    cos_l_hit = torch.abs(normal.dot(dirs))
    pdf_light_hit = (isect.t * isect.t) / torch.clamp(
        cos_l_hit * area_weight, min=1e-8
    )
    w_bsdf = torch.where(
        prev_nondelta,
        (prev_pdf * prev_pdf)
        / torch.clamp(prev_pdf * prev_pdf + pdf_light_hit * pdf_light_hit,
                      min=1e-20),
        1.0,
    )
    emitted = m_color * m_emit
    radiance = radiance + vwhere(lit, throughput * emitted * w_bsdf, zeros)

    # --- the light sample at every vertex with a non-delta lobe ---
    p_mix = torch.clamp(m_refl, 0.0, 1.0)
    glossy_ok = m_sexp is not None
    nee_able = live_hit & (m_emit <= 0.0) & (m_refr <= 0.0)
    if m_sss is not None:
        # subsurface transport is no surface BRDF: no light sample
        nee_able = nee_able & (m_sss <= 0.0)
    has_diffuse_lobe = p_mix < 1.0
    if glossy_ok:
        has_glossy_lobe = (p_mix > 0.0) & (m_sexp > 0.0)
    else:
        has_glossy_lobe = torch.zeros(P, dtype=torch.bool, device=pix.device)
    nee_able = nee_able & (has_diffuse_lobe | has_glossy_lobe)

    p_hit = origins + dirs * (isect.t - 1e-4)
    ul = rng.uniforms(iteration, pix, rng.NEE_DEPTH_BASE + depth, 3)
    lp, ln, weight, le = sample_lights(scene, ul[0], ul[1], ul[2])
    to_l = lp - p_hit
    r2 = torch.clamp(to_l.length_sq(), min=1e-8)
    r = torch.sqrt(r2)
    wi = to_l * (1.0 / r)
    cos_s = torch.clamp(normal.dot(wi), min=0.0)
    cos_l = torch.clamp(-ln.dot(wi), min=0.0)
    shadow = _nee_intersect(p_hit, wi, scene, settings, shards)
    visible = (shadow.t < 0.0) | (shadow.t >= r - 1e-2)

    # Phong lobe pdf of the light direction (glossy lanes)
    mirror = reflect(dirs, normal)
    if glossy_ok:
        cos_a = torch.clamp(mirror.dot(wi), min=0.0)
        pdf_lobe = torch.where(
            has_glossy_lobe,
            (m_sexp + 1.0) * _HALF_INV_PI * torch.pow(cos_a, m_sexp),
            0.0,
        )
    else:
        pdf_lobe = torch.zeros(P, dtype=torch.float32, device=pix.device)

    pdf_light_sa = r2 / torch.clamp(cos_l * area_weight, min=1e-8)
    pdf_bsdf_sa = (1.0 - p_mix) * cos_s * _INV_PI + p_mix * pdf_lobe
    if is_last:
        w_light = torch.ones_like(cos_s)  # no continuation competes
    else:
        w_light = (pdf_light_sa * pdf_light_sa) / torch.clamp(
            pdf_light_sa * pdf_light_sa + pdf_bsdf_sa * pdf_bsdf_sa, min=1e-20
        )
    # geometric factor without the BRDF; f folds in per lobe below
    g_geo = cos_s * cos_l / r2 * weight
    f_diff = m_color * ((1.0 - p_mix) * _INV_PI)
    f_spec_scale = p_mix * pdf_lobe / torch.clamp(cos_s, min=1e-6)
    f_mix = f_diff + m_spec * f_spec_scale
    contrib = throughput * f_mix * le * (g_geo * w_light)
    shadow = nee_able & (cos_s > 0) & (cos_l > 0)
    radiance = radiance + vwhere(shadow & visible, contrib, zeros)
    if probe is not None:
        probe.update(live_hit=live_hit, lit=lit, nee_able=nee_able,
                     shadow=shadow, visible=visible, p_hit=p_hit, wi=wi, r=r)

    if is_last:
        dead = torch.zeros(P, dtype=torch.bool, device=pix.device)
        return ((origins, dirs, throughput, radiance, dead, pix),
                (torch.zeros_like(prev_pdf), dead))

    # --- the BSDF continuation (the ordinary scatter step), with the
    # textured albedo and the bump-perturbed normal ---
    isect = Intersections(
        t=isect.t, normal=normal, material_id=isect.material_id,
        outside=isect.outside, tex_u=isect.tex_u, tex_v=isect.tex_v,
        has_uv=isect.has_uv,
    )
    new_state = _shade_step(
        (origins, dirs, throughput, radiance, alive, pix), isect, scene,
        iteration, depth, settings, add_emission=False,
        textured_color=m_color,
    )
    n_dirs, n_alive = new_state[1], new_state[4]

    # next-vertex MIS bookkeeping: the pdf of the sampled direction under
    # the lane's mixed strategy; a mirror pick (a delta lobe, detected by
    # the new direction coinciding with the mirror direction) keeps full
    # weight at the next emissive hit
    cos_new = torch.clamp(normal.dot(n_dirs), min=0.0)
    next_pdf = (1.0 - p_mix) * cos_new * _INV_PI
    if glossy_ok:
        cos_an = torch.clamp(mirror.dot(n_dirs), min=0.0)
        next_pdf = next_pdf + p_mix * torch.where(
            has_glossy_lobe,
            (m_sexp + 1.0) * _HALF_INV_PI * torch.pow(cos_an, m_sexp),
            0.0,
        )
    mirror_pick = (
        (p_mix > 0.0) & ~has_glossy_lobe & (mirror.dot(n_dirs) > 1.0 - 1e-6)
    )
    next_nondelta = nee_able & n_alive & ~mirror_pick
    return new_state, (next_pdf, next_nondelta)


def _permute_state(state, perm: torch.Tensor):
    origins, dirs, throughput, radiance, alive, pix = state
    return (
        vtake(origins, perm),
        vtake(dirs, perm),
        vtake(throughput, perm),
        vtake(radiance, perm),
        alive[perm],
        pix[perm],
    )


def _permute_isect(isect: Intersections, perm: torch.Tensor) -> Intersections:
    return Intersections(
        t=isect.t[perm],
        normal=vtake(isect.normal, perm),
        material_id=isect.material_id[perm],
        outside=isect.outside[perm],
        tex_u=isect.tex_u[perm],
        tex_v=isect.tex_v[perm],
        has_uv=isect.has_uv[perm],
    )


def material_key_bits(scene: DeviceScene) -> int:
    """The bits of the material sort's key: bit_length(n_materials), so
    that the dead key 2**bits - 1 lies above every material id (6 bits for
    many_materials' 32)."""
    return max(1, scene.mat_color.x.shape[0].bit_length())


def material_keys(state, isect: Intersections, bits: int) -> torch.Tensor:
    """The sort key of each lane: its material id where it is alive and
    hit something, else the dead key 2**bits - 1 (the JAX package's
    INT32_MAX, in as few bits), (P,) int32."""
    live = (state[4] != 0) & (isect.t > 0)
    return torch.where(live, isect.material_id, (1 << bits) - 1).to(torch.int32)


def _maybe_sort_by_material(state, isect: Intersections, scene: DeviceScene,
                            settings: RenderSettings):
    """Permute the pool and its Intersections so that lanes of one
    material are contiguous, dead lanes last (INSTRUCTION.md:80-86; the JAX
    package's `_maybe_sort_by_material`). The permutation is its stable
    argsort element for element: `sort_permutation` (a `radix_split` digit
    pass, #15 + #16, over the slot iota on CUDA; the plain split on the
    CPU). The 23 gathers are PyTorch glue. No host sync."""
    if not settings.sort_by_material:
        return state, isect
    bits = material_key_bits(scene)
    perm = sort_permutation(material_keys(state, isect, bits), bits,
                            plain=settings.plain).to(torch.int64)
    return _permute_state(state, perm), _permute_isect(isect, perm)


def _sorted_bounce(state, scene: DeviceScene, iteration: int, depth: int,
                   settings: RenderSettings, num_alive=None,
                   tables: SceneTables | None = None, shards=None):
    """One bounce under --sort-materials (the JAX package's `one_bounce`
    with sort) and of the tri-shard tier (its `one_bounce` under
    `shard_shade`, the sort optional): intersect the pool
    (`intersect_scene_any`, merged over `shards`), sort it with its
    Intersections by material under --sort-materials, shade it (#4, with
    `tables`: shard 0's under tri). Returns the new pool (in the sorted
    order). `num_alive` is not used: the whole pool is shaded, as there."""
    isect = intersect_scene_any(state[0], state[1], scene, settings,
                                alive=state[4], tables=tables, shards=shards)
    state, isect = _maybe_sort_by_material(state, isect, scene, settings)
    return shade_step(state, isect, scene, iteration, depth, settings,
                      tables=tables)


def _maybe_compact(state, settings: RenderSettings):
    """Stream compaction: live lanes packed to the front (stable), so
    bounce_step can skip every lane at or past the live count - the
    static-shape analog of thrust::partition (src/pathtrace.cu:313-317).

    The exclusive-scan permutation of the JAX package: live lane i goes
    to cumsum(alive)[i]-1, dead lane i to n_alive + cumsum(dead)[i]-1;
    one scatter of an iota inverts it into the gather permutation. All
    on the device, no host sync."""
    if not settings.compact:
        return state
    alive = state[4].to(torch.int64)
    P = alive.shape[0]
    n_alive = alive.sum()
    front = torch.cumsum(alive, 0) - 1
    back = n_alive + torch.cumsum(1 - alive, 0) - 1
    dest = torch.where(alive != 0, front, back)
    perm = torch.empty_like(dest).scatter_(
        0, dest, torch.arange(P, dtype=torch.int64, device=alive.device)
    )
    return _permute_state(state, perm)


def _count_alive(state) -> torch.Tensor:
    """The live lanes of a pool, as an int32 scalar tensor on its device."""
    return torch.sum(state[4], dtype=torch.int32)


def _empty_cache(pixel_count: int, device) -> Intersections:
    return Intersections(
        t=torch.zeros(pixel_count, dtype=torch.float32, device=device),
        normal=Vec3.zeros(pixel_count, device),
        material_id=torch.zeros(pixel_count, dtype=torch.int32, device=device),
        outside=torch.zeros(pixel_count, dtype=torch.bool, device=device),
    )


def shutter_time(iteration: int) -> float:
    """The motion-blur shutter sample of an iteration: the first draw of
    stream TIME_STREAM at index 0. Computed on the host (the integer RNG
    and one float multiply give the same bits on every device)."""
    u = rng.uniforms(iteration, torch.zeros(1, dtype=torch.int32),
                     rng.TIME_STREAM, 1)
    return float(u[0][0])


def _device_tables(scene: DeviceScene,
                   settings: RenderSettings) -> SceneTables | None:
    """The kernels' packed tables on CUDA (with the light pdf model and
    the binary BVH's nodes and roots that the NEE kernels walk under
    --nee, but for a slice of the tri-shard tier, whose --nee runs the
    plain estimator); None where the
    plain versions run (`runs_plain`: the CPU, or `settings.plain`),
    which read the DeviceScene itself."""
    if runs_plain(scene.device, settings.plain):
        return None
    return pack_scene_tables(scene, nee=settings.nee_mis and settings.tri_axis is None)


def _check_lighting(scene: DeviceScene, settings: RenderSettings) -> None:
    """The JAX package's ValueErrors for the light-sampling tiers: both
    need an emissive geom, and the NEE + MIS aux state is not
    pool-permutation aware."""
    if (settings.nee_mis or settings.direct_lighting) and not scene.emissive_geoms:
        raise ValueError(
            "NEE/direct lighting needs an area light: no geom in this "
            "scene has an emissive material (EMITTANCE > 0). "
            "Environment-only scenes (e.g. scenes/env.txt) must render "
            "without --nee/--direct-lighting."
        )
    if settings.nee_mis and (
        settings.sort_by_material or settings.compact
        or settings.effective_cache()
    ):
        raise ValueError(
            "nee_mis composes with AA/DoF/RR/stratified but not with "
            "sort/compact/first-bounce cache (the MIS aux state is not "
            "pool-permutation aware)"
        )


def _camera_pool(cam: DeviceCamera, iteration: int, settings: RenderSettings,
                 pix: torch.Tensor | None = None):
    """The camera rays of an iteration (plain `generate_rays`) as a fresh
    pool: every lane alive, unit throughput, no radiance, pix = slot, or
    the given global pixel ids `pix` (a slice of the frame)."""
    origins, dirs, pix = generate_rays(
        cam, iteration, settings.antialias, settings.depth_of_field, pix
    )
    P = pix.shape[0]
    device = pix.device
    return (
        Vec3(*(c.contiguous() for c in origins)), dirs,
        Vec3.ones(P, device), Vec3.zeros(P, device),
        torch.ones(P, dtype=torch.int32, device=device), pix,
    )


def _trace_nee(scene: DeviceScene, cam: DeviceCamera, iteration: int,
               settings: RenderSettings, tables: SceneTables | None,
               count_alive: bool, pix: torch.Tensor | None = None,
               shards=None):
    """The per-bounce NEE + MIS route: plain `generate_rays` for the
    depth-0 rays (of the pixels `pix`, by default the frame), then
    bounce_step_nee (#5) at every depth 0..D-1, the last at is_last, with
    the MIS aux starting at zeros; under --shard tri (`shards`) the plain
    `_nee_mis_bounce` at every depth instead, its intersects merged over
    the group, as the JAX package runs its XLA estimator there. Returns
    what `trace_paths` returns; the pool is never permuted."""
    device = scene.device
    state = _camera_pool(cam, iteration, settings, pix)
    P = state[5].shape[0]
    D = settings.trace_depth
    if shards is not None:
        state = state[:4] + (state[4] != 0, state[5])
        aux = (torch.zeros(P, dtype=torch.float32, device=device),
               torch.zeros(P, dtype=torch.bool, device=device))
        counts = []
        for depth in range(D):
            state, aux = _nee_mis_bounce(state, aux, scene, iteration, depth,
                                         settings, depth == D - 1, shards=shards)
            if count_alive:
                counts.append(_count_alive(state))
        alive_counts = torch.stack(counts) if count_alive else None
        return state[3], state[5], _empty_cache(P, device), alive_counts
    aux = (torch.zeros(P, dtype=torch.float32, device=device),
           torch.zeros(P, dtype=torch.float32, device=device))
    # #5's slot counters, one word per depth, zeroed together (unused on
    # the CPU)
    counters = torch.zeros(D, dtype=torch.int32, device=device)
    counts = []
    for depth in range(D):
        state, aux = bounce_step_nee(
            state, aux, scene, iteration, depth, settings,
            is_last=depth == D - 1, tables=tables, counter=counters[depth],
        )
        if count_alive:
            counts.append(_count_alive(state))
    alive_counts = torch.stack(counts) if count_alive else None
    return state[3], state[5], _empty_cache(P, device), alive_counts


def trace_paths(
    scene: DeviceScene,
    cam: DeviceCamera,
    iteration: int,
    cache: Intersections | None,
    settings: RenderSettings,
    use_cache: bool,
    tables: SceneTables | None = None,
    count_alive: bool = True,
    pix: torch.Tensor | None = None,
    shards=None,
):
    """One full sample per pixel through the per-bounce path: first_bounce
    (#2), or shade_step (#4) over the depth-0 intersections under the
    first-bounce cache, then bounce_step (#3) for depths 1..D-1, with
    compaction between bounces. On a mesh scene every bounce is the mesh
    pipeline (#7 -> #8 [-> A-D] -> #9), depth 0 from plain
    `generate_rays`, and the cache fill runs `intersect_scene_any`. Under
    --sort-materials every bounce is `_sorted_bounce` (intersect, sort,
    #4), depth 0 from plain `generate_rays` or the cache (sorted as a
    copy). Under --direct-lighting the
    last depth is `_nee_final_step` instead; under --nee every depth is
    bounce_step_nee (#5), from plain `generate_rays` (`_trace_nee`).

    `pix` ((P,) int32 global pixel ids on the scene's device, None: the
    whole frame) traces a slice of the frame (the sharded renderer): depth
    0 is then the slice's camera rays and a bounce (#3 on an analytic
    scene, the JAX package's non-fused first bounce), never #2.

    Under --shard tri (`settings.tri_axis`) every depth is `_sorted_bounce`
    over the group `shards` (a sequence of TriShard, shard 0 on the pool's
    device; None: the one shard (`scene`, `tables`)): each shard's #7 ->
    #8 [-> A-D] -> #10, the merge, [the material sort,] #4 with shard 0's
    tables; the cache fill and --direct-lighting's intersects merge the
    same way, and --nee runs the plain estimator (`_trace_nee`). `scene`
    and `tables` are then shard 0's. Motion blur moves every shard's scene
    and re-packs its transforms.

    `iteration` is 1-based. `cache` holds the depth-0 Intersections in
    pixel order and is read only when `use_cache`. `tables` are the
    kernels' packed tables (packed here when None; with motion blur only
    their transforms are re-packed). Returns (radiance Vec3, pix (P,),
    depth-0 Intersections, alive_counts (D,) int32 on the device, or
    None when neither `count_alive` nor compaction needs them). pix
    tracks the pool permutation of compaction and of the material sort."""
    _check_lighting(scene, settings)
    if settings.tri_axis is None and shards is not None:
        raise ValueError("a tri-shard group needs settings.tri_axis")
    if settings.tri_axis is not None and shards is None:
        shards = (TriShard(scene, tables),)
    if settings.motion_blur:
        # one shutter-time sample per iteration: move the geoms, re-pack
        # only the two (G,16) tables that change
        t_shutter = shutter_time(iteration)
        if shards is not None:
            shards = tuple(_advance_shard(sh, t_shutter) for sh in shards)
        else:
            scene, tables = _advance_shard(TriShard(scene, tables), t_shutter)
    if shards is not None:
        shards = tuple(sh if sh.tables is not None
                       else TriShard(sh.scene, _device_tables(sh.scene, settings))
                       for sh in shards)
        scene, tables = shards[0]
    elif tables is None:
        tables = _device_tables(scene, settings)
    if settings.nee_mis:
        return _trace_nee(scene, cam, iteration, settings, tables, count_alive,
                          pix, shards)
    device = scene.device
    mesh = bool(scene.mesh_geoms)
    split = settings.sort_by_material or shards is not None

    def bounce(state, scene, iteration, depth, settings, num_alive=None,
               tables=None):
        if split:
            return _sorted_bounce(state, scene, iteration, depth, settings,
                                  tables=tables, shards=shards)
        step = bounce_step_pipeline if mesh else bounce_step
        return step(state, scene, iteration, depth, settings,
                    num_alive=num_alive, tables=tables)

    if settings.effective_cache():
        # depth 0 from the cached (or freshly computed) intersections of
        # the pinhole camera rays; the cache is pixel-ordered
        state = _camera_pool(cam, iteration, settings, pix)
        isect0 = cache if use_cache else intersect_scene_any(
            state[0], state[1], scene, settings, tables=tables, shards=shards)
        cache_out = isect0
        state, isect0 = _maybe_sort_by_material(state, isect0, scene, settings)
        state = shade_step(state, isect0, scene, iteration, 0, settings,
                           tables=tables)
    elif mesh or split or pix is not None:
        # the JAX package's mesh route (and its sorted and tri routes, and
        # its non-fused first bounce of a slice): plain camera rays, then
        # the pipeline (or intersect, [sort,] #4, or #3) from depth 0
        state = bounce(_camera_pool(cam, iteration, settings, pix), scene,
                       iteration, 0, settings, tables=tables)
        cache_out = _empty_cache(state[5].shape[0], device)
    else:
        state = first_bounce(scene, cam, iteration, settings, tables=tables)
        cache_out = _empty_cache(state[5].shape[0], device)
    state = _maybe_compact(state, settings)
    counts = None
    if count_alive or settings.compact:
        counts = [_count_alive(state)]

    # depths 1..D-1 (1..D-2 under direct lighting): the wavefront bounce
    # loop (src/pathtrace.cu:340-377)
    D = settings.trace_depth
    for depth in range(1, D - 1 if settings.direct_lighting else D):
        state = bounce(
            state, scene, iteration, depth, settings,
            num_alive=counts[-1] if settings.compact else None,
            tables=tables,
        )
        state = _maybe_compact(state, settings)
        if counts is not None:
            counts.append(_count_alive(state))
    if settings.direct_lighting and D > 1:
        state = _nee_final_step(state[:4] + (state[4] != 0, state[5]), scene,
                                iteration, settings, tables=tables,
                                shards=shards)
        if counts is not None:
            counts.append(_count_alive(state))

    alive_counts = torch.stack(counts) if counts is not None else None
    return state[3], state[5], cache_out, alive_counts


def _advance_shard(shard: TriShard, t: float) -> TriShard:
    """A scene (and its tables, when packed) at shutter time `t`: the
    geoms moved (`advance_time`), only the two (G,16) transform tables
    re-packed."""
    scene = advance_time(shard.scene, t)
    tables = shard.tables
    if tables is not None:
        xf, inv = pack_geom_tables(scene)
        tables = tables._replace(xf=xf, inv=inv)
    return TriShard(scene, tables)


def _scatter_add(accum: Vec3, pix: torch.Tensor, radiance: Vec3) -> None:
    """finalGather through a permuted pool: accum[pix] += radiance, in
    place. pix is a permutation, so each slot receives one add and the
    result is deterministic."""
    index = pix.to(torch.int64)
    for a, r in zip(accum, radiance):
        a.index_add_(0, index, r)


def render_iteration(
    scene: DeviceScene,
    cam: DeviceCamera,
    accum: Vec3,
    iteration: int,
    cache: Intersections | None,
    settings: RenderSettings,
    use_cache: bool,
    tables: SceneTables | None = None,
    count_alive: bool = True,
):
    """One full sample per pixel through the per-bounce path, added into
    accum in place (finalGather, src/pathtrace.cu:269-278). Returns
    (accum, depth-0 Intersections, alive_counts)."""
    radiance, pix, cache_out, alive_counts = trace_paths(
        scene, cam, iteration, cache, settings, use_cache, tables=tables,
        count_alive=count_alive,
    )
    if settings.sort_by_material or settings.compact:
        _scatter_add(accum, pix, radiance)
    else:
        for a, r in zip(accum, radiance):  # pool slot == pixel
            a.add_(r)
    return accum, cache_out, alive_counts


def whole_kernel(settings: RenderSettings,
                 scene: DeviceScene | None = None) -> bool:
    """Whether render_batch runs the whole-iteration kernel #1: the JAX
    package's kernel_plan.whole_kernel for what the port renders, without
    its geoms x materials limit (a TPU compile-time trade-off); never on a
    mesh `scene`, nor under --shard tri."""
    return not (
        (scene is not None and scene.mesh_geoms)
        or settings.tri_axis is not None
        or settings.sort_by_material
        or settings.compact
        or settings.effective_cache()
        or settings.motion_blur
        or settings.direct_lighting
        or settings.nee_mis
    )


def nee_kernel(settings: RenderSettings) -> bool:
    """Whether render_batch runs the whole-iteration NEE kernel #6 (the
    JAX package's kernel_plan.nee_kernel, without its body limit, so
    many_materials --nee takes it too, and without its 80k-triangle cap,
    a VMEM budget of the TPU: every mesh scene takes it): --nee without
    motion blur, outside the tri-shard tier."""
    return (settings.nee_mis and not settings.motion_blur
            and settings.tri_axis is None)


def render_batch(scene: DeviceScene, cam: DeviceCamera, accum: Vec3,
                 iteration0: int, n_iters: int,
                 settings: RenderSettings,
                 tables: SceneTables | None = None) -> Vec3:
    """n_iters full samples added into accum (in place), starting at the
    1-based iteration id `iteration0`: the whole-iteration kernel when
    `whole_kernel(settings, scene)`, the whole-iteration NEE kernel #6
    when `nee_kernel(settings)` (on analytic and mesh scenes
    alike), else the per-bounce path (the mesh path on a mesh scene), with
    the first-bounce cache computed once per batch from iteration0's
    pinhole rays. CPU tensors take the plain versions throughout."""
    _check_lighting(scene, settings)
    if whole_kernel(settings, scene):
        full_iteration(scene, cam, iteration0, settings, accum,
                       n_iters=n_iters, tables=tables)
        return accum
    if nee_kernel(settings):
        full_iteration_nee(scene, cam, iteration0, settings, accum,
                           n_iters=n_iters, tables=tables)
        return accum
    if tables is None:
        tables = _device_tables(scene, settings)
    use_cache = settings.effective_cache()
    cache = None
    if use_cache:
        origins, dirs, _ = generate_rays(cam, iteration0, False, False)
        cache = intersect_scene_any(origins, dirs, scene, settings,
                                    tables=tables)
    for k in range(n_iters):
        render_iteration(scene, cam, accum, iteration0 + k, cache, settings,
                         use_cache, tables=tables, count_alive=False)
    return accum


def tonemap(accum: Vec3, iteration: int, resolution) -> torch.Tensor:
    """Running average -> (H,W,3) uint8 frame; sendImageToPBO semantics
    (src/pathtrace.cu:48-68): trunc(pix/iter*255) clamped to [0,255]."""
    resx, resy = resolution
    scale = float(np.float32(255.0) / np.float32(max(iteration, 1)))

    def chan(c):
        return torch.clamp((c * scale).to(torch.int32), 0, 255).to(torch.uint8)

    img = torch.stack([chan(accum.x), chan(accum.y), chan(accum.z)], dim=-1)
    return img.reshape(resy, resx, 3)


def log_plain(settings: RenderSettings, devices) -> None:
    """Say in the log when `settings.plain` keeps the kernels off the
    card: the plain PyTorch versions render there (--no-pallas)."""
    cards = sorted({str(d) for d in devices if d.type == "cuda"})
    if settings.plain and cards:
        log.info("--no-pallas: the plain PyTorch versions render on %s; no "
                 "kernel is launched", ", ".join(cards))


def resolve_device(device) -> torch.device:
    """The device a Renderer runs on. CUDA must be present when asked
    for: nothing drifts to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to render with the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


class Renderer:
    """Progressive renderer: owns the accumulator, iteration count,
    camera state and first-bounce cache. Camera changes reset the
    iteration to 0 and clear the accumulator and the cache
    (reset-on-camera-change, src/main.cpp:102-128).

    Runs on the card unless `device="cpu"` is asked for."""

    def __init__(self, scene: Scene, settings: RenderSettings | None = None,
                 *, device="cuda"):
        self.device = resolve_device(device)
        self.scene = scene
        self.settings = settings or RenderSettings(
            trace_depth=scene.state.trace_depth or 8
        )
        if self.settings.trace_depth <= 0:
            self.settings = replace(self.settings, trace_depth=8)
        # always with the BVH, which the mesh kernels walk (models/device.py)
        self.dev_scene = scene_to_device(scene, self.device)
        self.tables = _device_tables(self.dev_scene, self.settings)
        log_plain(self.settings, [self.device])
        self.camera = scene.state.camera
        self.dev_camera = camera_to_device(self.camera, self.device)
        self.start_time_string = image_io.current_time_string()
        self._reset_buffers()

    # -- state management -------------------------------------------------
    def _reset_buffers(self):
        P = self.camera.pixel_count
        self.accum = Vec3.zeros(P, self.device)
        self.cache = _empty_cache(P, self.device)
        self.cache_valid = False
        self.iteration = 0
        self.last_alive_counts = None

    def set_camera(self, camera):
        """Any camera change resets progressive state."""
        self.camera = camera
        self.dev_camera = camera_to_device(camera, self.device)
        self._reset_buffers()

    def orbit_camera(self, dphi=0.0, dtheta=0.0, dzoom=0.0, look_at=None):
        """Spherical-coordinate orbit controls (src/main.cpp:149-205):
        derive phi/theta/zoom from the current camera, apply deltas,
        rebuild the basis like runCuda (src/main.cpp:102-120)."""
        cam = self.camera
        la = np.asarray(look_at if look_at is not None else cam.look_at, np.float32)
        offset = cam.position - la
        zoom = float(np.linalg.norm(offset))
        view = (la - cam.position) / max(zoom, 1e-9)
        view_xz = np.array([view[0], 0.0, view[2]])
        view_zy = np.array([0.0, view[1], view[2]])
        nxz = np.linalg.norm(view_xz)
        nzy = np.linalg.norm(view_zy)
        phi = float(np.arccos(np.clip(np.dot(view_xz / max(nxz, 1e-9), [0, 0, -1]), -1, 1)))
        if view[0] > 0:
            phi = -phi
        theta = float(np.arccos(np.clip(np.dot(view_zy / max(nzy, 1e-9), [0, 1, 0]), -1, 1)))

        phi += dphi
        theta = float(np.clip(theta + dtheta, 0.001, np.pi - 0.001))
        zoom = max(0.1, zoom + dzoom)

        pos = zoom * np.array(
            [np.sin(phi) * np.sin(theta), np.cos(theta), np.cos(phi) * np.sin(theta)],
            np.float32,
        )
        self.set_camera(derive_camera(
            cam.resolution,
            pos + la,
            la,
            np.array([0, 1, 0], np.float32),
            float(cam.fov[1]),
            cam.aperture,
            cam.focal_distance,
        ))

    def pan_camera(self, dx: float = 0.0, dy: float = 0.0):
        """Pan the look-at point in the ground plane (the reference's
        MMB drag, src/main.cpp:191-202): the camera translates with its
        target, phi/theta/zoom unchanged."""
        cam = self.camera
        fwd = np.array([cam.view[0], 0.0, cam.view[2]], np.float32)
        rgt = np.array([cam.right[0], 0.0, cam.right[2]], np.float32)
        fwd /= max(float(np.linalg.norm(fwd)), 1e-9)
        rgt /= max(float(np.linalg.norm(rgt)), 1e-9)
        delta = (-dx * rgt + dy * fwd).astype(np.float32)
        self.set_camera(derive_camera(
            cam.resolution,
            cam.position + delta,
            cam.look_at + delta,
            np.array([0, 1, 0], np.float32),
            float(cam.fov[1]),
            cam.aperture,
            cam.focal_distance,
        ))

    # -- rendering ---------------------------------------------------------
    def step(self) -> int:
        """Render one sample per pixel (one `pathtrace()` call) through
        the per-bounce path (under --nee: kernel #5 once per depth);
        fills `last_alive_counts` (live paths after each depth, on the
        device) and, on the first step with an effective first-bounce
        cache, the cache."""
        self.iteration += 1
        # trust the cache only once a step has filled it: after
        # load_checkpoint (or a reset) it is zeros, and zeros read as
        # "every ray missed"
        use_cache = self.settings.effective_cache() and self.cache_valid
        _, cache_out, alive = render_iteration(
            self.dev_scene, self.dev_camera, self.accum, self.iteration,
            self.cache, self.settings, use_cache, tables=self.tables,
        )
        if self.settings.effective_cache() and not self.cache_valid:
            self.cache = cache_out
            self.cache_valid = True
        self.last_alive_counts = alive
        return self.iteration

    def step_batch(self, n: int) -> int:
        """Render n samples per pixel (see render_batch); the accumulator
        stays on the device."""
        if n <= 0:
            return self.iteration
        render_batch(self.dev_scene, self.dev_camera, self.accum,
                     self.iteration + 1, n, self.settings, tables=self.tables)
        self.iteration += n
        return self.iteration

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, iterations: int | None = None, progress_every: int = 0):
        """Step until `iterations` (the scene's ITERATIONS by default),
        yielding the iteration count every `progress_every` steps."""
        target = iterations if iterations is not None else self.scene.state.iterations
        while self.iteration < target:
            self.step()
            if progress_every and self.iteration % progress_every == 0:
                self._sync()
                yield self.iteration
        self._sync()

    def render(self, iterations: int | None = None) -> np.ndarray:
        for _ in self.run(iterations):
            pass
        return self.image()

    # -- output -------------------------------------------------------------
    def image(self) -> np.ndarray:
        """(H,W,3) float radiance accumulator on host."""
        resx, resy = self.camera.resolution
        chans = [c.detach().cpu().numpy().reshape(resy, resx) for c in self.accum]
        return np.stack(chans, axis=-1)

    def frame_uint8(self) -> np.ndarray:
        """Tonemapped preview frame (H,W,3) uint8."""
        return tonemap(
            self.accum, self.iteration, self.camera.resolution
        ).cpu().numpy()

    def save(self, out_dir: str = ".", hdr: bool = False) -> str:
        return image_io.save_render(
            self.image(),
            self.iteration,
            self.scene.state.image_name,
            self.start_time_string,
            hdr=hdr,
            out_dir=out_dir,
        )

    # -- checkpoint/resume --------------------------------------------------
    def save_checkpoint(self, path: str) -> str:
        np.savez_compressed(
            path,
            accum=self.image(),
            iteration=self.iteration,
            resolution=np.array(self.camera.resolution),
        )
        return path

    def load_checkpoint(self, path: str):
        data = np.load(path)
        if tuple(data["resolution"]) != tuple(self.camera.resolution):
            raise ValueError("checkpoint resolution mismatch")
        img = np.asarray(data["accum"], np.float32)
        self.accum = Vec3(*(
            torch.tensor(img[..., c].reshape(-1), device=self.device)
            for c in range(3)
        ))
        self.iteration = int(data["iteration"])
        # the checkpoint holds no depth-0 intersections: the next step()
        # recomputes and re-validates the cache
        self.cache = _empty_cache(self.camera.pixel_count, self.device)
        self.cache_valid = False
