"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, in parallel), prints the registers, shared memory and
stack frames of A, B, C, #1, #2, #3, #7, #8, #5, #6 and the radix kernels
(`nvcc -Xptxas -v`) and #2's sweep instructions per lane read from its
SASS beside its bound (`first_bounce_sass`), holds #2's paired division
bit for bit against IEEE division for every float divisor
(`div_pair_exhaustive`), holds each of the seventeen against its plain PyTorch version on
the card (at 64x64 and at the main path's 800x800; #1 on nine configs at 64x64 and 37x23, bit for
bit against the per-bounce kernels #2 -> #3 and on all but 0.1% of the
pixels against its plain version; the NEE kernels #5 and #6 on Cornell
AA, Cornell RR + stratified, a glossy Cornell and many_materials RR, #5's
pix exactly and its alive per lane, #6 over one iteration and over a
run of iterations in one call (32 at 64x64 and at the main NEE path's
800x800, 4 on the other 800x800 configs) against the plain iterations
summed in order, and #6 bit for bit against the #5 route on every pixel
whose camera ray the plain raygen reproduces (`nee_route_bits`, with a
probe of the kernels' raygen built beside them; also on many_materials
1920x1080 RR); the mesh kernels #7-#10 on mesh.txt plain, AA, RR +
stratified and --compact, #7's candidate set per lane and #9's pix
exactly; the big-mesh route's A-D (super_keys, place_entries,
window_sweep, merge_entries) on mesh_big.txt AA at 64x64 and 800x800 at
every depth and on bunny.txt at 800x800 depth 0, A's keys and B's stream
per key exactly, and the route's work per depth for their bounds; at
the same depths the radix route of PT_TPU_SORT_RADIX=1 (radix_split,
radix_unscatter and C's stream-order instantiation window_sweep_stream):
the compaction split (keys, rays, entry ids, length, digit histograms),
each 8-bit pass and a one-bit pass and the unscatter exactly, the sorted
stream against a stable torch.sort gather, the unsort's round trip, and
the route's entries, lanes and whole bounce against the counting route's,
bit for bit, with the split's tiles and look-back steps per depth
(`radix_work`); on mesh_big 800x800 C alone over the window part and the
tail part of each depth's stream; the surface stage's twins of #1-#6 and
#9 (the `instantiations on TexTables: file textures, bump maps, the lat-long env map,
SSS) at 64x64 and 800x800 on textured, envmap and cornell_sss (#1 by the
image rule and bit for bit against #2 -> #3, #2-#4, and #5/#6 by the NEE
rule on textured and cornell_sss) and on mesh_textured (#7-#10 with the
quad's OBJ UVs, #4 over its cache)); the NEE kernels' mesh
instantiations (`@mesh` on MeshOf<Tables>, `@mesh_surface` on
MeshOf<TexTables>: each lane's stackless walks of every mesh geom's
binary BVH for the hit and the shadow ray)
by the NEE rule on mesh.txt at 64x64 and 800x800 AA, mesh_textured at
64x64 and 800x800 (depth 4), mesh_big at 64x64 and 800x800 (depth 4),
mesh_stream at 128x128 (depth 4), mesh_critter at 128x128 (depth 2) and
mesh.txt over a chain BVH deeper than wide depth 64 (`chain_bvh`) at
64x64 (depth 2), #6 over one iteration, #5's pix exactly and its alive per lane, and #6 bit for bit
against the #5 route on mesh.txt (`nee_route_bits`); renders mesh.txt and
mesh_big.txt --nee at 128x128 through `step_batch` and `step()`, and
mesh.txt with its icosphere moving under --nee --motion-blur through
`step_batch` (#5 on the re-packed tables), against the plain path's
iteration by the golden rule (`mesh_nee_render`), renders the seventeen smoke configs
(the three --nee ones, mesh.txt and the five surface-stage ones included)
and the four big-mesh scenes (mesh_big, bunny,
mesh_critter, mesh_stream, each loaded once) against the XLA goldens
(tools/goldens/smoke_128.npz) through `Renderer.step_batch` and through
`Renderer.step()`, and the four again under the radix route through
`step_batch` (mesh_big through `step()` too): all 21 configs of
tools/smoke_pallas.py; holds the material sort (--sort-materials) at
every depth of an iteration on Cornell, many_materials, mesh.txt and
mesh_big at 64x64 and 800x800 (`material_sort_check`: per depth one #7,
one #10, #8 and A-D on the meshes, one radix_split digit pass and one
#4; the sorted pool and hits exactly those of a stable torch.sort of the
keys; #7 -> #10 on the analytic scenes against plain intersect_scene; #4
on the sorted pool bit for bit the sorted #4 output) and renders the 18
configs without --nee under it against their goldens through
`step_batch` and `step()`; drives the main path
(Cornell 800x800, depth 8, AA,
progressive) through `Renderer.step_batch` and times it, drives and
times the other paths at their scenes' own size, depth 8 (Cornell AA
through `Renderer.step()`, --compact, --cache-first-bounce,
--motion-blur, --direct-lighting, --nee through `step_batch` (#6) and
`step()` (#5), many_materials 1920x1080 RR --nee through both; mesh.txt
AA through `step_batch` and `step()` (#7 -> #8 -> #9 at every depth),
with --cache-first-bounce (#7 -> #8 -> #10 once per batch, then #4) and
with --direct-lighting (the final step's two intersects through #7 -> #8
-> #10); mesh_big.txt AA through `step_batch` and `step()` and bunny.txt
AA through `step_batch` (#7 -> #8 -> A -> B -> C -> D -> #9 at every
depth); mesh_big.txt and bunny.txt AA through `step_batch` under the
radix route (#7 -> #8 -> A -> the compaction split and one 8-bit pass
-> C in stream order -> one unscatter -> D -> #9); the surface stage's
cells at 800x800 d8 AA: textured, envmap and cornell_sss through
`step_batch` (#1's twin), mesh_textured through `step_batch` (#9's), and
textured through `step()` (#2's and #3's), under the cache (#4's) and
under --nee through both (#6's and #5's); --nee on mesh scenes: (aa)
mesh.txt through `step_batch` (#6 on MeshOf), (ab) through `step()` (#5),
(ac) mesh_big.txt through `step_batch`, and mesh_textured through both,
with the instantiations' plain times, bounds (the plain path's masks and
the nodes and triangles of the kernels' own walks, `binary_walk_work`;
(ac)'s too) and ptxas usage on the `mesh_nee` line), holds sharding (`parallel/shard.py`, both shards on
the one card: `shard_phase`, in a process of its own) -- Cornell 800x800 d8 AA under spp=2 (#2 ->
#3 per shard, against Renderer.step() at the same samples, rtol 1e-6)
and px=2 (#3 from each slice's camera rays, exactly the whole frame
through the same route), the tri-shard tier on mesh.txt and mesh_big
800x800 AA at every depth of one iteration and mesh_textured at two
(each shard's #7 -> #8 [-> A-D] -> #10 and one #4 a depth, nothing else;
the merged hits against the plain merge of the plain per-slice chains
and against the unsharded kernels, the lanes that differ in any bit
counted; #4 on the merged pool against its plain version; the merge's
device ms), the goldens of Cornell spp=2 and px=2 and mesh.txt and
mesh_big tri=2 at 128x128, and times the cells (ak) spp=2, (al) px=2,
(am) mesh.txt tri=2 and (an) mesh_big tri=2 through `step_batch`
(`shard_cell` lines; `<wrapper>@tri` in the kernels line: each shard's
#7, #8, #10 and #4 on the merged pool on (am)), the sorted cells (af) Cornell, (ag) many_materials
1920x1080 RR, (ah) mesh.txt, (ai) mesh_big and (aj) Cornell --compact
under --sort-materials through `step_batch`, with the sort's own device
ms a depth beside one stable torch.sort of the same keys and the
gathers' (`material_sort_cells`), times the dense BVH
walk on mesh_big as a yardstick (the routing threshold raised here only), reads each kernel's
device time from torch.profiler beside its plain version's time (for
#1 and #6 over the same run of iterations as the kernel's launch), its
bound and, where one PyTorch call computes the same function, that
call's time (and the --direct-lighting final step's own time), and
renders through the CLI (Cornell plain, --compact, --nee,
--sort-materials and --stats --profile DIR, whose stages and Chrome trace
it checks; mesh.txt, also --nee and --sort-materials; mesh_big.txt, and
again with PT_TPU_SORT_RADIX=1; the ten processes at once). Each phase
line ends with its seconds since the start (`at_s`). It also times #1 at
1x, 2x and 4x the main path's pixels, prints #1's lane use with one
thread per pixel (from the plain path lengths), #6's lane use with one
thread per pixel against its persistent warps' model and #5's
warp-slots against its live lanes per depth, on Cornell and on
many_materials 1920x1080 RR --nee (from the plain NEE path's masks), the
two kernels' device times, launches and bounds on the four NEE paths,
and #8's work per walk on its wide tables beside the binary walk's, with
the lanes on which the two walks' winners differ. Every path's line also
gives its device events per iteration and per depth, on the mesh and
big-mesh paths #7's and #9's device ms at each depth and on the
per-bounce paths #3's; #3's line per depth sets them beside the live
lanes and the warps that hold one (`bounce_step_depths`), A's on mesh_big
and bunny beside its listed lanes (`super_keys_depths`), #9's on
mesh.txt, mesh_big and bunny beside its live lanes, the warps and
sectors that hold one and its candidates (`bounce_step_mesh_depths`)
and D's on mesh_big and bunny beside its listed lanes, real entries and
hits (`merge_entries_depths`); the last two also hold #9 and D against
their plain versions at every depth of an iteration driven by the
kernels. The surface stage's twins
get their plain versions' times and bounds at those cells' shapes
(`surface_stage`, `surface_work`) and lines of their own in the kernels
line (`<wrapper>@surface`). With `--sass-other DIR` (another checkout)
it also holds every kernel function both trees have to the same SASS
(tools/torch_sass_diff.py). Every path is driven
with the launch counts set to 0 just before it and read just after.
Last (`last_modules_phase`), the modules ported last: --no-pallas
(the plain versions on the card, no launch counted) on cornell, mesh.txt,
textured and cornell --nee at 128x128 against the goldens and the kernel
path; `validate_tables` on the 21 configs; --debug and --debug-nans (each
launch checked, each stage's outputs scanned for NaN) on runs that
launch every wrapper, clean, and a planted NaN named with its kernel; a
texture resampled from 300x200 and a .hdr env map through #1 on
TexTables against its plain version at 64x64 and 800x800; the viewer's
frame loop; the CLI's --debug, --debug-nans, --no-pallas and --preview
(Agg); and the modes' cost on the main cell and on (a) (`modes_cost`).
Every phase prints one line; any failure raises and exits non-zero
before the result lines are printed. Imports nothing of JAX or of the
JAX package.

The last three lines are the card's name and power limit (nvidia-smi),
one JSON object describing each kernel, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "project3_cuda_path_tracer_tpu_torch"
JAX_MK = "project3_cuda_path_tracer_tpu/ops/megakernel.py"
JAX_PL = "project3_cuda_path_tracer_tpu/ops/pipeline.py"
KERNELS = {  # wrapper -> (source, the TPU kernel it replaces)
    "full_iteration": (f"{PKG}/csrc/full_iteration.cu", f"{JAX_MK}:2848"),
    "first_bounce": (f"{PKG}/csrc/bounce.cu", f"{JAX_MK}:2728"),
    "bounce_step": (f"{PKG}/csrc/bounce.cu", f"{JAX_MK}:2125"),
    "shade_step": (f"{PKG}/csrc/bounce.cu", f"{JAX_MK}:2285"),
    "full_iteration_nee": (f"{PKG}/csrc/nee.cu", f"{JAX_MK}:2991"),
    "bounce_step_nee": (f"{PKG}/csrc/nee.cu", f"{JAX_MK}:2553"),
    # the mesh pipeline (ops/pipeline.py): K1 and K2 of _intersect_phase
    # (their pallas_call lines), the two K3s (their functions)
    "mesh_candidates": (f"{PKG}/csrc/mesh.cu", f"{JAX_PL}:2322"),
    "mesh_sweep": (f"{PKG}/csrc/mesh.cu", f"{JAX_PL}:2549"),
    "bounce_step_mesh": (f"{PKG}/csrc/mesh.cu", f"{JAX_PL}:2650"),
    "intersect_mesh": (f"{PKG}/csrc/mesh.cu", f"{JAX_PL}:2844"),
    # the big-mesh route (ops/pipeline.py's sorted route, csrc/sorted.cu):
    # A replaces _super_rank_xla and the counting half of #12 _kc_compact,
    # B #12's packing and #13 _ks_stitch, C #11 _window_sweep, D #14
    # _kx_expand (their functions)
    "super_keys": (f"{PKG}/csrc/sorted.cu", f"{JAX_PL}:1203"),
    "place_entries": (f"{PKG}/csrc/sorted.cu", f"{JAX_PL}:1257"),
    "window_sweep": (f"{PKG}/csrc/sorted.cu", f"{JAX_PL}:746"),
    "merge_entries": (f"{PKG}/csrc/sorted.cu", f"{JAX_PL}:1350"),
    # the radix route (PT_TPU_SORT_RADIX=1, csrc/radix.cu): the split,
    # #15 _kr_partition with #16 _kr_stitch2 (:1479) in one single-pass
    # launch; the unscatter, #17 _kr_unpartition; and C's stream-order
    # instantiation (#11 on the radix branch)
    "radix_split": (f"{PKG}/csrc/radix.cu", f"{JAX_PL}:1433"),
    "radix_unscatter": (f"{PKG}/csrc/radix.cu", f"{JAX_PL}:1578"),
    "window_sweep_stream": (f"{PKG}/csrc/sorted.cu", f"{JAX_PL}:746"),
}
SORTED_KERNELS = ("super_keys", "place_entries", "window_sweep",
                  "merge_entries")
RADIX_KERNELS = ("radix_split", "radix_unscatter", "window_sweep_stream")
MESH_KERNELS = ("mesh_candidates", "mesh_sweep", "bounce_step_mesh",
                "intersect_mesh") + SORTED_KERNELS + RADIX_KERNELS
# each kernel's symbol in the profiler's (demangled or mangled) names: the
# kernels of #1-#6 and #9 are templates on their tables, their
# instantiation on TexTables (the surface stage) counted apart; C's two
# instantiations by their template argument
KERNEL_SYMBOLS = {k: re.compile(re.escape(f"{k}_kernel") + "(?!.*(TexTables|MeshOf))")
                  for k in KERNELS}
KERNEL_SYMBOLS["window_sweep"] = re.compile(r"window_sweep_kernel(<false>|ILb0E)")
KERNEL_SYMBOLS["window_sweep_stream"] = re.compile(r"window_sweep_kernel(<true>|ILb1E)")
# the split's two instantiations, timed apart beside the wrapper's mean
KERNEL_SYMBOLS["radix_split@compaction"] = re.compile(r"radix_split_kernel(<true>|ILb1E)")
KERNEL_SYMBOLS["radix_split@pass"] = re.compile(r"radix_split_kernel(<false>|ILb0E)")
# the surface stage (file textures, bump maps, the lat-long env map, SSS):
# the instantiations on TexTables of #1-#6 and #9 in the kernels line, each
# with its wrapper (whose launches count it on a surface scene) and the
# path of phase 6 that times it
SURFACE_KERNELS = {
    "full_iteration@surface": ("full_iteration", "textured"),
    "first_bounce@surface": ("first_bounce", "textured_step"),
    "bounce_step@surface": ("bounce_step", "textured_step"),
    "shade_step@surface": ("shade_step", "textured_cache"),
    "full_iteration_nee@surface": ("full_iteration_nee", "textured_nee"),
    "bounce_step_nee@surface": ("bounce_step_nee", "textured_nee_step"),
    "bounce_step_mesh@surface": ("bounce_step_mesh", "mesh_textured"),
}
KERNEL_SYMBOLS.update({k: re.compile(re.escape(f"{w}_kernel") + "(?!.*MeshOf).*TexTables")
                       for k, (w, _) in SURFACE_KERNELS.items()})
# --nee on mesh scenes: #5's and #6's instantiations on MeshOf<Tables>
# (`@mesh`) and MeshOf<TexTables> (`@mesh_surface`), which walk each mesh
# geom's binary BVH for the hit and the shadow ray, each with its wrapper
# and the path of phase 6 that times it
MESH_NEE_KERNELS = {
    "full_iteration_nee@mesh": ("full_iteration_nee", "mesh_nee"),
    "bounce_step_nee@mesh": ("bounce_step_nee", "mesh_nee_step"),
    "full_iteration_nee@mesh_surface": ("full_iteration_nee", "mesh_textured_nee"),
    "bounce_step_nee@mesh_surface": ("bounce_step_nee", "mesh_textured_nee_step"),
}
KERNEL_SYMBOLS.update({
    k: re.compile(re.escape(f"{w}_kernel") + (r".*MeshOf.*TexTables" if "surface" in k
                                               else r".*MeshOf(?!.*TexTables)"))
    for k, (w, _) in MESH_NEE_KERNELS.items()})
# the material sort (--sort-materials): radix_split's digit pass by
# material over the slot iota, timed on (af), its library call a stable
# torch.sort of the same keys
SORT_KERNELS = {"radix_split@material": ("radix_split", "sort_cornell")}
KERNEL_SYMBOLS["radix_split@material"] = KERNEL_SYMBOLS["radix_split@pass"]
NO_LAUNCHES = {k: 0 for k in KERNELS}
# image rule of tests/test_megakernel.py:143-145 (seam-tie outliers only)
PARITY_BAD = 1e-3
PARITY_FRAC = 0.02
PARITY_MEDIAN = 1e-5
# tools/smoke_pallas.py's golden rule
GOLDEN_BAD = 0.05
GOLDEN_FRAC = 0.04
SMOKE = [  # (scene, settings, golden key)
    ("cornell.txt", {}, "cornell.txt"),
    ("sphere.txt", {}, "sphere.txt"),
    ("cornell_glass.txt", {"russian_roulette": True}, "cornell_glass.txt"),
    ("cornell_dof.txt", {"antialias": True, "depth_of_field": True},
     "cornell_dof.txt"),
    ("env.txt", {}, "env.txt"),
    ("many_materials.txt", {"russian_roulette": True}, "many_materials.txt"),
    ("checker.txt", {}, "checker.txt"),
    ("cornell.txt", {"stratified": True}, "cornell.txt_--stratified"),
    ("cornell.txt", {"sobol": True}, "cornell.txt_--sobol"),
    ("cornell.txt", {"nee_mis": True}, "cornell.txt_--nee"),
    ("many_materials.txt", {"nee_mis": True, "russian_roulette": True},
     "many_materials.txt_--nee"),
    ("mesh.txt", {}, "mesh.txt"),
    # the surface stage's five
    ("cornell_sss.txt", {}, "cornell_sss.txt"),
    ("textured.txt", {}, "textured.txt"),
    ("textured.txt", {"nee_mis": True}, "textured.txt_--nee"),
    ("envmap.txt", {}, "envmap.txt"),
    ("mesh_textured.txt", {}, "mesh_textured.txt"),
]
# the scenes of the big-mesh route (one geom above 16,384 triangles each),
# loaded once (their BVH build is most of their cost) and rendered against
# their goldens with the smoke settings ({}, depth 8)
BIG_SCENES = ("mesh_big.txt", "bunny.txt", "mesh_critter.txt",
              "mesh_stream.txt")
# image rule of tests/test_nee_megakernel.py for the NEE kernels
NEE_PARITY_FRAC = 0.03
# #6's run of iterations against the plain ones at 800x800 (a run of
# ITERATIONS_PER_LAUNCH is held at 64x64, and at the main NEE path's
# 800x800 where its plain time is taken)
NEE_RUN_800 = 4
# the depth of that run at 64x64 on every NEE config but the first (its
# plain iterations, summed in order, set the cost)
NEE_RUN_DEPTH = 4
# lane rule of tests/test_megakernel.py:57-76 for alive: at most 1% of
# lanes may differ (seam ties, RR draws at p_survive); pix exactly
ALIVE_FRAC = 0.01
NEE_PARITY = [  # (scene, settings, glossy sphere)
    ("cornell.txt", {"antialias": True}, False),
    ("cornell.txt", {"russian_roulette": True, "stratified": True}, False),
    ("cornell.txt", {"antialias": True}, True),
    ("many_materials.txt", {"russian_roulette": True}, False),
]
FULL_PARITY = [
    ("cornell.txt", {"antialias": True}),
    ("cornell_glass.txt", {"russian_roulette": True}),
    ("cornell_dof.txt", {"antialias": True, "depth_of_field": True}),
    ("many_materials.txt", {"russian_roulette": True}),
    ("checker.txt", {}),
    ("cornell.txt", {"stratified": True}),
    ("cornell.txt", {"sobol": True}),
    ("env.txt", {}),
    ("cornell_glass.txt", {"russian_roulette": True, "antialias": True}),
]
# #1 is bit-identical to its plain version but on at most this share of
# the pixels: the handful on which a float op of the kernel and its torch
# counterpart round an ulp apart and a lottery flips (the per-bounce
# kernels #2 -> #3, bit-identical to #1, differ on the same pixels)
FULL_BITS_OFF = 0.001
BOUNCE_PARITY = [
    ("cornell.txt", {"antialias": True}),
    ("cornell_glass.txt", {"russian_roulette": True, "rr_start_depth": 1}),
    ("checker.txt", {"sobol": True}),
    ("cornell.txt", {"stratified": True, "compact": True}),
]
# the mesh kernels on mesh.txt, each against its plain version, with the
# lane rule of tests/test_megakernel.py:57-76 (at most 1% of lanes off by
# more than 1e-4), #7's candidate set per lane (at most 0.1% of lanes
# differ) and pix exactly
MESH_PARITY = [
    {},
    {"antialias": True},
    {"russian_roulette": True, "stratified": True},
    {"compact": True},
]
# their depths at 800x800 (the plain walks, one launch sequence per node
# step of the slowest lane, set the phase's time; all 8 at 64x64)
MESH_PARITY_DEPTH_800 = 4
LANE_ATOL = 1e-4
LANE_FRAC = 0.01
ISECT_NORMAL_ATOL = 1e-3
CAND_FRAC = 0.001
# the surface stage's twins against their plain versions, at 64x64 and
# 800x800: #1 (the image rule, bit for bit against #2 -> #3), #2, #3, #4
# on the analytic scenes; #5 and #6 (the NEE rule) on the lit ones; #7-#10
# on mesh_textured (its quad's OBJ UVs), and #4 over its cache
SURFACE_PARITY = [
    ("textured.txt", {"antialias": True}),
    ("envmap.txt", {}),
    ("cornell_sss.txt", {"russian_roulette": True, "rr_start_depth": 1}),
]
SURFACE_NEE = [("textured.txt", {"antialias": True}),
               ("cornell_sss.txt", {"russian_roulette": True})]
SURFACE_MESH = [{}, {"antialias": True}]
# the NEE kernels' mesh instantiations against their plain versions (the
# NEE rule; #6 over one iteration): (scene, resolution, depth), AA; the
# big meshes at depth 4 (their plain BVH walks take nearly as many
# lock-step node steps a depth at 64x64 as at 800x800); mesh_critter's
# tree is the repo's deepest scene tree; "mesh.txt#chain" is mesh.txt with
# its icosphere's BVH a chain over MESH_CHAIN_TRIS triangles (`chain_bvh`:
# 909 binary nodes, wide depth 65, past the depth 64 that a walk with a
# stack in a block's shared memory could hold; at depth 2: its plain walks
# step through the chain in lock-step)
MESH_CHAIN_TRIS = 1820
MESH_NEE_PARITY = [("mesh.txt", (64, 64), 8), ("mesh.txt#chain", (64, 64), 2),
                   ("mesh.txt", (800, 800), 8),
                   ("mesh_textured.txt", (64, 64), 8), ("mesh_textured.txt", (800, 800), 4),
                   ("mesh_big.txt", (64, 64), 4), ("mesh_big.txt", (800, 800), 4),
                   ("mesh_stream.txt", (128, 128), 4), ("mesh_critter.txt", (128, 128), 2)]
# iterations of #6's profiled launch on the mesh --nee paths (its plain
# version, whose BVH walks take one launch sequence per node step, is
# timed over the same)
MESH_NEE_RUN = 2
# iterations in #1's and #6's profiled launch on the surface paths (the
# plain versions are timed over the same)
SURFACE_RUN = 8

# ---- the bound: the least time the card could take for a call ----
# H100 SXM peaks (NVIDIA's data sheet, at a 700 W limit): HBM 3.35 TB/s,
# 67 TFLOP/s float32 outside the tensor cores. Every ALU operation
# (float or the RNG's integer ones) is counted against the float32 peak,
# which only lowers the bound.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# operations per lane, counted from csrc/path_common.cuh (a division,
# sqrt or rsqrt as 1; sinf, cosf, powf as 20 each)
OPS_BOX_TEST = 107  # box_test without the normal
OPS_SPHERE_TEST = 99  # sphere_test without the normal
OPS_NORMAL = 130  # the winner's test again, with its normal
OPS_SHADE = 220  # seed + 2 minstd draws, cosine hemisphere, reflect, tint
OPS_RAYGEN = 35  # pinhole direction and normalize
OPS_RAYGEN_AA = 135  # + seed, 4 draws and the jitter
OPS_DRAW = 12  # one minstd draw and its scale to [0, 1)
# #2 without depth of field: every lane's ray starts at the camera, so
# these are once per geom and launch, not per lane
OPS_ORIGIN = 24  # per analytic geom: the origin's object-space transform
#                  and the box's six slab numerators or the sphere's
#                  |ro|^2 - 1/4
OPS_WINNER_NORMAL = 30  # the winner's normal from the object-space part
#                         its test kept: the face select, a transform, a
#                         normalize (OPS_NORMAL tests the winner again)
# the NEE kernels (shade_nee), each charged only to the lanes that do it
# in this run's data (nee_work); the emissive hit's MIS weight and the
# glossy lobe's powf are left out, which only lowers the bound:
OPS_LIGHT = 180  # NEE-able lane: seed + 3 draws, a cube-face sample,
#                  two transforms, Le
OPS_TO_LIGHT = 29  # NEE-able lane: to-light vector, r, wi, both cosines
OPS_MIS = 30  # unoccluded light: geometry term, the BRDF mix, contribution
OPS_W_LIGHT = 13  # the same, below the last depth: both pdfs, w_light
OPS_NEXT_PDF = 29  # scattered lane: mirror direction, next pdf, mirror pick
# the mesh kernels (csrc/mesh.cu), each charged only to the lanes that do
# it in this run's data (mesh_work), the walk's nodes and triangles from
# the plain walk's own probe (pipeline.mesh_sweep_reference(probe=...)):
OPS_CANDIDACY = 94  # per lane and mesh geom: ray to object space (two
#                     transforms, normalize, 3 reciprocals), the bound
#                     (Frobenius norm), the root box's slab test
OPS_APPEND = 5  # candidate lane: the ballot share of one list append
OPS_NODE = 30  # per node visited: the slab test and the step
OPS_MT = 64  # per triangle tested: Moller-Trumbore and the min-t update
OPS_MESH_HIT = 100  # per walk that hits: normal, UVs, world distance
OPS_MERGE = 4  # per lane: the analytic/mesh merge of #9 and #10
OPS_WORLD_DIST = 36  # #5's and #6's shadow walks, per triangle hit below the
#                      bound: the object point, a transform, the distance
# the surface stage (csrc/path_common.cuh `surface`, `env_fetch`), each
# charged only to the lanes that take it in this run's data (surface_ops)
OPS_FILE_TEX = 40  # a file-textured hit: its UVs, four taps' addresses, the blend
OPS_BUMP = 50  # a bump-mapped hit: three taps, the differences, the tilted normal
OPS_ENV_FETCH = 45  # an escape to the env map: atan2f and acosf (20 each), the texel
# a shadow ray costs one normal-free test (OPS_BOX_TEST / OPS_SPHERE_TEST)
# per geom up to and including its first occluder (shadow_sweep)
# the sorted route (csrc/sorted.cu), from its plain versions' counts
# (sorted_work): A per listed lane its object-space ray and bound, and one
# supernode slab test per supernode; C per entry one slab test per chunk
# box it tests and OPS_MT per triangle; D per listed lane the slot merge,
# per winner the epilogue (OPS_MESH_HIT)
OPS_OBJ_RAY = 69  # two transforms, normalize, 3 reciprocals, the bound
OPS_SUPER_TEST = 29  # slab test with te = max(tmin, 0), the key update
OPS_CHUNK_TEST = 27  # slab test against the running best t
OPS_SLOT = 3  # per slot of D's merge: load, compare, select
OPS_PLACE = 8  # B per real entry: the compare, the warp match, the address
OPS_RADIX = 12  # per element of a split: the digit, the warp match and
#                 rank, the place (csrc/radix.cu); bytes-bound
OPS_UNSCATTER = 2  # per entry of the unscatter: the id and the address


T0 = time.perf_counter()


def say(phase: str, **kv) -> None:
    """One phase's line, with the seconds since the script started."""
    print(f"[{phase}] " + json.dumps(dict(kv, at_s=round(time.perf_counter() - T0, 1))),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def small_scene(name: str, res, path=None):
    from project3_cuda_path_tracer_tpu_torch.models.scene import (
        derive_camera,
        load_scene,
    )

    s = load_scene(path or os.path.join(HERE, "scenes", name))
    c = s.state.camera
    s.state.camera = derive_camera(
        res, c.position, c.look_at, np.array([0, 1, 0], np.float32),
        float(c.fov[1]), c.aperture, c.focal_distance,
    )
    return s


def many_boxes_scene(path: str, n: int = 300, seed: int = 0) -> str:
    """Write Cornell with `n` small boxes added inside the room (random
    places, sizes, rotations and materials 1-4, from `seed`) to `path`:
    more geoms than #2 stages in one chunk. Returns `path`."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(HERE, "scenes", "cornell.txt")) as f:
        text = f.read().rstrip() + "\n"
    for k in range(n):
        x, y, z = rng.uniform((-4.5, 0.2, -4.5), (4.5, 9.5, 4.5))
        sx, sy, sz = rng.uniform(0.1, 0.6, 3)
        rx, ry, rz = rng.uniform(0.0, 90.0, 3)
        text += (f"\nOBJECT {7 + k}\ncube\nmaterial {int(rng.integers(1, 5))}\n"
                 f"TRANS {x:.4f} {y:.4f} {z:.4f}\nROTAT {rx:.2f} {ry:.2f} {rz:.2f}\n"
                 f"SCALE {sx:.4f} {sy:.4f} {sz:.4f}\n")
    with open(path, "w") as f:
        f.write(text)
    return path


def on_card(dev, name, settings_kw, res, depth=8, path=None, glossy=False):
    """(DeviceScene, DeviceCamera, RenderSettings) on the card; `glossy`
    gives material 4 (Cornell's mirror sphere) a Phong lobe, SPECEX 24."""
    from project3_cuda_path_tracer_tpu_torch.models.device import (
        camera_to_device,
        scene_to_device,
    )
    from project3_cuda_path_tracer_tpu_torch.render import RenderSettings

    scene = small_scene(name, res, path)
    if glossy:
        scene.materials.specular_exponent = scene.materials.specular_exponent.copy()
        scene.materials.specular_exponent[4] = 24.0
    return (scene_to_device(scene, dev),
            camera_to_device(scene.state.camera, dev),
            RenderSettings(trace_depth=depth, **settings_kw))


def compare(got, want):
    """(badfrac, median, max_abs_err) of two lists of tensors, over all
    their values; non-finite values fail."""
    g = np.concatenate([a.detach().float().cpu().numpy().ravel() for a in got])
    w = np.concatenate([a.detach().float().cpu().numpy().ravel() for a in want])
    if not (np.isfinite(g).all() and np.isfinite(w).all()):
        raise RuntimeError("non-finite values")
    diff = np.abs(g.astype(np.float64) - w.astype(np.float64))
    return float((diff > PARITY_BAD).mean()), float(np.median(diff)), float(diff.max())


def check_parity(kernel, what, frac, med, err, max_frac=PARITY_FRAC):
    say("parity", kernel=kernel, **what, badfrac=frac, median=med,
        max_abs_err=err,
        rule=f"frac(|d|>{PARITY_BAD})<{max_frac}, median<{PARITY_MEDIAN}")
    if not (frac < max_frac and med < PARITY_MEDIAN):
        raise RuntimeError(f"{kernel} disagrees with its plain version: {what}")


def full_nee_parity(dev, name, kw, res, glossy, iteration=3, n_iters=1, setup=None):
    """#6 against its plain version over `n_iters` iterations from
    `iteration`: one wrapper call (one launch per ITERATIONS_PER_LAUNCH
    iterations, each lane summing its pixel's iterations in a register)
    against the plain iterations summed in order; compare()'s numbers on
    the mean image (the sums over n_iters). `setup`: a (DeviceScene,
    DeviceCamera, RenderSettings) to use instead of loading `name`."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3

    ds, cam, settings = setup or on_card(dev, name, dict(kw, nee_mis=True), res,
                                         glossy=glossy)
    accum = Vec3.zeros(res[0] * res[1], dev)
    mk.full_iteration_nee(ds, cam, iteration, settings, accum, n_iters=n_iters,
                          tables=mk.pack_scene_tables(ds, nee=True))
    plain = plain_run(mk.full_iteration_nee_reference, ds, cam, iteration,
                      settings, n_iters)
    torch.cuda.synchronize()
    return compare([a / n_iters for a in accum], [a / n_iters for a in plain])


def plain_run(reference, ds, cam, iteration0, settings, n_iters):
    """The plain version of a whole-iteration kernel (#1 or #6) over
    iterations iteration0 .. iteration0 + n_iters - 1, each iteration's
    radiance added into a zeroed accumulator in order."""
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3

    acc = Vec3.zeros(cam.resolution[0] * cam.resolution[1], ds.device)
    for it in range(iteration0, iteration0 + n_iters):
        for a, r in zip(acc, reference(ds, cam, it, settings)):
            a.add_(r)
    return acc


# The camera rays of the kernels' raygen (csrc/path_common.cuh `raygen`,
# which #1, #2 and #6 inline), for `nee_route_bits`: a probe of this
# check, built beside the kernels from this checkout's header, and no
# kernel of the port.
RAYGEN_PROBE = r"""
#include "path_common.cuh"
__global__ void raygen_probe_kernel(const float* cam, int resx, int resy, int iteration,
                                    int flags, float* out) {
  const int n = resx * resy;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n) return;
  V3 o, d;
  raygen(cam, pix, resx, resy, iteration, flags, &o, &d);
  const float v[6] = {o.x, o.y, o.z, d.x, d.y, d.z};
  for (int k = 0; k < 6; ++k) out[k * n + pix] = v[k];
}
extern "C" int raygen_probe(const float* cam, int resx, int resy, int iteration, int flags,
                            float* out) {
  const int n = resx * resy;
  raygen_probe_kernel<<<(n + 127) / 128, 128>>>(cam, resx, resy, iteration, flags, out);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


# #2's paired division (csrc/path_common.cuh `div_pair`) against IEEE
# division (`/`) for every float divisor, each of the numerators given:
# per numerator pair and divisor bit pattern, both quotients' bits, and
# how many took div_pair's own path. A probe of this check, built beside
# the kernels from this checkout's header, and no kernel of the port.
DIV_PROBE = r"""
#include "path_common.cuh"
__global__ void div_probe_kernel(const float* nums, int n_pairs,
                                 unsigned long long* counts) {
  unsigned long long bad = 0, fast = 0;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned long long u = blockIdx.x * blockDim.x + threadIdx.x; u < (1ull << 32);
       u += stride) {
    const float d = __uint_as_float(static_cast<unsigned>(u));
    for (int k = 0; k < n_pairs; ++k) {
      const float lo = nums[2 * k], hi = nums[2 * k + 1];
      const bool ok = div_operand_ok(lo) && div_operand_ok(hi);
      float t1, t2;
      div_pair(lo, hi, d, ok, &t1, &t2);
      bad += (__float_as_uint(t1) != __float_as_uint(lo / d)) +
             (__float_as_uint(t2) != __float_as_uint(hi / d));
      fast += ok && div_operand_ok(d);
    }
  }
  atomicAdd(counts, bad);
  atomicAdd(counts + 1, fast);
}
extern "C" int div_probe(const float* nums, int n_pairs, unsigned long long* counts) {
  div_probe_kernel<<<132 * 16, 256>>>(nums, n_pairs, counts);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def build_probe(nvcc: str, out_dir: str, name: str, source: str):
    """Start nvcc on a probe's source with the build's flags; returns
    (the process, the library it writes)."""
    from project3_cuda_path_tracer_tpu_torch.ops import _native

    src = os.path.join(out_dir, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source)
    lib = os.path.join(out_dir, f"{name}.so")
    proc = subprocess.Popen([nvcc, *_native.NVCC_FLAGS, "-I", os.path.join(HERE, PKG, "csrc"),
                             "-o", lib, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, lib


def div_probe_numerators(n_pairs: int = 256, seed: int = 0):
    """Numerator pairs for DIV_PROBE: magnitudes log-uniform over
    2^-64..2^64 (div_pair's range and past it), random mantissas and signs,
    and some of each kind a slab numerator takes (+-1/2, 1/2 +- an ulp,
    zeros, the smallest and largest of the range)."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(1.0, 2.0, 2 * n_pairs) * np.exp2(rng.integers(-64, 65, 2 * n_pairs))
    nums = (m * rng.choice([-1.0, 1.0], 2 * n_pairs)).astype(np.float32)
    special = np.array([0.5, -0.5, np.nextafter(np.float32(0.5), np.float32(1)),
                        np.nextafter(np.float32(-0.5), np.float32(-1)), 0.0, -0.0,
                        2.0 ** -60, -(2.0 ** 60), 1.5, -1.5, 2.0 ** -61, 2.0 ** 61],
                       np.float32)
    nums[:special.size] = special
    return nums


def div_probe_check(dev, probe_build) -> dict:
    """Run DIV_PROBE over every float divisor; fails on any quotient whose
    bits differ from `/`'s."""
    import ctypes

    import torch

    proc, lib = probe_build
    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the division probe did not build: {err[-2000:]}")
    fn = ctypes.CDLL(lib).div_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nums = torch.from_numpy(div_probe_numerators()).to(dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    t0 = time.time()
    if fn(nums.data_ptr(), nums.numel() // 2, counts.data_ptr()) != 0:
        raise RuntimeError("the division probe failed")
    bad, fast = (int(c) for c in counts.cpu())
    out = dict(numerators=nums.numel(), divisors=2 ** 32, quotients=2 ** 32 * nums.numel(),
               pairs_on_div_pair_path=fast, quotients_differing=bad,
               seconds=time.time() - t0)
    if bad:
        raise RuntimeError(f"div_pair differs from IEEE division on {bad} quotients")
    return out


def load_raygen_probe(proc, lib: str):
    """The probe's C entry point, once its nvcc has finished."""
    import ctypes

    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the raygen probe did not build: {err[-2000:]}")
    fn = ctypes.CDLL(lib).raygen_probe
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nee_route_bits(dev, name, kw, res, glossy, probe, iteration=3, setup=None):
    """#6 (one iteration) bit for bit against the #5 route (plain
    generate_rays, then #5 at every depth: `Renderer.step()`'s trace) on
    every pixel whose camera ray generate_rays gives with the same bits as
    the kernels' raygen (the probe). #5 shades with `shade_nee`, #6 with
    its own split of it (csrc/nee.cu), so this holds the two copies of
    the estimator equal. Returns (share of pixels whose camera rays
    differ, share whose radiance differs); fails on any pixel with the
    same ray and other radiance bits, or when fewer than half the pixels
    have the same ray."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
    from project3_cuda_path_tracer_tpu_torch.render import _trace_nee

    ds, cam, settings = setup or on_card(dev, name, dict(kw, nee_mis=True), res,
                                         glossy=glossy)
    P = res[0] * res[1]
    rays = torch.empty(6, P, device=dev)
    cam_vec = mk.pack_camera(cam)
    torch.cuda.synchronize()
    if probe(cam_vec.data_ptr(), res[0], res[1], iteration, mk.kernel_flags(ds, settings),
             rays.data_ptr()) != 0:
        raise RuntimeError("the raygen probe failed")
    origins, dirs, _ = generate_rays(cam, iteration, settings.antialias,
                                     settings.depth_of_field)
    ray_off = (bitwise(rays) != bitwise(torch.stack([*origins, *dirs]))).any(0)
    acc = Vec3.zeros(P, dev)
    tables = mk.pack_scene_tables(ds, nee=True)
    mk.full_iteration_nee(ds, cam, iteration, settings, acc, tables=tables)
    radiance = _trace_nee(ds, cam, iteration, settings, tables, False)[0]
    torch.cuda.synchronize()
    off = torch.zeros(P, dtype=torch.bool, device=dev)
    for g, c in zip(acc, radiance):
        off |= bitwise(g) != bitwise(c)
    bad = int((off & ~ray_off).sum())
    if bad or float(ray_off.float().mean()) > 0.5:
        raise RuntimeError(f"full_iteration_nee differs from the bounce_step_nee route on "
                           f"{bad} pixels with the same camera ray ({name}, {kw}, {res}, "
                           f"glossy {glossy}; rays differ on {int(ray_off.sum())})")
    return float(ray_off.float().mean()), float(off.float().mean())


def nee_pool(dev, cam, iteration, settings):
    """The camera rays as a pool, with the MIS aux at zeros."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3

    origins, dirs, pix = generate_rays(cam, iteration, settings.antialias,
                                       settings.depth_of_field)
    P = pix.shape[0]
    pool = (Vec3(*(c.contiguous() for c in origins)), dirs, Vec3.ones(P, dev),
            Vec3.zeros(P, dev), torch.ones(P, dtype=torch.int32, device=dev), pix)
    return pool, (torch.zeros(P, device=dev), torch.zeros(P, device=dev))


def chain_bvh(ds, g, count=None):
    """ds (a DeviceScene) with mesh geom g's binary BVH replaced by a
    chain over its first `count` triangles (all by default; the others in
    no leaf): each inner node's left child a leaf of 4 triangles, its
    right child the rest (preorder, escape pointers, exact boxes): the
    deepest tree the triangles can make, on ds's device."""
    import torch

    start, n_tris = ds.tri_ranges[g]
    count = n_tris if count is None else count
    corners = torch.stack([torch.stack(list(v), 1) for v in
                           (ds.tri_v0, ds.tri_v1, ds.tri_v2)], 1)[start:start + count]
    lo_t, hi_t = corners.min(1).values, corners.max(1).values
    n_leaves = -(-count // 4)
    rows = []  # (min, max, first, count, is_leaf)
    for i in range(n_leaves):
        a = 4 * i
        if i < n_leaves - 1:
            rows.append((lo_t[a:].min(0).values, hi_t[a:].max(0).values, 0, 0, False))
        b = min(a + 4, count)
        rows.append((lo_t[a:b].min(0).values, hi_t[a:b].max(0).values,
                     start + a, b - a, True))
    B = len(rows)
    skip = np.full(B, B, np.int32)
    for j in range(0, B - 1, 2):  # inner j: left leaf j + 1, right j + 2
        skip[j + 1] = j + 2
    nmin, nmax = torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])
    roots = tuple((0, B) if k == g else (0, 0) for k in range(len(ds.tri_ranges)))
    dev = ds.device
    return replace(
        ds,
        bvh_min=type(ds.bvh_min)(*nmin.T.contiguous()),
        bvh_max=type(ds.bvh_max)(*nmax.T.contiguous()),
        bvh_first=torch.tensor([r[2] for r in rows], dtype=torch.int32, device=dev),
        bvh_count=torch.tensor([r[3] for r in rows], dtype=torch.int32, device=dev),
        bvh_skip=torch.from_numpy(skip).to(dev),
        bvh_leaf=torch.tensor([r[4] for r in rows], device=dev),
        bvh_roots=roots,
    )


def wide_depth(ds) -> int:
    """The most inner nodes on a root-to-leaf path of the 8-wide collapse
    (models/wide_bvh.py) of ds's mesh geoms' binary BVHs."""
    from project3_cuda_path_tracer_tpu_torch.models.wide_bvh import collapse

    host = lambda a: a.detach().cpu().numpy()  # noqa: E731
    return collapse(np.stack([host(c) for c in ds.bvh_min], 1),
                    np.stack([host(c) for c in ds.bvh_max], 1), host(ds.bvh_first),
                    host(ds.bvh_count), host(ds.bvh_skip), host(ds.bvh_leaf),
                    [ds.bvh_roots[g] for g in ds.mesh_geoms]).depth


def bounce_nee_parity(dev, name, kw, res, glossy, iteration=2, setup=None):
    """#5 at every depth from the plain version's own pool, is_last at the
    last depth (and at depth 1 too): pix exactly and alive per lane on
    every lane, radiance on every lane, the other lanes and the MIS aux on
    lanes alive after the bounce in both (no later step reads the others).
    Returns the worst (badfrac, median, max_abs_err, share of lanes whose
    alive differs) over the calls."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3

    ds, cam, settings = setup or on_card(dev, name, dict(kw, nee_mis=True), res,
                                         glossy=glossy)
    D = settings.trace_depth
    pool, aux = nee_pool(dev, cam, iteration, settings)
    tables = mk.pack_scene_tables(ds, nee=True)
    worst = (0.0, 0.0, 0.0, 0.0)
    for depth in range(D):
        last = depth == D - 1
        for is_last in {last, depth == 1 or last}:
            want, want_aux = mk.bounce_step_nee_reference(
                pool, aux, ds, iteration, depth, settings, is_last)
            lanes = [a.clone() for a in mk.pool_lanes(pool)]
            got = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                   Vec3(*lanes[9:12]), lanes[12], lanes[13])
            got_aux = tuple(a.clone() for a in aux)
            mk.bounce_step_nee(got, got_aux, ds, iteration, depth, settings,
                               is_last, tables=tables)
            torch.cuda.synchronize()
            g, w = mk.pool_lanes(got), mk.pool_lanes(want)
            if not torch.equal(g[13], w[13]):
                raise RuntimeError(f"bounce_step_nee: pix differs at depth "
                                   f"{depth} ({name}, {kw})")
            alive_frac = float((g[12] != w[12]).float().mean())
            alive = (g[12] != 0) & (w[12] != 0)
            r = compare(g[9:12] + [a[alive] for a in g[:9] + list(got_aux)],
                        w[9:12] + [a[alive] for a in w[:9] + list(want_aux)])
            worst = tuple(max(a, b) for a, b in zip(worst, r + (alive_frac,)))
            if is_last == last:
                next_pool = (want, want_aux)
        pool, aux = next_pool
    return worst


def shadow_sweep(ds, o, d, r, cast):
    """(operations, geom tests, lanes no analytic geom occludes) of the
    NEE kernels' any-hit shadow loop (`unoccluded` in
    csrc/path_common.cuh) over the lanes `cast`: analytic geoms in index
    order, each lane stopping at its first geom with 0 < t < r - 1e-2
    (the mesh geoms' walks follow on the lanes left)."""
    from project3_cuda_path_tracer_tpu_torch.ops.intersect import (
        box_intersect,
        sphere_intersect,
    )

    going = cast.clone()
    ops = tests = 0
    for g, gt in enumerate(ds.gtypes):
        n = int(going.sum())
        if n == 0:
            break
        if gt == 2:  # a mesh geom: walked after the loop
            continue
        tests += n
        if gt == 0:
            ops += n * OPS_SPHERE_TEST
            t = sphere_intersect(ds.transform[g], ds.inverse_transform[g],
                                 ds.inv_transpose[g], o, d)[0]
        else:
            ops += n * OPS_BOX_TEST
            t = box_intersect(ds.transform[g], ds.inverse_transform[g], o, d)[0]
        going = going & ~((t > 0) & (t < r - 1e-2))
    return ops, tests, going


def analytic_best_t(ds, o, d):
    """The nearest analytic hit's world t of each ray (FLT_MAX on a
    miss): the sweep of #5's and #6's mesh instantiations, which skips
    the mesh geoms."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops.intersect import (
        FLT_MAX,
        box_intersect,
        sphere_intersect,
    )

    best = torch.full_like(o.x, FLT_MAX)
    for g, gt in enumerate(ds.gtypes):
        if gt == 2:
            continue
        if gt == 0:
            t = sphere_intersect(ds.transform[g], ds.inverse_transform[g],
                                 ds.inv_transpose[g], o, d)[0]
        else:
            t = box_intersect(ds.transform[g], ds.inverse_transform[g], o, d)[0]
        best = torch.where((t > 0) & (t < best), t, best)
    return best


def skip_walk(ds, g, o, d, bt, shadow=None, work=None):
    """The walk of #5's and #6's mesh instantiations (csrc/nee.cu
    `mesh_walks`) over mesh geom g's binary BVH for the world rays (o, d),
    in plain PyTorch with the lanes in lock-step: one cursor a lane over
    the geom's preorder nodes, hit ? (leaf ? test its triangles, go skip :
    i + 1) : skip, a node hit when the ray enters its box before the
    bound. bt: (P,) each lane's object-space bound (FLT_MAX for none; the
    kernels' image of the nearest hit so far or of the shadow ray's
    length): a triangle counts only strictly below it. Nearest hit
    (shadow None): returns (t, triangle (-1 for none), u, v) of the least
    (t, triangle) below bt in walk order. Shadow ray (shadow: (P,) world
    bounds): a lane stops at its first triangle below bt whose world
    distance (`world_distance`) lies in (0, shadow); returns the occluded
    lanes. work: a dict whose int64 counts the walk adds to: `nodes`
    (boxes tested), `tris` (triangles tested) and `dists` (world
    distances the shadow walk takes). A leaf's triangles are tested at
    once, in one op over the leaf's slots (the kernels' order kept)."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.models.bvh import LEAF_SIZE
    from project3_cuda_path_tracer_tpu_torch.ops.bvh_traverse import _aabb_hit, _object_ray
    from project3_cuda_path_tracer_tpu_torch.ops.intersect import triangle_intersect
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3, take as vtake

    start, n_nodes = ds.bvh_roots[g]
    end = start + n_nodes
    ro, rd, inv_d = _object_ray(ds, g, o, d)
    n = ro.x.shape[0]
    dev = ro.x.device
    T = ds.tri_v0.x.shape[0]
    col = lambda v: Vec3(v.x[:, None], v.y[:, None], v.z[:, None])  # noqa: E731
    slot = torch.arange(LEAF_SIZE, device=dev)
    rows = torch.arange(n, device=dev)
    work = {} if work is None else work
    for k in ("nodes", "tris", "dists"):
        work.setdefault(k, torch.zeros((), dtype=torch.int64, device=dev))
    bt = bt.clone()
    btri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    cur = torch.full((n,), start, dtype=torch.int64, device=dev)
    step = 0
    while True:
        active = cur < end
        # the host reads the flag every 16 steps (a finished lane's cursor
        # stays past the range, so the steps between change nothing)
        if step % 16 == 0 and not bool(active.any()):
            break
        step += 1
        safe = torch.clamp(cur, start, end - 1)
        enter = _aabb_hit(vtake(ds.bvh_min, safe), vtake(ds.bvh_max, safe),
                          ro, inv_d, bt) & active
        leaf = ds.bvh_leaf[safe]
        work["nodes"] += active.sum()
        tri = ds.bvh_first[safe].to(torch.int64)[:, None] + slot
        valid = (enter & leaf)[:, None] & (slot < ds.bvh_count[safe][:, None])
        safe_tri = torch.clamp(tri, 0, max(T - 1, 0))
        t, u, v, ok = triangle_intersect(vtake(ds.tri_v0, safe_tri), vtake(ds.tri_v1, safe_tri),
                                         vtake(ds.tri_v2, safe_tri), col(ro), col(rd))
        below = valid & ok & (t < bt[:, None])
        stop = torch.zeros_like(active)
        if shadow is None:
            # the least t below the bound, the first slot on a tie: what
            # the kernels' strict < over the slots in order keeps
            work["tris"] += valid.sum()
            mt = torch.where(below, t, float("inf")).min(1).values
            k = torch.where(below & (t == mt[:, None]), slot, LEAF_SIZE).min(1).values
            k = torch.clamp(k, max=LEAF_SIZE - 1)
            better = below.any(1)
            bt = torch.where(better, mt, bt)
            btri = torch.where(better, tri[rows, k], btri)
            bu = torch.where(better, u[rows, k], bu)
            bv = torch.where(better, v[rows, k], bv)
        else:
            dist = world_distance(ds, g, col(ro), col(rd), t, col(o))
            blocks = below & (dist > 0) & (dist < shadow[:, None])
            first = torch.where(blocks, slot, LEAF_SIZE).min(1).values
            upto = slot <= first[:, None]  # the kernels return at the occluder
            work["tris"] += (valid & upto).sum()
            work["dists"] += (below & upto).sum()
            stop = first < LEAF_SIZE
            occluded |= stop
        nxt = torch.where(enter & ~leaf, cur + 1, ds.bvh_skip[safe].to(torch.int64))
        cur = torch.where(stop, end, torch.where(active, nxt, cur))
    if shadow is not None:
        return occluded
    return bt, btri, bu, bv


def world_distance(ds, g, ro, rd, t, o):
    """The world distance from o of the object-space hit at t on the ray
    (ro, rd) of mesh geom g, as the kernels take it (csrc/nee.cu
    `world_distance`)."""
    from project3_cuda_path_tracer_tpu_torch.ops.intersect import RAY_EPS, transform_point

    return (o - transform_point(ds.transform[g], ro + rd * (t - RAY_EPS))).length()


def binary_walk_work(ds, o, d, lanes, shadow_r=None):
    """(object rays, binary nodes, triangles, path walks that hit, shadow
    world distances) of #5's and #6's mesh walks over the rays `lanes`
    selects, counted by the same walk in plain PyTorch (`skip_walk`). A
    path ray (shadow_r None) walks each mesh geom below the object-space
    image (x frobenius3(inv)) of its nearest hit so far, the analytic
    sweep's at the first mesh geom; a walk that hits counts once (its
    world-space tail, OPS_MESH_HIT). A shadow ray of length shadow_r walks
    below the image of r - 1e-2, counts the world distance of each
    triangle it hits below it, and stops at the first whose world distance
    lies in (0, r - 1e-2), skipping the mesh geoms after it."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops.bvh_traverse import _object_ray
    from project3_cuda_path_tracer_tpu_torch.ops.intersect import FLT_MAX
    from project3_cuda_path_tracer_tpu_torch.ops.pipeline import _frobenius3
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3, take as vtake

    if not ds.mesh_geoms or not bool(lanes.any()):
        return 0, 0, 0, 0, 0
    o, d = (Vec3(*(c[lanes] for c in v)) for v in (o, d))
    shadow = shadow_r is not None
    n = o.x.shape[0]
    # the counts stay on the card until the end: the walks sync with the
    # host only for their loop flags
    work = {}
    rays = torch.zeros((), dtype=torch.int64, device=o.x.device)
    hits = torch.zeros((), dtype=torch.int64, device=o.x.device)
    going = torch.ones(n, dtype=torch.bool, device=o.x.device)
    if shadow:
        bound = shadow_r[lanes] - 1e-2
    else:
        best = analytic_best_t(ds, o, d)
    for g in ds.mesh_geoms:
        lim = bound if shadow else best
        bt = torch.where(lim < FLT_MAX, lim * _frobenius3(ds.inverse_transform[g]), FLT_MAX)
        if shadow:
            sel = torch.nonzero(going)[:, 0]
            rays += sel.numel()
            occ = skip_walk(ds, g, vtake(o, sel), vtake(d, sel), bt[sel], shadow=bound[sel],
                            work=work)
            going[sel[occ]] = False
            continue
        rays += n
        t, tri, _, _ = skip_walk(ds, g, o, d, bt, work=work)
        ro, rd, _ = _object_ray(ds, g, o, d)
        hit = tri >= 0
        hits += hit.sum()
        t_world = world_distance(ds, g, ro, rd, t, o)
        best = torch.where(hit & (t_world > 0) & (t_world < best), t_world, best)
    return tuple(int(c) for c in (rays, work["nodes"], work["tris"], hits, work["dists"]))


def nee_work(ds, cam, iteration, settings):
    """One iteration of the plain NEE path (render._nee_mis_bounce, whose
    probe gives the masks the kernels branch on), counting at each depth
    the lanes that do each part of the NEE kernels' work: the live lanes
    (the sweep with its normal), the NEE-able ones (a live non-emissive
    hit with a non-delta lobe: the light sample), those that cast a shadow
    ray (the sample faces both ways) and its geom tests, the unoccluded
    ones (the MIS contribution) and, below the last depth, those that
    scatter; and the warps of 32 consecutive slots that hold a live lane
    (the pool is never permuted, so slot = pixel). On a mesh scene also
    the mesh walks' work as the kernels walk (`binary_walk_work`): that of
    the live lanes' walks and of the walks of the shadow rays that no
    analytic geom occludes; and the plain bounce's ms at each depth.
    Returns ({count: [per depth]}, [operations per depth], the depths each
    pixel's path ran)."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.render import _nee_mis_bounce

    pool, aux = nee_pool(ds.device, cam, iteration, settings)
    state = pool[:4] + (pool[4] != 0, pool[5])
    aux = (aux[0], aux[1] > 0.5)
    names = ("lanes_in", "warps_with_live", "nee_able", "shadow_rays",
             "shadow_tests", "unoccluded", "scattered", "mesh_rays", "mesh_nodes",
             "mesh_tris", "mesh_hits", "shadow_mesh_rays", "shadow_mesh_nodes",
             "shadow_mesh_tris", "shadow_mesh_distances")
    counts = {k: [] for k in names}
    counts["plain_bounce_ms"] = []  # the plain estimator's bounce, timed
    ops = []
    D = settings.trace_depth
    length = torch.zeros(state[5].shape[0], dtype=torch.int64, device=ds.device)
    for depth in range(D):
        is_last = depth == D - 1
        lanes_in = int(state[4].sum())
        length += state[4].long()
        warps_with_live = int(state[4].view(-1, 32).any(1).sum())
        probe = {}
        walks = binary_walk_work(ds, state[0], state[1], state[4])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = _nee_mis_bounce(state, aux, ds, iteration, depth,
                                     settings, is_last, probe=probe)
        torch.cuda.synchronize()
        counts["plain_bounce_ms"].append(1e3 * (time.perf_counter() - t0))
        shadow_ops, tests, going = shadow_sweep(ds, probe["p_hit"], probe["wi"],
                                                probe["r"], probe["shadow"])
        shadow_walks = binary_walk_work(ds, probe["p_hit"], probe["wi"], going,
                                        shadow_r=probe["r"])
        n = dict(zip(names, (
            lanes_in, warps_with_live, int(probe["nee_able"].sum()),
            int(probe["shadow"].sum()), tests,
            int((probe["shadow"] & probe["visible"]).sum()),
            0 if is_last else int((probe["live_hit"] & ~probe["lit"]).sum()),
            *walks[:4], *shadow_walks[:3], shadow_walks[4],
        )))
        for k in names:
            counts[k].append(n[k])
        ops.append(
            n["lanes_in"] * (sweep_ops(ds) + OPS_NORMAL)
            + n["nee_able"] * (OPS_LIGHT + OPS_TO_LIGHT) + shadow_ops
            + n["unoccluded"] * (OPS_MIS + (0 if is_last else OPS_W_LIGHT))
            + n["scattered"] * (OPS_SHADE + OPS_NEXT_PDF)
            # the mesh walks: per ray and mesh geom walked its object-space
            # ray and bound, per node its slab test, per triangle
            # Moller-Trumbore, per path walk that hits the world-space
            # tail, per shadow hit below the bound its world distance
            + (n["mesh_rays"] + n["shadow_mesh_rays"]) * OPS_OBJ_RAY
            + (n["mesh_nodes"] + n["shadow_mesh_nodes"]) * OPS_NODE
            + (n["mesh_tris"] + n["shadow_mesh_tris"]) * OPS_MT
            + n["mesh_hits"] * OPS_MESH_HIT
            + n["shadow_mesh_distances"] * OPS_WORLD_DIST
        )
    return counts, ops, length


def warp_busy_share(length) -> float:
    """Lane use of a thread-per-pixel kernel: warps of 32 consecutive
    pixels each run as many steps as their longest path."""
    warps = length.view(-1, 32)
    return float(length.sum()) / (32 * int(warps.max(1).values.sum()))


def regenerated_busy_share(cost, lanes: int) -> float:
    """Lane use of a persistent kernel with path regeneration (#1, #6),
    in a model: `lanes` lanes, all stepping together, each taking the next
    pixel (in order) when it is free and spending cost[pixel] steps on it;
    a warp of 32 lanes runs until its last lane is done. The busy share of
    its lane-steps is 1 but for that tail."""
    cost = np.asarray(cost, np.int64)
    rem = np.zeros(lanes, np.int64)
    end = np.zeros(lanes, np.int64)
    t = nxt = 0
    while True:
        free = np.flatnonzero(rem == 0)
        k = min(len(free), len(cost) - nxt)
        rem[free[:k]] = cost[nxt:nxt + k]
        end[free[:k]] = t + cost[nxt:nxt + k]
        nxt += k
        busy = rem > 0
        if not busy.any():
            break
        step = int(rem[busy].min())
        rem[busy] -= step
        t += step
    warp_steps = int(end.reshape(-1, 32).max(1).sum())
    return float(cost.sum()) / (32 * warp_steps)


def resident_lanes(regs: int, sms: int) -> int:
    """Lanes of a persistent grid of 128-thread blocks at `regs`
    registers a thread: registers are allocated per warp in units of 256,
    at most 16 such blocks (2,048 threads) per SM."""
    per_warp = -(-regs * 32 // 256) * 256
    return sms * min(16, 65536 // (4 * per_warp)) * 128

def full_parity(dev, name, kw, res, iteration=3, bits_rule=True):
    """#1 against its plain version, one iteration: compare()'s numbers
    and the share of pixels not bit-identical (with `bits_rule`, fails
    above FULL_BITS_OFF: the surface stage's texel blends round an ulp
    apart from the plain version's on most textured lanes, so its scenes
    keep the image rule alone); and bit for bit against the per-bounce
    kernels (#2, then #3 at every depth, thread per pixel: the same device
    code), which fails on any bit."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3

    ds, cam, settings = on_card(dev, name, kw, res)
    accum = Vec3.zeros(res[0] * res[1], dev)
    mk.full_iteration(ds, cam, iteration, settings, accum)
    plain = mk.full_iteration_reference(ds, cam, iteration, settings)
    pool = mk.first_bounce(ds, cam, iteration, settings)
    for depth in range(1, settings.trace_depth):
        pool = mk.bounce_step(pool, ds, iteration, depth, settings)
    torch.cuda.synchronize()
    off = torch.zeros_like(accum.x, dtype=torch.bool)
    for g, w, c in zip(accum, plain, pool[3]):
        off |= bitwise(g) != bitwise(w)
        if not torch.equal(bitwise(g), bitwise(c)):
            raise RuntimeError(f"full_iteration is not bit-identical to first_bounce "
                               f"-> bounce_step ({name}, {kw}, {res})")
    bits_off = float(off.float().mean())
    if bits_rule and bits_off > FULL_BITS_OFF:
        raise RuntimeError(f"full_iteration: {bits_off:.3%} of the pixels are not "
                           f"bit-identical to the plain version ({name}, {kw}, {res})")
    return compare(list(accum), list(plain)) + (bits_off,)


def bounce_parity(dev, name, kw, res, iteration=2):
    """#2, then #3 at every depth from the plain version's own pool, and
    #4 over the depth-0 intersections: each against its plain version.
    Returns {kernel: (badfrac, median, max_abs_err)} (worst over depths)."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays
    from project3_cuda_path_tracer_tpu_torch.ops.sweep import intersect_scene
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
    from project3_cuda_path_tracer_tpu_torch.render import (
        _count_alive,
        _maybe_compact,
    )

    ds, cam, settings = on_card(dev, name, kw, res)
    out = {}
    want = mk.first_bounce_reference(ds, cam, iteration, settings)
    got = mk.first_bounce(ds, cam, iteration, settings)
    torch.cuda.synchronize()
    out["first_bounce"] = compare(mk.pool_lanes(got), mk.pool_lanes(want))
    pool = want
    worst = (0.0, 0.0, 0.0)
    for depth in range(1, settings.trace_depth):
        pool = _maybe_compact(pool, settings)
        n_alive = _count_alive(pool) if settings.compact else None
        want = mk.bounce_step_reference(pool, ds, iteration, depth, settings,
                                        num_alive=n_alive)
        got = mk.bounce_step(pool, ds, iteration, depth, settings,
                             num_alive=n_alive)
        torch.cuda.synchronize()
        r = compare(mk.pool_lanes(got), mk.pool_lanes(want))
        worst = tuple(max(a, b) for a, b in zip(worst, r))
        pool = want
    out["bounce_step"] = worst
    # #4 on the first-bounce cache's path: pinhole rays, depth 0
    origins, dirs, pix = generate_rays(cam, iteration, False, False)
    P = pix.shape[0]
    pool0 = (Vec3(*(c.contiguous() for c in origins)), dirs, Vec3.ones(P, dev),
             Vec3.zeros(P, dev), torch.ones(P, dtype=torch.int32, device=dev), pix)
    isect = intersect_scene(origins, dirs, ds)
    got = mk.shade_step(pool0, isect, ds, iteration, 0, settings)
    want = mk.shade_step_reference(pool0, isect, ds, iteration, 0, settings)
    torch.cuda.synchronize()
    out["shade_step"] = compare(mk.pool_lanes(got), mk.pool_lanes(want))
    return out


def wrapper(name: str):
    """The wrapper function of a kernel (its launch count lives on it)."""
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline

    return getattr(pipeline if name in MESH_KERNELS else mk, name)


def lane_rule(got, want):
    """(worst share of lanes off by more than LANE_ATOL, max_abs_err) over
    parallel lists of (P,) tensors; non-finite values fail."""
    worst = err = 0.0
    for g, w in zip(got, want):
        g = g.detach().double().cpu().numpy()
        w = w.detach().double().cpu().numpy()
        if not (np.isfinite(g).all() and np.isfinite(w).all()):
            raise RuntimeError("non-finite values")
        if g.size:
            diff = np.abs(g - w)
            worst = max(worst, float((diff > LANE_ATOL).mean()))
            err = max(err, float(diff.max()))
    return worst, err


def hit_lanes(h):
    """An Intersections' lanes (the mesh kernels' outputs)."""
    return [h.t, *h.normal, h.material_id, h.outside, h.tex_u, h.tex_v,
            h.has_uv]


def mesh_parity(dev, kw, res, iteration=2, name="mesh.txt", depth=8):
    """#7-#10 on a mesh scene at every depth of one iteration, each from the
    plain version's own inputs (the pool after the plain #9 of the depth
    before): #7's analytic hits on the lanes it processed and its
    candidate set (the listed lanes must be exactly its flagged ones), #8
    on the candidates, #9 on the pool (pix exactly), #10 on every lane of
    the intersect route; depths 0..depth-1. Returns ({kernel: (worst lane
    share, max_abs_err)}, the share of lanes whose candidacy differs)."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
    from project3_cuda_path_tracer_tpu_torch.render import (
        _camera_pool,
        _count_alive,
        _maybe_compact,
    )

    ds, cam, settings = on_card(dev, name, kw, res, depth=depth)
    P = res[0] * res[1]
    pool = _camera_pool(cam, iteration, settings)
    worst = {k: (0.0, 0.0) for k in MESH_KERNELS[:4]}
    cand_off = 0.0
    for depth in range(settings.trace_depth):
        pool = _maybe_compact(pool, settings)
        n_alive = _count_alive(pool) if settings.compact else None
        o, d, alive = pool[0], pool[1], pool[4]
        live = alive != 0
        if n_alive is not None:
            live = live & (torch.arange(P, device=dev) < n_alive)
        want7 = pl.mesh_candidates_reference(o, d, alive, ds, n_alive)
        got7 = pl.mesh_candidates(o, d, alive, ds, num_alive=n_alive)
        torch.cuda.synchronize()
        n = int(got7.count[0])
        listed = torch.zeros(P, dtype=torch.bool, device=dev)
        listed[got7.lanes[:n].long()] = True
        if not torch.equal(listed, got7.cand & live):
            raise RuntimeError("mesh_candidates: its list and its flags disagree")
        cand_off = max(cand_off, float((listed != want7.cand).float().mean()))
        r7 = lane_rule([a[live] for a in (got7.t, *got7.normal, got7.material_id)],
                       [a[live] for a in (want7.t, *want7.normal,
                                          want7.material_id)])
        want8 = pl.mesh_sweep_reference(o, d, want7, ds)
        got8 = pl.mesh_sweep(o, d, want7, ds)
        torch.cuda.synchronize()
        r8 = lane_rule([a[want7.cand] for a in hit_lanes(got8)],
                       [a[want7.cand] for a in hit_lanes(want8)])
        all7 = pl.mesh_candidates_reference(o, d, alive, ds)
        all8 = pl.mesh_sweep_reference(o, d, all7, ds)
        got10 = pl.intersect_mesh(all7, all8)
        torch.cuda.synchronize()
        r10 = lane_rule(hit_lanes(got10), hit_lanes(pl.merge_hits(all7, all8)))
        want9 = pl.bounce_step_mesh_reference(pool, want7, want8, ds, iteration,
                                              depth, settings, n_alive)
        lanes = [a.clone() for a in mk.pool_lanes(pool)]
        got9 = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                Vec3(*lanes[9:12]), lanes[12], lanes[13])
        pl.bounce_step_mesh(got9, want7, want8, ds, iteration, depth, settings,
                            num_alive=n_alive)
        torch.cuda.synchronize()
        g9, w9 = mk.pool_lanes(got9), mk.pool_lanes(want9)
        if not torch.equal(g9[13], w9[13]):
            raise RuntimeError(f"bounce_step_mesh: pix differs at depth {depth}")
        r9 = lane_rule(g9[:13], w9[:13])
        for k, r in zip(MESH_KERNELS[:4], (r7, r8, r9, r10)):
            worst[k] = tuple(max(a, b) for a, b in zip(worst[k], r))
        pool = want9
    return worst, cand_off


def mesh_work(ds, cam, iteration, settings):
    """One iteration of the plain mesh path (#7 -> #8 -> #9's plain
    versions) at every depth, counting per depth the lanes that do each
    part of the mesh kernels' work: the live lanes entering (#7's sweep,
    #9's shading), the candidates (#8's lists), the geom walks, nodes
    and triangles they test (the plain binary walk's probe) and the walks
    that hit; the same walks over #8's wide tables (the plain wide walk's
    probe: inner wide nodes, leaves, triangles, the deepest stack) and the
    lanes whose winner's t it gives other bits than the binary walk; and
    timing each plain version (host clock, synchronised); and the surface
    stage's operations of #9's lanes (`surface_ops`).
    Returns ({count: [per depth]}, {kernel: plain ms per call})."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    pool = _camera_pool(cam, iteration, settings)
    wide = pl.pack_wide_tables(ds)
    names = ("lanes_in", "candidates", "walks", "nodes", "tris", "mesh_hits",
             "wide_nodes", "wide_leaves", "wide_tris", "wide_stack_max",
             "slab_ulp_lanes", "surface_ops")
    counts = {k: [] for k in names}
    plain = {k: 0.0 for k in MESH_KERNELS[:3]}
    D = settings.trace_depth
    for depth in range(D):
        o, d, alive = pool[0], pool[1], pool[4]
        lanes_in = int((alive != 0).sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cands = pl.mesh_candidates_reference(o, d, alive, ds)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probe = {}
        hits = pl.mesh_sweep_reference(o, d, cands, ds, probe=probe)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pool = pl.bounce_step_mesh_reference(pool, cands, hits, ds, iteration,
                                             depth, settings)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(MESH_KERNELS, (t1 - t0, t2 - t1, t3 - t2)):
            plain[k] += 1e3 * dt / D
        # #8's own walk over the wide tables: its work, and the lanes whose
        # winner it gives other bits than the binary walk (a triangle whose
        # t lies an ulp inside a box's slab entry, or an exact tie)
        wprobe = {}
        listed = cands.lanes[:int(cands.count[0])].long()
        wide_hits = pl.mesh_sweep_wide_reference(o, d, cands, ds, wide, probe=wprobe)
        n = dict(zip(names, (
            lanes_in, int(cands.count[0]), int(probe["walks"].sum()),
            int(probe["nodes"].sum()), int(probe["tris"].sum()),
            int((hits.t > 0).sum()), int(wprobe["nodes"].sum()),
            int(wprobe["leaves"].sum()), int(wprobe["tris"].sum()),
            int(wprobe["stack"].max()) if listed.numel() else 0,
            int((bitwise(wide_hits.t[listed]) != bitwise(hits.t[listed])).sum()),
            surface_ops(ds, pl.merge_hits(cands, hits), d, alive),
        )))
        for k in names:
            counts[k].append(n[k])
    return counts, plain


def camera_at(camera, res):
    """A host camera at another resolution (the same view and fovy)."""
    from project3_cuda_path_tracer_tpu_torch.models.scene import derive_camera

    return derive_camera(res, camera.position, camera.look_at,
                         np.array([0, 1, 0], np.float32), float(camera.fov[1]),
                         camera.aperture, camera.focal_distance)


def clone_hits(h):
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3

    return type(h)(h.t.clone(), Vec3(*(c.clone() for c in h.normal)),
                   h.material_id.clone(), h.outside.clone(), h.tex_u.clone(),
                   h.tex_v.clone(), h.has_uv.clone())


def replay_ms(fn, reps):
    """ms per launch of the one kernel launch that fn() (a wrapper of
    ops/pipeline.py) makes: its C entry point called again `reps` times
    back to back with the same arguments between two CUDA events, so no
    wrapper's host time falls between the launches."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import _native
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl

    calls, launch = [], pl._launch
    pl._launch = lambda name, what, *args: (calls.append((name, args)),
                                            launch(name, what, *args))
    try:
        keep = fn()  # the outputs the replays write into stay allocated
    finally:
        pl._launch = launch
    (name, args), = calls
    entry = _native.load().fn(name)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        if entry(*args) != 0:
            raise RuntimeError(f"{name}: launch failed")
    end.record()
    torch.cuda.synchronize()
    del keep
    return start.elapsed_time(end) / reps


def window_tail_ms(st, sk, ds, g, tables, out, reps=10):
    """C alone over the window part and over the tail part of B's stream
    `st` (its prefix and its suffix, split at the first tail key) and over
    the whole stream: ms per launch (`replay_ms`) and the parts' entry
    counts, appended to out's per-depth lists."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl

    sn = ds.super_ranges[g][1]
    total = int(st.total[0])
    window = int((st.key[:total] < sn).sum())
    row = {"window_entries": window, "tail_entries": total - window}
    for part, lo, hi in (("window_ms", 0, window), ("tail_ms", window, total),
                         ("whole_ms", 0, total)):
        key = torch.full_like(st.key, 2 * sn)
        entry = torch.zeros_like(st.entry)
        key[:hi - lo] = st.key[lo:hi]
        entry[:hi - lo] = st.entry[lo:hi]
        sub = pl.Stream(key, entry, torch.tensor([hi - lo], dtype=torch.int32,
                                                 device=key.device))
        row[part] = replay_ms(lambda sub=sub: pl.window_sweep(sub, sk, ds, g,
                                                              tables=tables), reps)
    for k, v in row.items():
        out.setdefault(k, []).append(v)


def sorted_parity(ds, cam, settings, depths, tables, iteration=2, split=None):
    """A-D on a big-mesh scene at each depth in `depths` of one iteration,
    each kernel from the plain version's own inputs (the pool after the
    plain bounce before, #8's plain hits): A's keys exactly `super_rank`'s
    over A's own object-space rays and bounds (and its histogram exactly),
    its rays and its keys against the plain A's (lane rule; keys on all but
    0.1% of the lanes: ulps of FMA contraction near a slab face); B's
    stream per key exactly the plain one's over A's keys; C's t, u, v on
    the entries both hit by the lane rule, its hit flag and triangle on 99%
    of the entries (ties); D's hit lanes and the whole bounce (#7 -> #8 ->
    A-D -> #9 against the plain chain) by the lane rule, #9's pix exactly.
    Also counts, per depth, the work of the plain route (for the bounds)
    and times each plain version (host clock, synchronised). At the same
    depths the radix route (`radix_check`), and the whole bounce under
    SORT_RADIX against the counting route's bounce, bit for bit (any
    difference reported and held to the lane rule).
    With `split` (a dict), C's time on the window and on the tail part of
    B's stream at each checked depth (`window_tail_ms`) goes into it.
    Returns ({kernel or check: (worst share, max_abs_err)}, {count: [per
    depth]}, {kernel: plain ms per call}, {library call: ms per call}, the
    radix route's work {count: [per checked depth]})."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    E = pl.SORT_EXPAND
    pool = _camera_pool(cam, iteration, settings)
    worst = {k: (0.0, 0.0) for k in SORTED_KERNELS + ("chain",)}
    names = ("lanes_in", "candidates", "entries", "tail_entries", "chunks",
             "tris", "under_bound", "mesh_hits")
    work = {k: [] for k in names}
    plain = dict.fromkeys(SORTED_KERNELS, 0.0)
    radix_plain, library, radix_work = {}, {}, {}
    calls = 0

    def bump(k, r):
        worst[k] = tuple(max(a, b) for a, b in zip(worst.get(k, (0.0, 0.0)), r))

    def timed(k, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        plain[k] += 1e3 * (time.perf_counter() - t0)
        return out

    for depth in range(max(depths) + 1):
        o, d, alive = pool[0], pool[1], pool[4]
        cands = pl.mesh_candidates_reference(o, d, alive, ds)
        n = int(cands.count[0])
        listed = cands.lanes[:n].long()
        hits = pl.mesh_sweep_reference(o, d, cands, ds)
        count = dict.fromkeys(names, 0)
        count["lanes_in"] = int((alive != 0).sum())
        count["candidates"] = n
        for g in pl.sorted_geoms(ds):
            ss, sn = ds.super_ranges[g]
            check = depth in depths
            if check:
                sk = pl.super_keys(o, d, cands, hits, ds, g, tables=tables)
                torch.cuda.synchronize()
                keys = pl.super_rank(tuple(sk.rays[:, :n]), sk.bt0[:n],
                                     ds.mesh_super_aabbs[ss:ss + sn], E)
                real = keys[keys < 2 * sn].long()
                if not (torch.equal(sk.keys[:, :n], keys) and torch.equal(
                        sk.hist, torch.bincount(real, minlength=2 * sn).int())):
                    raise RuntimeError(f"super_keys: keys differ at depth {depth}")
            psk = timed("super_keys", lambda: pl.super_keys_reference(
                o, d, cands, hits, ds, g, E))
            pst = timed("place_entries",
                        lambda: pl.place_entries_reference(psk, cands.count))
            probe = {}
            peh = timed("window_sweep", lambda: pl.window_sweep_reference(
                pst, psk, ds, g, probe=probe))
            before = hits.t.clone()
            phits = timed("merge_entries", lambda: pl.merge_entries_reference(
                o, d, cands, clone_hits(hits), psk, peh, ds, g))
            calls += 1
            m = int(pst.total[0])
            count["entries"] += m
            count["tail_entries"] += int((pst.key[:m] >= sn).sum())
            count["chunks"] += int(probe["chunks"].sum())
            count["tris"] += int(probe["tris"].sum())
            # D's listed lanes whose least slot t is under their bound: the
            # lanes whose world ray and epilogue it needs
            bt = torch.where(psk.keys[:, :n] < psk.hist.shape[0], peh.t[:, :n],
                             pl.FLT_MAX).amin(0) if n else peh.t[0, :0]
            count["under_bound"] += int(((bt < pl.FLT_MAX) & (bt < psk.bt0[:n])).sum())
            count["mesh_hits"] += int((phits.t[listed] != before[listed]).sum())
            if check:
                key_off = float((sk.keys[:, :n] != psk.keys[:, :n]).float().mean())
                w, e = lane_rule(list(sk.rays[:, :n]), list(psk.rays[:, :n]))
                bump("super_keys", (max(w, key_off), e))
                if key_off > 0.001:
                    raise RuntimeError(f"super_keys: {key_off:.3%} of the keys "
                                       f"differ from the plain A's")
                st = pl.place_entries(sk, cands.count)
                want_st = pl.place_entries_reference(sk, cands.count)
                torch.cuda.synchronize()
                total = int(st.total[0])
                pairs = lambda s: torch.sort(  # noqa: E731
                    s.key[:total].long() * (1 << 32) + s.entry[:total].long()).values
                if total != int(want_st.total[0]) or not torch.equal(
                        pairs(st), pairs(want_st)):
                    raise RuntimeError(f"place_entries: stream differs at depth "
                                       f"{depth}")
                eh = pl.window_sweep(st, sk, ds, g, tables=tables)
                want_eh = pl.window_sweep_reference(st, sk, ds, g)
                torch.cuda.synchronize()
                ids = st.entry[:total].long()
                flat = lambda a: a.reshape(-1)[ids]  # noqa: E731
                hit_g = flat(eh.t) < pl.FLT_MAX
                hit_w = flat(want_eh.t) < pl.FLT_MAX
                both = hit_g & hit_w
                off = max(float((hit_g != hit_w).float().mean()),
                          float((flat(eh.tri) != flat(want_eh.tri)).float().mean()))
                w, e = lane_rule([flat(a)[both] for a in (eh.t, eh.u, eh.v)],
                                 [flat(a)[both] for a in
                                  (want_eh.t, want_eh.u, want_eh.v)])
                bump("window_sweep", (max(w, off), e))
                if off > 0.01:
                    raise RuntimeError(f"window_sweep: winners differ on "
                                       f"{off:.2%} of the entries")
                if split is not None:
                    window_tail_ms(st, sk, ds, g, tables, split)
                got = pl.merge_entries(o, d, cands, clone_hits(hits), sk, eh, ds,
                                       g, tables=tables)
                want = pl.merge_entries_reference(o, d, cands, clone_hits(hits),
                                                  sk, eh, ds, g)
                torch.cuda.synchronize()
                bump("merge_entries", lane_rule([a[listed] for a in hit_lanes(got)],
                                                [a[listed] for a in hit_lanes(want)]))
                for k, r in radix_check(o, d, cands, hits, sk, eh, ds, g, tables,
                                        radix_plain, library, radix_work).items():
                    bump(k, r)
            hits = phits
        for k in names:
            work[k].append(count[k])
        if depth in depths:
            lanes = [a.clone() for a in mk.pool_lanes(pool)]
            start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                     Vec3(*lanes[9:12]), lanes[12], lanes[13])
            got9 = pl.bounce_step_pipeline(start, ds, iteration, depth, settings,
                                           tables=tables)
            lanes = [a.clone() for a in mk.pool_lanes(pool)]
            start = (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]),
                     Vec3(*lanes[9:12]), lanes[12], lanes[13])
            pl.SORT_RADIX, radix = True, pl.SORT_RADIX
            try:
                got9r = pl.bounce_step_pipeline(start, ds, iteration, depth,
                                                settings, tables=tables)
            finally:
                pl.SORT_RADIX = radix
        want9 = pl.bounce_step_mesh_reference(pool, cands, hits, ds, iteration,
                                              depth, settings)
        if depth in depths:
            torch.cuda.synchronize()
            g9, w9 = mk.pool_lanes(got9), mk.pool_lanes(want9)
            if not torch.equal(g9[13], w9[13]):
                raise RuntimeError(f"the big-mesh bounce: pix differs at depth "
                                   f"{depth}")
            bump("chain", lane_rule(g9[:13], w9[:13]))
            r9 = mk.pool_lanes(got9r)
            same = torch.ones_like(r9[13], dtype=torch.bool)
            for a, b in zip(r9, g9):
                same &= bitwise(a) == bitwise(b)
            w, e = lane_rule(r9[:13], g9[:13])
            bump("radix_chain", (float((~same).float().mean()), e))
            if w > LANE_FRAC or not torch.equal(r9[13], g9[13]):
                raise RuntimeError(f"the radix route's bounce is off the counting "
                                   f"route's on {w:.2%} of the lanes at depth {depth}")
        pool = want9
    per_call = {k: v / max(calls, 1) for k, v in plain.items()}
    per_call.update({k: ms / n for k, (ms, n) in radix_plain.items()})
    return (worst, work, per_call, {k: ms / n for k, (ms, n) in library.items()},
            radix_work)


def bitwise(a):
    """A tensor's 32-bit words as int32 (exact comparisons of floats)."""
    import torch

    return a.view(torch.int32) if a.dtype == torch.float32 else a


def radix_check(o, d, cands, hits, sk, eh, ds, g, tables, plain, library, work):
    """The radix route of big geom g at one depth, from A's keys `sk` and
    the counting route's C results `eh` (both the kernels'): the compaction
    split (keys, rays, entry ids, length, digit histograms), each digit
    pass of the route and a one-bit pass (width 1, one `_kr_partition` +
    `_kr_stitch2`) against their plain versions exactly; the sorted stream
    against a stable torch.sort gather of the compacted one; C in stream
    order against its plain version by C's rule; the unscatter against its
    plain version exactly and its round trip (the sorted rays back at every
    real [slot, j]); `radix_window_sweep` itself equal to that chain and
    its launches counted; the route's results at every real [slot, j] and
    D's lanes over them against the counting route's, bit for bit (any
    difference reported and held to the lane rule). Adds each plain
    version's host ms per call to `plain` and the library calls' ms to
    `library` ({name: [ms, calls]}): the sort a stable torch.sort of the
    compacted keys with the payload and id gathers, the unscatter an
    index_copy_ by the ids, B a stable torch.sort of A's masked keys.
    Appends the split's work to `work` ({count: [per call]}: tiles of the
    compaction split and of each pass, the route's launches, the
    look-back's steps and spins over a probed run of the splits, the
    unscatter's ms replayed into its warm output). Returns
    {check: (share that differs, max_abs_err)}."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl

    E, P = sk.keys.shape
    sn = ds.super_ranges[g][1]
    dead = 2 * sn
    bits = pl.radix_key_bits(dead)
    n = int(cands.count[0])
    dev = sk.keys.device
    out = {}

    def add(table, k, ms):
        table.setdefault(k, [0.0, 0])
        table[k][0] += ms
        table[k][1] += 1

    def timed(k, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        add(plain, k, 1e3 * (time.perf_counter() - t0))
        return res

    def exact(what, got, want):
        if not torch.equal(bitwise(got), bitwise(want)):
            raise RuntimeError(f"radix route: {what} differs from its plain version")

    def same_stream(what, got, want, m):
        exact(f"keys of {what}", got.key[:m], want.key[:m])
        exact(f"payload of {what}", got.payload[:, :m], want.payload[:, :m])
        exact(f"entry ids of {what}", got.entry[:m], want.entry[:m])

    real = (sk.keys < dead) & (torch.arange(P, device=dev) < n)[None]
    masked = torch.where(real, sk.keys, dead).reshape(-1)
    add(library, "place_entries", event_ms(lambda: torch.sort(masked, stable=True), 3))

    scratch = pl.radix_work(E * P, bits, dev)
    compact = pl.RadixSplit(sk.keys, cands.count, -1, dead)
    stream = pl.radix_split(compact, sk.rays, work=scratch)
    want_c = timed("radix_split", lambda: pl.radix_split_reference(compact, sk.rays))
    torch.cuda.synchronize()
    total = int(stream.length[0])
    if total != int(want_c.length[0]) or total != int(real.sum()):
        raise RuntimeError(f"radix route: the compaction split placed {total} entries")
    same_stream("the compaction split", stream, want_c, total)
    exact("digit histograms of the compaction split", stream.hist, want_c.hist)
    srt = stream
    for p, (shift, width) in enumerate(pl.radix_passes(bits)):
        sp = pl.RadixSplit(srt.key, srt.length, shift, width=width, hist=srt.hist[p])
        got = pl.radix_split(sp, srt.payload, srt.entry, work=scratch)
        want = timed("radix_split",
                     lambda: pl.radix_split_reference(sp, srt.payload, srt.entry))
        same_stream(f"digit pass {shift}:{width}", got, want, total)
        srt = got._replace(hist=srt.hist)
    sp1 = pl.RadixSplit(stream.key, stream.length, 0, width=1,
                        hist=pl.radix_digit_counts(stream.key, stream.length, 0, 1))
    same_stream("the one-bit pass", pl.radix_split(sp1, stream.payload, stream.entry),
                pl.radix_split_reference(sp1, stream.payload, stream.entry), total)
    ck, cp, ce = (stream.key[:total], stream.payload[:, :total],
                  stream.entry[:total])
    idx = torch.sort(ck, stable=True).indices
    if not (torch.equal(srt.key[:total], ck[idx])
            and torch.equal(srt.payload[:, :total], cp[:, idx])
            and torch.equal(srt.entry[:total], ce[idx])):
        raise RuntimeError("radix route: the sorted stream is not the stable "
                           "torch.sort gather of the compacted stream")

    def lib_sort():
        i = torch.sort(ck, stable=True).indices
        return ck[i], cp[:, i], ce[i]

    add(library, "sort", event_ms(lib_sort, 3))
    res = pl.window_sweep_stream(srt, ds, g, tables=tables)
    want = timed("window_sweep_stream",
                 lambda: pl.window_sweep_stream_reference(srt, ds, g))
    got_h, want_h = pl.entry_hits(res), pl.entry_hits(want)
    hit_g, hit_w = got_h.t[:total] < pl.FLT_MAX, want_h.t[:total] < pl.FLT_MAX
    both = hit_g & hit_w
    off = max(float((hit_g != hit_w).float().mean()),
              float((got_h.tri[:total] != want_h.tri[:total]).float().mean()))
    w, e = lane_rule([a[:total][both] for a in (got_h.t, got_h.u, got_h.v)],
                     [a[:total][both] for a in (want_h.t, want_h.u, want_h.v)])
    out["window_sweep_stream"] = (max(w, off), e)
    if off > 0.01 or w > LANE_FRAC:
        raise RuntimeError(f"window_sweep_stream: winners differ on {off:.2%} of "
                           f"the entries, {w:.2%} off the lane rule")
    full = pl.radix_unscatter(srt, res)
    # the same launch replayed into its own output, whose sectors are then
    # in L2 (the route's launch writes into a fresh, cold buffer)
    warm_ms = replay_ms(lambda: pl.radix_unscatter(srt, res), 10)
    want_f = timed("radix_unscatter", lambda: pl.radix_unsplit_reference(srt, res))
    flat = real.reshape(-1)
    exact("the unscatter", full[:, flat], want_f[:, flat])
    ids = srt.entry[:total].long()
    src = res[:, :total]
    dst = torch.empty_like(full)
    add(library, "radix_unscatter", event_ms(lambda: dst.index_copy_(1, ids, src), 3))
    trip = pl.radix_unscatter(srt, srt.payload)
    if not torch.equal(bitwise(trip.view(6, E, P)[:, real]),
                       bitwise(sk.rays[:, None, :].expand(6, E, P)[:, real])):
        raise RuntimeError("radix route: the unsort does not round-trip")
    # the route itself: the same results, 1 + passes splits and 1 unscatter
    before = (pl.radix_split.launches, pl.radix_unscatter.launches)
    route = pl.radix_window_sweep(sk, cands.count, ds, g, tables=tables)
    launched = (pl.radix_split.launches - before[0],
                pl.radix_unscatter.launches - before[1])
    rad = pl.entry_hits(full.view(4, E, P))
    for a, b in zip(route, rad):
        if not torch.equal(bitwise(a[real]), bitwise(b[real])):
            raise RuntimeError("radix route: radix_window_sweep differs from its "
                               "kernels' chain")
    if launched != (1 + len(pl.radix_passes(bits)), 1):
        raise RuntimeError(f"radix route: {launched} (split, unscatter) launches")
    # the look-back's work over a probed run of the splits
    probe = torch.zeros(2, dtype=torch.int32, device=dev)
    scratch = pl.radix_work(E * P, bits, dev)
    s2 = pl.radix_split(compact, sk.rays, work=scratch, probe=probe)
    for p, (shift, width) in enumerate(pl.radix_passes(bits)):
        s2 = pl.radix_split(pl.RadixSplit(s2.key, s2.length, shift, width=width,
                                          hist=s2.hist[p]), s2.payload, s2.entry,
                            work=scratch, probe=probe)._replace(hist=s2.hist)
    steps, spins = probe.tolist()
    c_tiles, p_tiles = -(-E * n // pl.RADIX_TILE), -(-total // pl.RADIX_TILE)
    row = {"listed": n, "entries": total, "compaction_tiles": c_tiles,
           "pass_tiles": p_tiles, "passes": len(pl.radix_passes(bits)),
           "split_launches": launched[0], "unscatter_launches": launched[1],
           "memsets": 1,
           # one look-back per tile after the first, per digit value
           "lookbacks": max(0, c_tiles - 1) + sum(max(0, p_tiles - 1) << w
                                                   for _, w in pl.radix_passes(bits)),
           "lookback_steps": steps, "lookback_spins": spins,
           "unscatter_replay_ms": warm_ms}
    for k, v in row.items():
        work.setdefault(k, []).append(v)
    # the route against the counting route: C's results at every real
    # [slot, j], then D over each
    same = torch.ones_like(real)
    for a, b in zip(rad, eh):
        same &= bitwise(a) == bitwise(b)
    diff = float((~same[real]).float().mean())
    w, e = lane_rule([a[real] for a in (rad.t, rad.u, rad.v)],
                     [a[real] for a in (eh.t, eh.u, eh.v)])
    tri_off = float((rad.tri[real] != eh.tri[real]).float().mean())
    out["route_entries"] = (diff, e)
    if w > LANE_FRAC or tri_off > 0.01:
        raise RuntimeError(f"radix route: C's results off the counting route's "
                           f"on {max(w, tri_off):.2%} of the entries")
    got = pl.merge_entries(o, d, cands, clone_hits(hits), sk, rad, ds, g, tables=tables)
    want = pl.merge_entries(o, d, cands, clone_hits(hits), sk, eh, ds, g, tables=tables)
    torch.cuda.synchronize()
    listed = cands.lanes[:n].long()
    lanes_g = [a[listed] for a in hit_lanes(got)]
    lanes_w = [a[listed] for a in hit_lanes(want)]
    same = torch.ones(n, dtype=torch.bool, device=listed.device)
    for a, b in zip(lanes_g, lanes_w):
        same &= bitwise(a) == bitwise(b)
    w, e = lane_rule(lanes_g, lanes_w)
    out["route_lanes"] = (float((~same).float().mean()) if n else 0.0, e)
    if w > LANE_FRAC:
        raise RuntimeError(f"radix route: D's lanes off the counting route's on "
                           f"{w:.2%} of the lanes")
    return out


def reset_launches():
    for name in KERNELS:
        wrapper(name).launches = 0


def read_launches():
    return {name: wrapper(name).launches for name in KERNELS}


def event_ms(fn, reps):
    """Mean ms of fn() over `reps` runs, CUDA events around each, with a
    synchronize between runs (for the plain versions: their host time
    between launches is part of what they cost)."""
    import torch

    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def profile_device(fn, n_iters, by_depth=()):
    """Run fn() (n_iters iterations of a path) under torch.profiler.
    Returns (device busy ms per iteration, {kernel: mean device ms per
    launch}, {kernel: launches seen}, device events per iteration): the
    kernels' own device time, free of the host gaps between launches. For each kernel named in
    `by_depth`, launched once per depth, the mean is also given per depth
    (launch k of an iteration is depth k), as `<kernel>@depth`. The
    profiler's window is held open 50 ms before fn() and after its
    synchronize: late in a long run the profiler dropped every device
    event of a window of under a millisecond of device time (twice in a
    row, on the H100), which the padding keeps inside the window; it adds
    no device span. A profile that records no device activity at all is
    taken up to twice more; a third such one raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    else:
        raise RuntimeError("the profiler saw no device activity, three times")
    spans = []
    per = {k: [] for k in KERNEL_SYMBOLS}
    starts = {k: [] for k in by_depth}
    for e in events:
        spans.append((e.time_range.start, e.time_range.end))
        for k, sym in KERNEL_SYMBOLS.items():
            if sym.search(e.name):
                per[k].append(e.time_range.elapsed_us())
        for k in by_depth:
            if KERNEL_SYMBOLS[k].search(e.name):
                starts[k].append((e.time_range.start, e.time_range.elapsed_us()))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # the union of the device spans
        if b > end:
            busy += b - max(a, end)
            end = b
    mean = {k: sum(v) / len(v) / 1e3 for k, v in per.items() if v}
    for k, v in starts.items():
        times = [us for _, us in sorted(v)]
        D = len(times) // n_iters
        if D and len(times) == D * n_iters:
            mean[f"{k}@depth"] = [sum(times[i::D]) / n_iters / 1e3
                                  for i in range(D)]
    return (busy / 1e3 / n_iters, mean, {k: len(v) for k, v in per.items()},
            len(events) / n_iters)


def ptxas_verbose(nvcc: str, source: str, out_dir: str):
    """Start `nvcc -Xptxas -v` on one source with the build's own flags
    (into a throwaway library under out_dir); `ptxas_usage` reads it."""
    from project3_cuda_path_tracer_tpu_torch.ops import _native

    out = os.path.join(out_dir, "ptxas_" + os.path.basename(source) + ".so")
    return subprocess.Popen([nvcc, *_native.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
                             os.path.join(HERE, source)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_usage(proc, pattern: str) -> dict:
    """{kernel symbol matching `pattern`: ptxas's registers, shared memory,
    stack and spills} from a finished `ptxas_verbose` process."""
    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed: {err[-3000:]}")
    usage, name = {}, None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif name and re.search(pattern, name) and (
                "Used" in line or "stack frame" in line):
            usage.setdefault(name, []).append(line.split(" : ")[-1].strip())
    return {k: "; ".join(v) for k, v in usage.items()}


def sweep_sass(sass: str, kernel: str) -> dict:
    """#2's sweep in its SASS (`cuobjdump -sass` text), per function whose
    name holds `kernel`: its static instruction count and the instructions
    one lane issues per geom test of its sweep loop (the innermost loop
    with an FCHK, a division's range check), on a miss and on a hit, for
    the box arm (the one with the FCHKs) and the sphere arm, with the
    divisions' slow paths (a region holding a CALL) skipped, as a lane
    with finite, normal inputs skips them. A diagnostic read from the
    instruction listing, not a measurement."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for fn, ins in funcs.items():
        at = {off: i for i, (off, _) in enumerate(ins)}

        def target(text):
            m = re.search(r"BRA(?:\.\w+)*\s+(?:!?U?P\d,\s*)?`?\(?\.?L?_?x?_?\d*\)?\s*0x([0-9a-f]+)",
                          text)
            return int(m.group(1), 16) if m else None

        def has(lo, hi, op):  # an `op` in instructions [lo, hi)
            return any(op in t for _, t in ins[lo:hi])

        loops = [(at[target(t)], i) for i, (_, t) in enumerate(ins)
                 if "BRA" in t and target(t) is not None and target(t) <= ins[i][0]
                 and target(t) in at]
        loops = [(a, b) for a, b in loops if has(a, b, "FCHK")]
        if not loops:
            continue
        a, b = min(loops, key=lambda lb: lb[1] - lb[0])

        # where the arms join: the furthest forward branch target in the loop
        join = max((target(t) for _, t in ins[a:b] if "BRA" in t and target(t) is not None
                    and ins[a][0] < target(t) <= ins[b][0]), default=ins[b][0])

        def walk(start, arm, hit):
            """Instructions one lane issues from `start` to the loop's
            back branch: at the first other conditional branch into the
            loop the arm `arm` (0 falls through, 1 branches); past a slow
            path (a short region with a CALL); at the first branch to the
            join (the hit test) past the hit's code unless `hit`; through
            any other conditional branch (a division's fast path)."""
            i, n, typed, tested = start, 0, False, False
            while i <= b and n < 10 * len(ins):
                off, t = ins[i]
                n += 1
                tgt = target(t) if "BRA" in t else None
                if i == b or tgt is None or tgt not in at or tgt <= off:
                    i += 1
                    continue
                j = at[tgt]
                if not t.startswith("@"):
                    i = j
                elif tgt == join and not tested:
                    tested = True
                    i = i + 1 if hit else j
                elif j <= i + 8 and has(i + 1, j, "CALL"):
                    i = j
                elif not typed and tgt != join:
                    typed = True
                    i = j if arm else i + 1
                else:
                    i += 1
            return n

        # which arm holds the divisions (the box's): the type branch's
        # fall-through or its target
        first = next(i for i in range(a, b) if ins[i][1].startswith("@") and "BRA" in ins[i][1]
                     and target(ins[i][1]) in at and ins[i][0] < target(ins[i][1]) != join
                     and not (at[target(ins[i][1])] <= i + 8
                              and has(i + 1, at[target(ins[i][1])], "CALL")))
        box_arm = 0 if has(first + 1, at[target(ins[first][1])], "FCHK") else 1
        counts = {}
        for arm, what in ((box_arm, "box"), (1 - box_arm, "sphere")):
            counts[f"{what}_miss"] = walk(a, arm, False)
            counts[f"{what}_hit"] = walk(a, arm, True)
        out[fn] = dict(static=len(ins), sweep_loop=b - a + 1,
                       fchk=sum("FCHK" in t for _, t in ins[a:b + 1]), **counts)
    return out


def sweep_hits(ds, cam, iteration) -> dict:
    """Per camera ray of `iteration` (AA, pinhole) the analytic geoms of
    each kind and those its ray hits (t > 0), from the plain tests: what a
    lane of #2 sweeps."""
    from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays
    from project3_cuda_path_tracer_tpu_torch.ops.intersect import (
        box_intersect,
        sphere_intersect,
    )

    o, d, _ = generate_rays(cam, iteration, True, False)
    P = d.x.shape[0]
    out = {"box": 0, "box_hits": 0.0, "sphere": 0, "sphere_hits": 0.0}
    for i, g in enumerate(ds.gtypes):
        if g == 0:
            t = sphere_intersect(ds.transform[i], ds.inverse_transform[i],
                                 ds.inv_transpose[i], o, d)[0]
        elif g == 1:
            t = box_intersect(ds.transform[i], ds.inverse_transform[i], o, d)[0]
        else:
            continue
        kind = "sphere" if g == 0 else "box"
        out[kind] += 1
        out[f"{kind}_hits"] += float((t > 0).sum()) / P
    return out


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sweep_ops(ds) -> int:
    """The analytic sweep's operations per lane (mesh geoms not counted)."""
    return sum(OPS_SPHERE_TEST if g == 0 else OPS_BOX_TEST
               for g in ds.gtypes if g != 2)


def listed_per_depth(rb, depth, iteration=2) -> list:
    """#7's list count at each depth of one iteration of big-mesh Renderer
    `rb` (its camera, AA), the pool advanced by the kernels' bounce."""
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.render import RenderSettings, _camera_pool

    settings = RenderSettings(trace_depth=depth, antialias=True)
    pool = _camera_pool(rb.dev_camera, iteration, settings)
    listed = []
    for d in range(depth):
        cands = pl.mesh_candidates(pool[0], pool[1], pool[4], rb.dev_scene, tables=rb.tables)
        listed.append(int(cands.count[0]))
        pool = pl.bounce_step_pipeline(pool, rb.dev_scene, iteration, d, settings,
                                       tables=rb.tables)
    return listed


def mesh_depths(r, depth_n, iteration=2):
    """One iteration of Renderer `r`'s mesh path (its camera, AA, depth
    depth_n) driven by the kernels, #7 -> #8 [-> A -> B -> C -> D per big
    geom] -> #9 at every depth, holding D and #9 at each depth against
    their plain versions on that depth's own inputs (the lane rule on the
    listed lanes' hits and the pool, #9's pix exactly), and counting #9's
    work (its live lanes, the warps of 32 lanes and the 32-byte sectors of
    a lane array that hold one, the candidates) and D's (its listed lanes,
    the real entries, the lanes whose mesh hit it replaced). Returns
    ({kernel: (worst share, max_abs_err)}, {count: [per depth]})."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.render import RenderSettings, _camera_pool

    settings = RenderSettings(trace_depth=depth_n, antialias=True)
    ds, tables = r.dev_scene, r.tables
    pool = _camera_pool(r.dev_camera, iteration, settings)
    worst = {}
    work = {k: [] for k in ("lanes_in", "warps_with_live", "sectors_with_live",
                            "candidates", "listed", "entries", "hits")}
    for depth in range(depth_n):
        o, d, live = pool[0], pool[1], pool[4] != 0
        work["lanes_in"].append(int(live.sum()))
        for k, w in (("warps_with_live", 32), ("sectors_with_live", 8)):
            pad = torch.nn.functional.pad(live, (0, -live.shape[0] % w))
            work[k].append(int(pad.view(-1, w).any(1).sum()))
        cands = pl.mesh_candidates(o, d, pool[4], ds, tables=tables)
        hits = pl.mesh_sweep(o, d, cands, ds, tables=tables)
        n = int(cands.count[0])
        listed = cands.lanes[:n].long()
        work["candidates"].append(n)
        entries = merged = 0
        for g in pl.sorted_geoms(ds):
            sk = pl.super_keys(o, d, cands, hits, ds, g, tables=tables)
            st = pl.place_entries(sk, cands.count)
            eh = pl.window_sweep(st, sk, ds, g, tables=tables)
            want = pl.merge_entries_reference(o, d, cands, clone_hits(hits), sk, eh, ds, g)
            before = hits.t.clone()
            pl.merge_entries(o, d, cands, hits, sk, eh, ds, g, tables=tables)
            torch.cuda.synchronize()
            r_d = lane_rule([a[listed] for a in hit_lanes(hits)],
                            [a[listed] for a in hit_lanes(want)])
            worst["merge_entries"] = tuple(max(a, b) for a, b in zip(
                worst.get("merge_entries", (0.0, 0.0)), r_d))
            entries += int(st.total[0])
            merged += int((hits.t[listed] != before[listed]).sum())
        if pl.sorted_geoms(ds):
            work["listed"].append(n)
            work["entries"].append(entries)
            work["hits"].append(merged)
        # the plain #9 reads every lane's analytic hit, #7 writes the live
        # lanes' alone: a dead lane's is a miss here
        plain_cands = cands._replace(
            t=torch.where(live, cands.t, -1.0),
            normal=type(o)(*(torch.where(live, c, 0.0) for c in cands.normal)),
            material_id=torch.where(live, cands.material_id, -1),
            outside=cands.outside | ~live, cand=cands.cand & live)
        want9 = pl.bounce_step_mesh_reference(pool, plain_cands, hits, ds, iteration, depth,
                                              settings)
        pl.bounce_step_mesh(pool, cands, hits, ds, iteration, depth, settings, tables=tables)
        torch.cuda.synchronize()
        g9, w9 = mk.pool_lanes(pool), mk.pool_lanes(want9)
        if not torch.equal(g9[13], w9[13]):
            raise RuntimeError(f"bounce_step_mesh: pix differs at depth {depth}")
        r9 = lane_rule(g9[:13], w9[:13])
        worst["bounce_step_mesh"] = tuple(max(a, b) for a, b in zip(
            worst.get("bounce_step_mesh", (0.0, 0.0)), r9))
    for k, (w, _) in worst.items():
        if w > LANE_FRAC:
            raise RuntimeError(f"{k} disagrees with its plain version on {w:.2%} of "
                               f"lanes at a depth of the kernels' iteration")
    return worst, {k: v for k, v in work.items() if v}


def moving_cornell(tmpdir) -> str:
    """scenes/cornell.txt with its sphere moving (VELOCITY 2 0 0)."""
    text = open(os.path.join(HERE, "scenes", "cornell.txt")).read()
    head, sep, tail = text.rpartition("sphere\n")
    lines = tail.split("\n")
    # after the sphere's material/TRANS/ROTAT/SCALE lines
    lines.insert(4, "VELOCITY    2 0 0")
    path = os.path.join(tmpdir, "cornell_moving.txt")
    with open(path, "w") as f:
        f.write(head + sep + "\n".join(lines))
    return path


def surface_ops(ds, isect, dirs, alive) -> int:
    """The surface stage's operations in one bounce of a pool over its
    Intersections: OPS_FILE_TEX per live lane that hits a file-textured
    material, OPS_BUMP per one that hits a bump-mapped one and, with an
    env map, OPS_ENV_FETCH per live lane that escapes."""
    live = alive != 0
    hit = live & (isect.t > 0)
    mat = isect.material_id.clamp(min=0).long()
    n = (int((hit & (ds.mat_tex_kind[mat] == 2)).sum()) * OPS_FILE_TEX
         + int((hit & (ds.mat_bump_id[mat] >= 0)).sum()) * OPS_BUMP)
    if ds.has_env_map:
        n += int((live & ~(isect.t > 0)).sum()) * OPS_ENV_FETCH
    return n


def mesh_cache_parity(dev, res, iteration=2):
    """#4's twin over the first-bounce cache of mesh_textured: the pinhole
    camera rays, their Intersections through #7 -> #8 -> #10 (the quad's
    OBJ UVs), the kernel against its plain version on them. compare()'s
    numbers and the lanes with UVs."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.render import _camera_pool

    ds, cam, settings = on_card(dev, "mesh_textured.txt", {"cache_first_bounce": True},
                                res)
    pool = _camera_pool(cam, iteration, settings)
    isect = pl.intersect_pipeline(pool[0], pool[1], None, ds)
    got = mk.shade_step(pool, isect, ds, iteration, 0, settings)
    want = mk.shade_step_reference(pool, isect, ds, iteration, 0, settings)
    torch.cuda.synchronize()
    return compare(mk.pool_lanes(got), mk.pool_lanes(want)) + (int(isect.has_uv.sum()),)


def material_sort_check(dev, ds, cam, tables, iteration=2, D=8):
    """The material sort on the card at every depth of one iteration driven
    by the kernels (`_sorted_bounce`'s steps, AA): the depth's launches
    (one #7 and one #10, #8 and A-D on a mesh scene, one radix_split digit
    pass per 8 key bits, one #4, and nothing else); the sorted pool and
    Intersections exactly those permuted by a stable torch.sort of the
    keys; on an analytic scene #7 -> #10 against plain `intersect_scene`
    by the lane rule; #4 on the sorted pool bit for bit the sorted #4
    output of the unsorted pool. Returns ((worst lane share, max_abs_err)
    of #7 -> #10, or None on a mesh scene; the launches of one depth)."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.ops.sweep import intersect_scene
    from project3_cuda_path_tracer_tpu_torch.render import (
        RenderSettings,
        _camera_pool,
        _maybe_sort_by_material,
        _permute_isect,
        _permute_state,
        intersect_scene_any,
        material_key_bits,
        material_keys,
    )

    settings = RenderSettings(trace_depth=D, antialias=True, sort_by_material=True)
    bits = material_key_bits(ds)
    n_sorted = len(pl.sorted_geoms(ds))
    want_l = dict(NO_LAUNCHES, mesh_candidates=1, intersect_mesh=1, shade_step=1,
                  radix_split=len(pl.radix_passes(bits)))
    if ds.mesh_geoms:
        want_l.update(mesh_sweep=1, **dict.fromkeys(SORTED_KERNELS, n_sorted))
        if pl.SORT_RADIX:
            raise RuntimeError("material_sort_check runs the counting route")
    pool = _camera_pool(cam, iteration, settings)
    worst = (0.0, 0.0)
    for depth in range(D):
        reset_launches()
        isect = intersect_scene_any(pool[0], pool[1], ds, settings, alive=pool[4],
                                    tables=tables)
        state, sisect = _maybe_sort_by_material(pool, isect, ds, settings)
        got = mk.shade_step(state, sisect, ds, iteration, depth, settings, tables=tables)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != want_l:
            raise RuntimeError(f"sorted depth {depth}: launches {launches}, expected {want_l}")
        perm = torch.sort(material_keys(pool, isect, bits), stable=True).indices
        for g, w in zip(mk.pool_lanes(state) + hit_lanes(sisect),
                        mk.pool_lanes(_permute_state(pool, perm))
                        + hit_lanes(_permute_isect(isect, perm))):
            if not torch.equal(g, w):
                raise RuntimeError(f"material sort at depth {depth}: the permuted "
                                   "pool differs from a stable torch.sort's")
        if not ds.mesh_geoms:
            r = isect_rule(isect, intersect_scene(pool[0], pool[1], ds))
            worst = tuple(max(a, b) for a, b in zip(worst, r))
        base = mk.shade_step(pool, isect, ds, iteration, depth, settings, tables=tables)
        for g, w in zip(mk.pool_lanes(got), mk.pool_lanes(_permute_state(base, perm))):
            if not torch.equal(g, w):
                raise RuntimeError(f"shade_step on the sorted pool at depth {depth} "
                                   "differs from the sorted shade_step output")
        pool = got
    return (None if ds.mesh_geoms else worst), {k: v for k, v in want_l.items() if v}


def isect_rule(got, want):
    """(worst share of lanes off, max_abs_err) of two Intersections by the
    rule for hit distances of tests/test_torch_ops.py: t within 1e-5 +
    1e-5 |t| (world distances reach ~30), the normal within 1e-3 (a t an
    ulp-scale apart moves a sphere hit's point and so its normal by more
    than 1e-4 near grazing), material, side and UVs exactly; each share
    held to LANE_FRAC by the caller."""
    shares, err = [], 0.0
    for g, w, tol in zip(hit_lanes(got), hit_lanes(want),
                         [None] + [ISECT_NORMAL_ATOL] * 3 + [0.0] * 5):
        d = (g.double() - w.double()).abs()
        if tol is None:
            tol = 1e-5 + 1e-5 * w.double().abs()
        shares.append(float((d > tol).float().mean()))
        err = max(err, float(d.max()))
    return max(shares), err


def device_ms_by_name(fn, n, top=6) -> dict:
    """The device ms per call of fn() (n calls under torch.profiler) of
    its `top` costliest device events, by name (cut to 60 characters)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    agg = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            agg[e.name[:60]] = agg.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / n / 1e3
    return dict(sorted(agg.items(), key=lambda kv: -kv[1])[:top])


def sort_costs(r, it=7, n=20) -> dict:
    """On a sorted cell's Renderer, the pool entering depth 1 of iteration
    `it` (after the kernels' depth 0) and its Intersections: device ms per
    call (the profiler's busy time over n calls) of the material sort (the
    keys, the digit counts and the radix_split pass), of one stable
    torch.sort of the same keys (the library call) and of the 23 gathers
    of the pool and its hits; the sort's costliest device events by name;
    the plain split's ms; the split's bound."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.render import (
        _camera_pool,
        _permute_isect,
        _permute_state,
        _sorted_bounce,
        intersect_scene_any,
        material_key_bits,
        material_keys,
    )

    ds, settings, tables = r.dev_scene, r.settings, r.tables
    pool = _sorted_bounce(_camera_pool(r.dev_camera, it, settings), ds, it, 0, settings,
                          tables=tables)
    isect = intersect_scene_any(pool[0], pool[1], ds, settings, alive=pool[4], tables=tables)
    bits = material_key_bits(ds)
    key = material_keys(pool, isect, bits)
    perm = pl.sort_permutation(key, bits).long()
    P = key.shape[0]

    def sorts():
        for _ in range(n):
            pl.sort_permutation(material_keys(pool, isect, bits), bits)

    def library():
        for _ in range(n):
            torch.sort(key, stable=True)

    def gathers():
        for _ in range(n):
            _permute_state(pool, perm)
            _permute_isect(isect, perm)

    sort_busy, sort_kernels, _, sort_events = profile_device(sorts, n)
    by_name = device_ms_by_name(sorts, n)
    lib_busy = profile_device(library, n)[0]
    gather_busy = profile_device(gathers, n)[0]
    count = torch.full((1,), P, dtype=torch.int32, device=key.device)
    iota = torch.arange(P, dtype=torch.int32, device=key.device).view(1, P)

    def plain_sort():
        k, payload = key, iota
        for shift, width in pl.radix_passes(bits):
            st = pl.radix_split_reference(pl.RadixSplit(k, count, shift, width=width),
                                          payload)
            k, payload = st.key, st.payload

    plain = event_ms(plain_sort, 3)
    passes = len(pl.radix_passes(bits))
    return {"sort_ms": sort_busy, "split_ms": sort_kernels.get("radix_split@pass"),
            "sort_device_events": sort_events, "sort_ms_by_event": by_name,
            "torch_sort_ms": lib_busy,
            "gathers_ms": gather_busy, "plain_split_ms": plain, "key_bits": bits,
            "passes": passes, "live_lanes": int((key != (1 << bits) - 1).sum()),
            # per pass: each key and payload word read once, written once
            "bound": bound(16 * P * passes, OPS_RADIX * P * passes)}


def surface_work(dev, it=7, D=8):
    """The plain versions' times and the bounds of the surface stage's
    twins at their paths' shapes (phase 6): textured.txt 800x800 d8 AA
    (#1 over SURFACE_RUN iterations, #2, #3 per depth, #4 under the cache,
    #6 over SURFACE_RUN iterations and #5 per depth under --nee) and
    mesh_textured.txt 800x800 d8 AA (#9 per depth). Each bound is the
    untextured kernel's (the same bytes; the operations of the lanes this
    run's plain path shades) plus the surface stage's operations of the
    lanes that take it (`surface_ops`). Returns ({twin: plain ms per
    launch}, {twin: (bound ms, bound by)}, {count: value})."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.models.device import (
        camera_to_device,
        scene_to_device,
    )
    from project3_cuda_path_tracer_tpu_torch.models.scene import load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays
    from project3_cuda_path_tracer_tpu_torch.ops.sweep import intersect_scene
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
    from project3_cuda_path_tracer_tpu_torch.render import RenderSettings

    scene = load_scene(os.path.join(HERE, "scenes", "textured.txt"))
    ds = scene_to_device(scene, dev)
    cam = camera_to_device(scene.state.camera, dev)
    P = scene.state.camera.pixel_count
    settings = RenderSettings(trace_depth=D, antialias=True)
    per_lane = sweep_ops(ds) + OPS_NORMAL + OPS_SHADE
    n_an = sum(1 for g in ds.gtypes if g != 2)
    plain, bounds = {}, {}
    # the plain per-bounce path of one iteration: #2's and #3's lanes, times
    # and the surface stage's operations at each depth
    pool = mk.first_bounce_reference(ds, cam, it, settings)
    o, d, _ = generate_rays(cam, it, True, False)
    surf = [surface_ops(ds, intersect_scene(o, d, ds), d, torch.ones(P, device=dev))]
    plain["first_bounce@surface"] = event_ms(
        lambda: mk.first_bounce_reference(ds, cam, it, settings), 3)
    lanes_in, bs_plain = [P], 0.0
    for depth in range(1, D):
        lanes_in.append(int((pool[4] != 0).sum()))
        surf.append(surface_ops(ds, intersect_scene(pool[0], pool[1], ds), pool[1], pool[4]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool = mk.bounce_step_reference(pool, ds, it, depth, settings)
        torch.cuda.synchronize()
        bs_plain += 1e3 * (time.perf_counter() - t0) / (D - 1)
    plain["bounce_step@surface"] = bs_plain
    bounds["first_bounce@surface"] = bound(
        56 * P, P * (OPS_RAYGEN_AA - 2 * OPS_DRAW + sweep_ops(ds) - n_an * OPS_ORIGIN
                     + OPS_WINNER_NORMAL + OPS_SHADE) + n_an * OPS_ORIGIN + surf[0])
    bounds["bounce_step@surface"] = bound(
        sum(4 * P + 104 * n for n in lanes_in[1:]) / (D - 1),
        (sum(n * per_lane for n in lanes_in[1:]) + sum(surf[1:])) / (D - 1))
    # #1 over SURFACE_RUN iterations (its profiled launch), these lanes each
    plain["full_iteration@surface"] = event_ms(lambda: plain_run(
        mk.full_iteration_reference, ds, cam, 2, settings, SURFACE_RUN), 1)
    bounds["full_iteration@surface"] = bound(
        24 * P * SURFACE_RUN,
        SURFACE_RUN * (P * OPS_RAYGEN_AA + sum(lanes_in) * per_lane + sum(surf)))
    # #4 over the pinhole rays' cached depth 0 (80 B in, 12 of them UVs,
    # 52 B out a lane)
    cache_settings = RenderSettings(trace_depth=D, cache_first_bounce=True)
    o, d, pix = generate_rays(cam, it, False, False)
    pool0 = (Vec3(*(c.contiguous() for c in o)), d, Vec3.ones(P, dev), Vec3.zeros(P, dev),
             torch.ones(P, dtype=torch.int32, device=dev), pix)
    isect = intersect_scene(o, d, ds)
    plain["shade_step@surface"] = event_ms(
        lambda: mk.shade_step_reference(pool0, isect, ds, it, 0, cache_settings), 3)
    bounds["shade_step@surface"] = bound(
        144 * P, P * OPS_SHADE + surface_ops(ds, isect, d, pool0[4]))
    # #6 and #5 under --nee: the NEE path's lanes (nee_work) and the
    # surface stage's operations of its live lanes at each depth
    nee_settings = RenderSettings(trace_depth=D, antialias=True, nee_mis=True)
    nee_counts, nee_ops, _ = nee_work(ds, cam, it, nee_settings)
    npool, aux = nee_pool(dev, cam, it, nee_settings)
    bn_plain = 0.0
    for depth in range(D):
        nee_ops[depth] += surface_ops(ds, intersect_scene(npool[0], npool[1], ds),
                                      npool[1], npool[4])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        npool, aux = mk.bounce_step_nee_reference(npool, aux, ds, it, depth, nee_settings,
                                                  depth == D - 1)
        torch.cuda.synchronize()
        bn_plain += 1e3 * (time.perf_counter() - t0) / D
    plain["bounce_step_nee@surface"] = bn_plain
    plain["full_iteration_nee@surface"] = event_ms(lambda: plain_run(
        mk.full_iteration_nee_reference, ds, cam, it, nee_settings, SURFACE_RUN), 1)
    bounds["full_iteration_nee@surface"] = bound(
        24 * P, SURFACE_RUN * (P * OPS_RAYGEN_AA + sum(nee_ops)))
    bounds["bounce_step_nee@surface"] = bound(
        sum(4 * P + 120 * n for n in nee_counts["lanes_in"]) / D, sum(nee_ops) / D)
    # #9 on mesh_textured.txt 800x800 d8 AA (mesh_work's counts)
    mscene = load_scene(os.path.join(HERE, "scenes", "mesh_textured.txt"))
    mds = scene_to_device(mscene, dev)
    mcam = camera_to_device(mscene.state.camera, dev)
    mcounts, mplain = mesh_work(mds, mcam, it, settings)
    mc = {k: np.array(v, np.float64) for k, v in mcounts.items()}
    plain["bounce_step_mesh@surface"] = mplain["bounce_step_mesh"]
    bounds["bounce_step_mesh@surface"] = bound(
        np.mean(4 * P + 126 * mc["lanes_in"] + 4 * mc["candidates"]),
        np.mean(mc["lanes_in"] * (OPS_MERGE + OPS_SHADE) + mc["surface_ops"]))
    counts = {"textured_lanes_in": lanes_in, "textured_surface_ops": surf,
              "textured_nee_lanes_in": nee_counts["lanes_in"],
              "mesh_textured_lanes_in": mcounts["lanes_in"],
              "mesh_textured_candidates": mcounts["candidates"],
              "mesh_textured_surface_ops": mcounts["surface_ops"]}
    return plain, bounds, counts


# sharding (parallel/shard.py): the depth of the spp/px checks, and the
# depths of one iteration that the tri check holds on each scene
D_SHARD = 8
TRI_CHECK_DEPTHS = {"mesh.txt": 8, "mesh_big.txt": 8, "mesh_textured.txt": 2}
TRI_KERNELS = {  # the tri-shard tier's entries of the kernels line: wrapper, cell
    "mesh_candidates@tri": ("mesh_candidates", "tri_mesh"),
    "mesh_sweep@tri": ("mesh_sweep", "tri_mesh"),
    "intersect_mesh@tri": ("intersect_mesh", "tri_mesh"),
    "shade_step@tri": ("shade_step", "tri_mesh"),
}


def tri_shard_check(dev, sr, whole, iteration=2, depths=8):
    """The tri-shard tier at each depth of one iteration driven by the
    kernels, with the T shards of `sr` (a ShardedRenderer, tri=T, spp = px
    = 1) on one card: the depth's launches (each shard's #7 -> #8 [-> A-D]
    -> #10 and one #4, nothing else); the merged hits against the plain
    merge of the plain per-slice chains (`intersect_pipeline_reference`)
    and against the unsharded kernels on `whole` (a Renderer of the whole
    scene, the same camera) by the lane rule, with the lanes that differ
    from the unsharded hits in any bit counted; #4 on the merged pool
    against its plain version (lane rule, pix exactly); the merge's device
    ms a call (each depth's hits of the shards' kernels merged 5 times, in
    one profiler session); per shard the plain chain's work
    (live lanes, candidates, BVH nodes and triangles, mesh hits) and the
    plain versions' ms. Returns a dict of these per depth and the worst."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.render import (
        _camera_pool,
        intersect_scene_any,
        merge_isect_shards,
    )

    group = sr.groups[0][0]
    ds0, tables0 = group[0]
    settings = sr.settings
    n_sorted = len(pl.sorted_geoms(ds0))
    want_l = dict(NO_LAUNCHES, mesh_candidates=len(group), mesh_sweep=len(group),
                  intersect_mesh=len(group), shade_step=1,
                  **dict.fromkeys(SORTED_KERNELS, n_sorted * len(group)))
    pool = _camera_pool(sr.cameras[0][0], iteration, settings)
    P = pool[5].shape[0]
    out = {k: [] for k in ("lanes_in", "candidates", "nodes", "tris", "mesh_hits",
                           "lanes_differ_from_unsharded", "uv_lanes")}
    merge_inputs = []
    worst = {k: (0.0, 0.0) for k in ("vs_plain_chains", "vs_unsharded", "shade_step")}
    plain_ms = dict.fromkeys(("mesh_candidates", "mesh_sweep", "intersect_mesh",
                              "shade_step"), 0.0)

    def timed(k, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        plain_ms[k] += 1e3 * (time.perf_counter() - t0) / (depths * (1 if k == "shade_step"
                                                                     else len(group)))
        return res

    for depth in range(depths):
        o, d, alive = pool[0], pool[1], pool[4]
        reset_launches()
        got = intersect_scene_any(o, d, None, settings, alive=alive, shards=group)
        nxt = mk.shade_step(pool, got, ds0, iteration, depth, settings, tables=tables0)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != want_l:
            raise RuntimeError(f"tri depth {depth}: launches {launches}, expected {want_l}")
        plain_hits, n = [], dict.fromkeys(("candidates", "nodes", "tris", "mesh_hits"), 0)
        for sh in group:
            c = timed("mesh_candidates",
                      lambda: pl.mesh_candidates_reference(o, d, alive, sh.scene))  # noqa: B023
            probe = {}
            h = timed("mesh_sweep", lambda: pl.mesh_sweep_reference(  # noqa: B023
                o, d, c, sh.scene, probe=probe))  # noqa: B023
            for g in pl.sorted_geoms(sh.scene):
                sk = pl.super_keys_reference(o, d, c, h, sh.scene, g, pl.SORT_EXPAND)
                st = pl.place_entries_reference(sk, c.count)
                eh = pl.window_sweep_reference(st, sk, sh.scene, g)
                pl.merge_entries_reference(o, d, c, h, sk, eh, sh.scene, g)
            plain_hits.append(timed("intersect_mesh", lambda: pl.merge_hits(c, h)))  # noqa: B023
            n["candidates"] += int(c.count[0])
            n["nodes"] += int(probe["nodes"].sum()) if "nodes" in probe else 0
            n["tris"] += int(probe["tris"].sum()) if "tris" in probe else 0
            n["mesh_hits"] += int((h.t > 0).sum())
        plain = merge_isect_shards(plain_hits)
        unsharded = intersect_scene_any(o, d, whole.dev_scene, whole.settings, alive=alive,
                                        tables=whole.tables)
        for k, want in (("vs_plain_chains", plain), ("vs_unsharded", unsharded)):
            r = lane_rule(hit_lanes(got), hit_lanes(want))
            worst[k] = tuple(max(a, b) for a, b in zip(worst[k], r))
        differ = torch.zeros(P, dtype=torch.bool, device=dev)
        for g, w in zip(hit_lanes(got), hit_lanes(unsharded)):
            differ |= g != w
        want4 = timed("shade_step", lambda: mk.shade_step_reference(  # noqa: B023
            pool, got, ds0, iteration, depth, settings))  # noqa: B023
        if not torch.equal(nxt[5], want4[5]):
            raise RuntimeError(f"shade_step@tri: pix differs at depth {depth}")
        r = lane_rule(mk.pool_lanes(nxt)[:13], mk.pool_lanes(want4)[:13])
        worst["shade_step"] = tuple(max(a, b) for a, b in zip(worst["shade_step"], r))
        # for the merge alone: this depth's hits of each shard's kernels
        merge_inputs.append([pl.intersect_pipeline(o, d, alive, sh.scene, tables=sh.tables)
                             for sh in group])
        for k, v in (("lanes_in", int((alive != 0).sum())),
                     ("lanes_differ_from_unsharded", int(differ.sum())),
                     ("uv_lanes", int(got.has_uv.sum())), *n.items()):
            out[k].append(v)
        pool = nxt
    reps = 5
    merge_ms = profile_device(lambda: [merge_isect_shards(h) for h in merge_inputs
                                       for _ in range(reps)], reps * depths)[0]
    for k, (share, _) in worst.items():
        if share > LANE_FRAC:
            raise RuntimeError(f"tri shards: {k} off on {share:.2%} of lanes")
    return dict(per_depth=out, worst=worst, plain_ms=plain_ms, merge_ms=merge_ms,
                launches_per_depth={k: v for k, v in want_l.items() if v}, P=P)


def shard_cell(sr, n_calls=10, by_depth=()):
    """Time a ShardedRenderer through step_batch: 2 calls of warm-up, then
    `n_calls` calls timed by the host clock (synchronised); the launches of
    all; the device busy ms per iteration, each kernel's device ms per
    launch and the device events per iteration (the profiler over 4
    calls). Returns the cell's numbers."""
    import torch

    reset_launches()
    spp = sr.spp
    sr.step_batch(2 * spp)
    sr.synchronize()
    t0 = time.perf_counter()
    sr.step_batch(n_calls * spp)
    sr.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if v}
    img = sr.image()
    mean = float(img.mean() / sr.iteration)
    if not (np.isfinite(img).all() and 0.05 < mean < 2.0):
        raise RuntimeError(f"shard cell: bad image (mean {mean})")
    n_it = n_calls * spp
    ms = 1e3 * dt / n_it
    busy, kms, seen, events = profile_device(lambda: sr.step_batch(4 * spp), 4 * spp,
                                             by_depth=by_depth)
    torch.cuda.synchronize()
    return dict(ms_per_frame=ms, iterations_timed=n_it, launches=launches,
                iterations=sr.iteration, device_busy_ms_per_iteration=busy,
                device_idle_share=max(0.0, 1.0 - busy / ms), kernel_device_ms=kms,
                profiled_launches={k: v for k, v in seen.items() if v},
                device_events_per_iteration=events,
                device_events_per_depth=events / sr.settings.trace_depth,
                mean_radiance=mean)


def shard_phase(dev, big, goldens, smi):
    """Sharding (parallel/shard.py) with every shard on the one card `dev`:
    spp=2 and px=2 on Cornell 800x800 d8 AA (their launches; spp against
    Renderer.step() at the same samples, rtol 1e-6; px exactly the whole
    frame through the same route, and by the image rule against step()),
    tri=2 at every depth of one iteration on mesh.txt and mesh_big 800x800
    AA and at two depths on mesh_textured (`tri_shard_check`), the goldens
    at 128x128 of Cornell spp=2 and px=2 and mesh.txt and mesh_big tri=2,
    and the cells (ak)-(an) (`shard_cell`). `big`: the loaded big-mesh
    Renderers. Returns ({scene: tri ShardedRenderer}, {scene: its check},
    {cell: its numbers})."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.models.scene import load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
    from project3_cuda_path_tracer_tpu_torch.parallel.shard import ShardedRenderer
    from project3_cuda_path_tracer_tpu_torch.render import (
        Renderer,
        RenderSettings,
        trace_paths,
    )

    t_shard = time.perf_counter()
    pair = [dev, dev]
    c_scene = load_scene(os.path.join(HERE, "scenes", "cornell.txt"))
    c_set = RenderSettings(trace_depth=D_SHARD, antialias=True)
    rc = Renderer(c_scene, c_set, device=dev)
    rc.step()
    rc.step()
    c_want = rc.image()
    shard_r = {"spp": ShardedRenderer(c_scene, c_set, spp=2, devices=pair),
               "px": ShardedRenderer(c_scene, c_set, px=2, devices=pair)}
    whole = Vec3.zeros(c_scene.state.camera.pixel_count, dev)
    for it in (1, 2):
        rad, _, _, _ = trace_paths(rc.dev_scene, rc.dev_camera, it, None, c_set, False,
                                   tables=rc.tables, pix=torch.arange(
                                       whole.x.shape[0], dtype=torch.int32, device=dev))
        for a, c in zip(whole, rad):
            a.add_(c)
    whole = np.stack([c.cpu().numpy().reshape(800, 800) for c in whole], -1)
    for axis, sr in shard_r.items():
        reset_launches()
        sr.step_batch(2)
        torch.cuda.synchronize()
        got_l = {k: v for k, v in read_launches().items() if v}
        want_l = ({"first_bounce": 2, "bounce_step": 2 * (D_SHARD - 1)} if axis == "spp"
                  else {"bounce_step": 2 * 2 * D_SHARD})
        if got_l != want_l:
            raise RuntimeError(f"--shard {axis}=2: launches {got_l}, expected {want_l}")
        img = sr.image()
        if axis == "spp":
            rel = float(np.max(np.abs(img - c_want) / np.maximum(np.abs(c_want), 1e-6)))
            if not np.allclose(img, c_want, rtol=1e-6, atol=1e-6):
                raise RuntimeError(f"--shard spp=2 off Renderer.step(): max rel {rel}")
            rule = {"against": "Renderer.step() x 2 (#2 -> #3)", "max_rel_err": rel,
                    "rule": "rtol 1e-6, atol 1e-6"}
        else:
            if not np.array_equal(img, whole):
                raise RuntimeError("--shard px=2 differs from the whole frame")
            diff = np.abs(img - c_want)
            rule = {"against": "the whole frame through the same route (camera rays, #3)",
                    "equal": True, "rule": "exact",
                    "against_step": {"share_off_1e-3": float((diff > 1e-3).mean()),
                                     "median": float(np.median(diff)),
                                     "rule": f"share<{PARITY_FRAC}, median<{PARITY_MEDIAN}"}}
            if (diff > PARITY_BAD).mean() >= PARITY_FRAC or np.median(diff) >= PARITY_MEDIAN:
                raise RuntimeError(f"--shard px=2 off Renderer.step(): {rule}")
        say("shard_check", axis=f"{axis}=2", scene="cornell.txt", res="800x800",
            depth=D_SHARD, settings={"antialias": True}, devices=[str(d) for d in pair],
            launches=got_l, **rule)
    # tri=2: every depth of one iteration on mesh.txt and mesh_big at
    # 800x800 AA (and mesh_textured, for the UVs through the merge)
    tri_r, tri_checks = {}, {}
    for name in ("mesh.txt", "mesh_big.txt", "mesh_textured.txt"):
        t0 = time.perf_counter()
        scene = load_scene(os.path.join(HERE, "scenes", name))
        t_set = RenderSettings(trace_depth=D_SHARD, antialias=True)
        sr = ShardedRenderer(scene, t_set, tri=2, devices=pair)
        t_load = time.perf_counter() - t0
        if name in big:
            w = big[name]
            w.set_camera(camera_at(w.camera, scene.state.camera.resolution))
        else:
            w = Renderer(scene, t_set, device=dev)
        chk = tri_shard_check(dev, sr, w, depths=TRI_CHECK_DEPTHS[name])
        tri_r[name], tri_checks[name] = sr, chk
        if name == "mesh_textured.txt" and not any(chk["per_depth"]["uv_lanes"]):
            raise RuntimeError("mesh_textured tri=2: no merged lane has UVs")
        say("tri_shard_check", scene=name, res="800x800", settings={"antialias": True},
            tri=2, devices=[str(d) for d in pair], depths=TRI_CHECK_DEPTHS[name],
            slices_triangles=[sh.scene.tri_ranges for sh in sr.groups[0][0]],
            sorted_geoms=[list(pl.sorted_geoms(sh.scene)) for sh in sr.groups[0][0]],
            launches_per_depth=chk["launches_per_depth"],
            worst={k: {"outlier_share": v[0], "max_abs_err": v[1]}
                   for k, v in chk["worst"].items()},
            rule=f"lane rule: share(|d|>{LANE_ATOL})<={LANE_FRAC}; shade_step pix exact",
            per_depth=chk["per_depth"], plain_ms=chk["plain_ms"],
            merge_device_ms_per_call=chk["merge_ms"], load_seconds=t_load,
            seconds=time.perf_counter() - t0)
    # the goldens at 128x128: Cornell spp=2 and px=2, mesh.txt and mesh_big
    # tri=2 (the ShardedRenderers above, at 128x128)
    g_scene = small_scene("cornell.txt", (128, 128))
    g_set = RenderSettings(trace_depth=8)
    g_runs = [("cornell.txt", "spp=2", ShardedRenderer(g_scene, g_set, spp=2, devices=pair)),
              ("cornell.txt", "px=2", ShardedRenderer(g_scene, g_set, px=2, devices=pair))]
    for name in ("mesh.txt", "mesh_big.txt"):
        sr = tri_r[name]
        sr.settings = replace(sr.settings, trace_depth=8, antialias=False)
        sr.set_camera(camera_at(sr.camera, (128, 128)))
        g_runs.append((name, "tri=2", sr))
    for name, axis, sr in g_runs:
        sr.step_batch(2)
        img = sr.image()
        if sr.iteration != 2 or not (np.isfinite(img).all() and img.max() > 0):
            raise RuntimeError(f"{name} --shard {axis}: bad render")
        diff = np.abs(np.clip(img / 2, 0.0, 1.0) - goldens[name].astype(np.float32))
        badfrac = float((diff > GOLDEN_BAD).mean())
        say("golden", config=name, settings={}, route=f"ShardedRenderer({axis}).step_batch",
            badfrac=badfrac, mad=float(diff.mean()), rule=f"badfrac<={GOLDEN_FRAC}")
        if badfrac > GOLDEN_FRAC:
            raise RuntimeError(f"{name} --shard {axis}: badfrac {badfrac} > {GOLDEN_FRAC}")
    # the cells, 800x800 d8 AA through step_batch, both shards on this card:
    # (ak) Cornell spp=2, (al) px=2, (am) mesh.txt tri=2, (an) mesh_big tri=2
    shard_cells = {}
    cell_runs = [("shard_spp", "cornell.txt", shard_r["spp"], ("bounce_step",)),
                 ("shard_px", "cornell.txt", shard_r["px"], ("bounce_step",)),
                 ("tri_mesh", "mesh.txt", tri_r["mesh.txt"], ("shade_step",)),
                 ("tri_big_mesh", "mesh_big.txt", tri_r["mesh_big.txt"], ("shade_step",))]
    for label, name, sr, by_depth in cell_runs:
        sr.settings = replace(sr.settings, trace_depth=8, antialias=True)
        sr.set_camera(camera_at(sr.camera, (800, 800)))
        cell = shard_cell(sr, by_depth=by_depth)
        if name in tri_checks:
            cell["merge_ms_per_depth"] = tri_checks[name]["merge_ms"]
        shard_cells[label] = cell
        say("shard_cell", path=label, scene=name, res="800x800", depth=8,
            settings={"antialias": True}, shards={"spp": sr.spp, "px": sr.px, "tri": sr.tri},
            devices=[str(d) for d in sr.devices], device=smi, **cell)
    say("shard_phase", seconds=time.perf_counter() - t_shard)
    return tri_r, tri_checks, shard_cells


def tri_kernel_entries(tri_r, tri_checks, shard_cells, smi) -> dict:
    """The kernels line's `<wrapper>@tri` entries from cell (am), mesh.txt
    tri=2: each shard's #7, #8 and #10 and #4 on the merged pool, their
    device ms per launch and launches from the cell's run, their plain
    versions' ms and their bounds per launch averaged over the checked
    depths and the shards, from the plain chains' counts
    (`tri_shard_check`); #7, #8 and #10 are held as one chain (the merged
    hits against the plain merge of the plain chains)."""
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk

    tc = tri_checks["mesh.txt"]
    T = len(tri_r["mesh.txt"].groups[0][0])
    t_ds = tri_r["mesh.txt"].groups[0][0][0].scene
    t_P, t_mesh = tc["P"], len(t_ds.mesh_geoms)
    pd = {k: np.array(v, np.float64) for k, v in tc["per_depth"].items()}
    t_table_bytes = sum(a.numel() * a.element_size() for a in mk.pack_mesh_tables(t_ds))
    tri_bounds = {
        # the intersect route: every lane's analytic winner (6 ray lanes in,
        # 22 B out) and alive; per candidate its list entry
        "mesh_candidates@tri": bound(
            np.mean(50 * t_P + 4 * pd["candidates"] / T),
            np.mean(t_P * (sweep_ops(t_ds) + OPS_NORMAL)
                    + pd["lanes_in"] * t_mesh * OPS_CANDIDACY
                    + pd["candidates"] / T * OPS_APPEND)),
        # the tables once; per candidate its list entry, ray, t_a in and
        # 9 lanes (30 B) out
        "mesh_sweep@tri": bound(
            np.mean(t_table_bytes + 62 * pd["candidates"] / T),
            np.mean((pd["candidates"] * t_mesh * OPS_CANDIDACY + pd["nodes"] * OPS_NODE
                     + pd["tris"] * OPS_MT + pd["mesh_hits"] * OPS_MESH_HIT) / T)),
        # every lane's analytic winner in, 9 lanes out; each mesh winner
        "intersect_mesh@tri": bound(np.mean(52 * t_P + 30 * pd["mesh_hits"] / T),
                                    t_P * OPS_MERGE),
        "shade_step@tri": bound(132 * t_P, t_P * OPS_SHADE),
    }
    tcell = shard_cells["tri_mesh"]
    out = {}
    for k, (wname, _) in TRI_KERNELS.items():
        out[k] = {"ms_per_launch": tcell["kernel_device_ms"][wname],
                  "launches": tcell["launches"][wname],
                  "plain_ms": tc["plain_ms"][wname],
                  "bound_ms": tri_bounds[k][0], "bound_by": tri_bounds[k][1],
                  "max_abs_err": tc["worst"]["shade_step" if wname == "shade_step"
                                             else "vs_plain_chains"][1]}
    say("tri_kernels", device=smi, cell="tri_mesh", res="800x800", depth=8, kernels=out,
        err_of_the_chain="#7, #8 and #10 are held as one chain (merged hits against "
                         "the plain merge of the plain chains)")
    return out


def loader_scenes(out_dir: str) -> dict:
    """Two scenes that need the loaders' remainder, written into `out_dir`
    with the port's writers: textured.txt with its stripes replaced by a
    300x200 PNG (resampled to the 256x256 atlas), and envmap.txt with its
    sky replaced by a 300x150 Radiance .hdr (its range kept, resampled to
    the 512x256 table by nearest neighbour). {name: scene path}."""
    from project3_cuda_path_tracer_tpu_torch.utils.image import save_hdr, save_png

    y, x = np.mgrid[0:200, 0:300]
    tex = np.stack([(x * 255) // 299, (y * 255) // 199, ((x // 20 + y // 20) % 2) * 255],
                   -1).astype(np.uint8)
    tex_path = save_png(os.path.join(out_dir, "stripes_300x200"), tex)
    y, x = np.mgrid[0:150, 0:300]
    sky = np.stack([0.2 + 3.0 * (y < 40) * (np.abs(x - 150) < 30), 0.3 + 0.5 * y / 149,
                    0.9 - 0.6 * y / 149], -1).astype(np.float32)
    hdr_path = save_hdr(os.path.join(out_dir, "sky_300x150"), sky)
    assets = os.path.join(HERE, "scenes", "assets") + os.sep
    out = {}
    for name, old, new in (("textured.txt", "assets/stripes.png", tex_path),
                           ("envmap.txt", "assets/sky.png", hdr_path)):
        text = open(os.path.join(HERE, "scenes", name)).read()
        if old not in text:
            raise RuntimeError(f"{name}: no {old} to replace")
        text = text.replace(old, new).replace("assets/", assets)
        path = os.path.join(out_dir, name.replace(".txt", "_loaders.txt"))
        with open(path, "w") as f:
            f.write(text)
        out[name] = path
    return out


def frame_ms(r, n: int, batch: int) -> float:
    """ms per iteration of `r.step_batch(batch)` called n times after one
    warm-up call, closed by a synchronize."""
    import torch

    r.step_batch(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        r.step_batch(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (n * batch)


def step_ms(r, n: int) -> float:
    """ms per `r.step()`, n timed after one warm-up."""
    import torch

    r.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        r.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def last_modules_phase(dev, big, goldens, smi) -> dict:
    """The last modules (ROADMAP §1 modules 5 and 1) on the card:
    --no-pallas (RenderSettings.plain) on cornell, mesh.txt, textured and
    cornell --nee at 128x128, no launch counted, against the goldens and
    the kernel path by the image rule; `validate_tables` on the 21 smoke
    configs; --debug and --debug-nans (every launch checked, every
    stage's output scanned for NaN) on runs that launch every wrapper,
    clean, and a planted NaN named with its kernel; a texture resampled
    from 300x200 and a .hdr env map through the TexTables kernels against
    their plain versions; the viewer's frame loop for 3 frames; the CLI's
    --debug, --debug-nans, --no-pallas and --preview (under Agg, if
    matplotlib imports); the cost of each mode on the main cell and on
    (a). Returns the timing line's numbers."""
    import logging

    import torch

    from project3_cuda_path_tracer_tpu_torch import viewer
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.parallel.shard import ShardedRenderer
    from project3_cuda_path_tracer_tpu_torch.render import (
        Renderer,
        RenderSettings,
        _device_tables,
    )
    from project3_cuda_path_tracer_tpu_torch.utils import debug

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_modules_")

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.text = []

        def emit(self, record):
            self.text.append(record.getMessage())

    lines = Lines()
    logging.getLogger("pathtracer").addHandler(lines)
    logging.getLogger("pathtracer").setLevel(logging.INFO)

    # --no-pallas on the card
    for name, kw, key in (("cornell.txt", {}, "cornell.txt"), ("mesh.txt", {}, "mesh.txt"),
                          ("textured.txt", {}, "textured.txt"),
                          ("cornell.txt", {"nee_mis": True}, "cornell.txt_--nee")):
        scene = small_scene(name, (128, 128))
        imgs, counts = {}, {}
        for plain in (False, True):
            lines.text.clear()
            r = Renderer(scene, RenderSettings(trace_depth=min(scene.state.trace_depth or 8, 8),
                                               plain=plain, **kw), device=dev)
            reset_launches()
            r.step_batch(2)
            counts[plain] = sum(read_launches().values())
            imgs[plain] = r.image()
            said = any("no kernel is launched" in t for t in lines.text)
            if said != plain:
                raise RuntimeError(f"--no-pallas {name}: log {lines.text}")
        if counts[True] != 0 or counts[False] == 0:
            raise RuntimeError(f"--no-pallas {name} {kw}: launches {counts}")
        diff = np.abs(np.clip(imgs[True] / 2, 0.0, 1.0) - goldens[key].astype(np.float32))
        badfrac = float((diff > GOLDEN_BAD).mean())
        frac, med, err = compare([torch.from_numpy(imgs[True])], [torch.from_numpy(imgs[False])])
        rule = NEE_PARITY_FRAC if kw.get("nee_mis") else PARITY_FRAC
        say("no_pallas", config=key, res="128x128", launches_plain=counts[True],
            launches_kernels=counts[False], golden_badfrac=badfrac,
            vs_kernels={"badfrac": frac, "median": med, "max_abs_err": err},
            rule=f"golden<={GOLDEN_FRAC}; frac(|d|>{PARITY_BAD})<{rule}, median<{PARITY_MEDIAN}")
        if badfrac > GOLDEN_FRAC or not (frac < rule and med < PARITY_MEDIAN):
            raise RuntimeError(f"--no-pallas {key}: golden {badfrac}, vs kernels {frac} {med}")

    # validate_tables on the 21 smoke configs (the tables the kernels read)
    t0 = time.perf_counter()
    checked = []
    for name in dict.fromkeys(n for n, _, _ in SMOKE):
        r = Renderer(small_scene(name, (64, 64)), RenderSettings(nee_mis=name in (
            "cornell.txt", "many_materials.txt", "textured.txt")), device=dev)
        debug.validate_tables(r.dev_scene, r.tables)
        checked.append(name)
    for name in BIG_SCENES:
        debug.validate_tables(big[name].dev_scene, big[name].tables)
        checked.append(name)
    say("validate_tables", configs=len(SMOKE) + len(BIG_SCENES), scenes=checked,
        seconds=time.perf_counter() - t0, result="clean")

    # --debug and --debug-nans over runs that launch every wrapper
    launched = set()
    debug_runs = [("cornell.txt", {"antialias": True}, None), ("cornell.txt", {"nee_mis": True}, None),
                  ("mesh.txt", {"cache_first_bounce": True}, None), ("mesh.txt", {"nee_mis": True}, None),
                  ("textured.txt", {}, None), ("mesh_big.txt", {"antialias": True}, "counting"),
                  ("mesh_big.txt", {"antialias": True}, "radix"),
                  ("cornell.txt", {"sort_by_material": True}, None), ("mesh.txt", {}, "tri=2")]
    for name, kw, how in debug_runs:
        t0 = time.perf_counter()
        if name in big:
            r = big[name]
            r.settings = RenderSettings(trace_depth=8, **kw)
            r.set_camera(camera_at(r.camera, (64, 64)))
        elif how == "tri=2":
            r = ShardedRenderer(small_scene(name, (64, 64)), RenderSettings(trace_depth=8, **kw),
                                tri=2, devices=[dev, dev])
        else:
            r = Renderer(small_scene(name, (64, 64)), RenderSettings(trace_depth=8, **kw),
                         device=dev)
        pl.SORT_RADIX, flag = how == "radix", pl.SORT_RADIX
        reset_launches()
        try:
            with debug.checks(launches=True, nans=True):
                debug.bounds_sweep(r)
                r.step_batch(2)
                if how != "tri=2":
                    r.step()
        finally:
            pl.SORT_RADIX = flag
        counts = {k: v for k, v in read_launches().items() if v}
        launched |= set(counts)
        say("debug_checks", config=name, settings=kw, route=how, modes="--debug --debug-nans",
            res="64x64", launches=counts, result="clean", seconds=time.perf_counter() - t0)
    missing = set(KERNELS) - launched
    if missing:
        raise RuntimeError(f"the debug runs launched no {sorted(missing)}")
    if "mesh_big.txt" in big:  # back to its own settings and size
        big["mesh_big.txt"].settings = RenderSettings(trace_depth=8)
        big["mesh_big.txt"].set_camera(camera_at(big["mesh_big.txt"].camera, (128, 128)))
    # a NaN planted in a material colour: the first kernel to shade it names it
    planted = {}
    for route in ("step", "step_batch"):
        r = Renderer(small_scene("cornell.txt", (64, 64)), RenderSettings(trace_depth=8),
                     device=dev)
        r.dev_scene.mat_color.x[1] = float("nan")
        r.tables = _device_tables(r.dev_scene, r.settings)
        try:
            with debug.checks(nans=True):
                r.step() if route == "step" else r.step_batch(1)
            raise RuntimeError(f"the planted NaN ({route}) was not caught")
        except FloatingPointError as e:
            planted[route] = str(e)
    want = {"step": "stage first_bounce (kernel)", "step_batch": "stage full_iteration (kernel)"}
    for route, msg in planted.items():
        if want[route] not in msg or "aten." not in msg:
            raise RuntimeError(f"the planted NaN ({route}): {msg}")
    say("debug_nans_planted", config="cornell.txt", res="64x64", messages=planted)

    # the loaders on the card: a resampled texture, a .hdr env map
    paths = loader_scenes(tmp)
    try:
        from PIL import Image

        from project3_cuda_path_tracer_tpu_torch.utils.image import read_png
        from project3_cuda_path_tracer_tpu_torch.utils.resample import resize_bilinear

        png = read_png(os.path.join(tmp, "stripes_300x200.png"))
        pillow = bool(np.array_equal(
            resize_bilinear(png, 256, 256),
            np.asarray(Image.fromarray(png, "RGB").resize((256, 256), Image.BILINEAR))))
    except ImportError as e:
        pillow = f"Pillow not importable ({e})"
    for name, path in paths.items():
        for res in ((64, 64), (800, 800)):
            imgs, counts = {}, {}
            for plain in (False, True):
                r = Renderer(small_scene(name, res, path), RenderSettings(trace_depth=8, plain=plain),
                             device=dev)
                reset_launches()
                r.step_batch(2)
                counts[plain] = {k: v for k, v in read_launches().items() if v}
                imgs[plain] = torch.from_numpy(r.image())
            frac, med, err = compare([imgs[False]], [imgs[True]])
            if counts[True] or counts[False] != {"full_iteration": 1}:
                raise RuntimeError(f"{name} loaders: launches {counts}")
            check_parity("full_iteration@surface", {
                "config": os.path.basename(path), "res": f"{res[0]}x{res[1]}",
                "asset": "texture 300x200 resampled" if "textured" in name
                else ".hdr env map 300x150", "launches": counts[False],
                "resample_equals_pillow": pillow}, frac, med, err)

    # the viewer's frame loop without a display
    r = Renderer(small_scene("cornell.txt", (128, 128)), RenderSettings(trace_depth=8), device=dev)
    reset_launches()
    frames = [viewer.next_frame(r, 2) for _ in range(3)]
    if r.iteration != 6 or read_launches()["full_iteration"] != 3 or any(
            f.shape != (128, 128, 3) or f.dtype != np.uint8 or f.max() == 0 for f in frames):
        raise RuntimeError("viewer frame loop")
    say("viewer", frames=3, batch=2, iteration=r.iteration, launches=read_launches()["full_iteration"])

    # the CLI: the four flags at 64x64, the processes at once
    scene_path = os.path.join(tmp, "cornell64.txt")
    with open(scene_path, "w") as f:
        f.write(open(os.path.join(HERE, "scenes", "cornell.txt")).read()
                .replace("RES         800 800", "RES         64 64"))
    try:
        import matplotlib  # noqa: F401

        mpl = True
    except ImportError:
        mpl = False
    runs = [["--debug"], ["--debug-nans"], ["--no-pallas"]] + ([["--preview"]] if mpl else [])
    procs = []
    for extra in runs:
        out_dir = tempfile.mkdtemp(prefix="cli_", dir=tmp)
        procs.append((extra, out_dir, subprocess.Popen(
            [sys.executable, "-m", PKG, scene_path, "--iterations", "16", "--out-dir", out_dir,
             *extra], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, MPLBACKEND="Agg"))))
    want = {"--debug": "bounds sweep clean", "--debug-nans": "checked for NaN",
            "--no-pallas": "no kernel is launched", "--preview": "render complete"}
    try:
        for extra, out_dir, proc in procs:
            _, err = proc.communicate(timeout=300)
            pngs = [f for f in os.listdir(out_dir) if f.endswith(".16samp.png")]
            if proc.returncode != 0 or len(pngs) != 1 or want[extra[0]] not in err:
                raise RuntimeError(f"CLI {extra} exited {proc.returncode}, wrote "
                                   f"{os.listdir(out_dir)}: {err[-3000:]}")
            say("cli", scene="cornell.txt", res="64x64", flags=extra, rc=proc.returncode,
                png=pngs[0])
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    say("cli_preview", matplotlib_imports=mpl, ran=mpl)

    # the cost of each mode: the main cell and (a), in turns with the flags off
    main = Renderer(small_scene("cornell.txt", (800, 800)),
                    RenderSettings(trace_depth=8, antialias=True), device=dev)
    per = Renderer(small_scene("cornell.txt", (800, 800)),
                   RenderSettings(trace_depth=8, antialias=True), device=dev)
    timing = {"main_ms_per_frame": {}, "a_step_ms": {}}
    for mode in ("off", "debug", "debug_nans", "off_again"):
        with debug.checks(launches=mode == "debug", nans=mode == "debug_nans"):
            timing["main_ms_per_frame"][mode] = frame_ms(main, 8, 25)
            timing["a_step_ms"][mode] = step_ms(per, 10)
    plain = Renderer(small_scene("cornell.txt", (800, 800)),
                     RenderSettings(trace_depth=8, antialias=True, plain=True), device=dev)
    reset_launches()
    timing["main_ms_per_frame"]["no_pallas"] = frame_ms(plain, 2, 2)
    timing["no_pallas_launches"] = sum(read_launches().values())
    if timing["no_pallas_launches"]:
        raise RuntimeError(f"--no-pallas launched kernels: {read_launches()}")
    say("modes_cost", device=smi, cell="cornell-800-d8-aa", depth=8, settings={"antialias": True},
        main_route="step_batch(25)", a_route="step()", **timing)
    logging.getLogger("pathtracer").removeHandler(lines)
    shutil.rmtree(tmp, ignore_errors=True)
    say("last_modules_phase", seconds=time.perf_counter() - t_phase)
    return timing


def shard_phase_main() -> int:
    """`--shard-phase`: the shard phase alone, in a process of its own
    (the kernels built by the caller): its lines, then one JSON object
    {"shard_phase": {"tri_kernels": ..., "cells": ...}} as the last line.
    In the script's own process the profiler saw no device activity for
    the rest of the run after this phase (three tries, twice), though no
    part of the phase did that alone; here no profile follows it."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.ops import _native
    from project3_cuda_path_tracer_tpu_torch.render import Renderer, RenderSettings

    _native.load()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    goldens = np.load(os.path.join(HERE, "tools", "goldens", "smoke_128.npz"))
    big = {"mesh_big.txt": Renderer(small_scene("mesh_big.txt", (128, 128)),
                                    RenderSettings(trace_depth=8), device=dev)}
    tri_r, tri_checks, cells = shard_phase(dev, big, goldens, smi)
    entries = tri_kernel_entries(tri_r, tri_checks, cells, smi)
    print(json.dumps({"shard_phase": {"tri_kernels": entries, "cells": cells}}), flush=True)
    return 0


def run_shard_phase() -> dict:
    """`shard_phase_main` in a process of its own: its lines relayed, its
    result returned; a failure there raises here."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--shard-phase"],
                         cwd=HERE, capture_output=True, text=True, timeout=900)
    lines = res.stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(ln, flush=True)
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"the shard phase exited {res.returncode}: {res.stderr[-3000:]}")
    return json.loads(lines[-1])["shard_phase"]


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass-other", metavar="DIR",
                    help="another checkout: hold every kernel function both trees "
                         "have to the same SASS (tools/torch_sass_diff.py)")
    ap.add_argument("--sass-allow", metavar="REGEX",
                    help="with --sass-other: the functions (source:symbol, as "
                         "tools/torch_sass_diff.py names them) whose SASS may "
                         "differ, those a change redesigns")
    ap.add_argument("--shard-phase", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.shard_phase:
        sys.path.insert(0, HERE)
        return shard_phase_main()
    sys.path.insert(0, HERE)
    from project3_cuda_path_tracer_tpu_torch.models.device import (
        advance_time,
        camera_to_device,
        scene_to_device,
    )
    from project3_cuda_path_tracer_tpu_torch.models.scene import GeomType, load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import _native
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.ops.camera import generate_rays
    from project3_cuda_path_tracer_tpu_torch.ops.sweep import intersect_scene
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
    from project3_cuda_path_tracer_tpu_torch.render import (
        Renderer,
        RenderSettings,
        _nee_final_step,
        shutter_time,
        trace_paths,
        whole_kernel,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_")

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

    # ---- 2. build every kernel from this checkout's sources ----
    # (the registers, shared memory and stack frames of A, B, C, D, #1,
    # #3, #7, #8, #9, #5, #6 and the radix kernels from ptxas, compiled
    # beside the build)
    ptxas_of = (("sorted.cu", "window_sweep|place_entries|super_keys|merge_entries"),
                ("bounce.cu", "bounce_step_kernel|first_bounce_kernel"),
                ("full_iteration.cu", "full_iteration"),
                ("mesh.cu", "mesh_sweep|mesh_candidates|bounce_step_mesh"),
                ("nee.cu", "nee_kernel"),
                ("radix.cu", "radix_"))
    ptxas = {src: ptxas_verbose(nvcc, f"{PKG}/csrc/{src}", tmpdir)
             for src, _ in ptxas_of}
    probe_build = build_probe(nvcc, tmpdir, "raygen_probe", RAYGEN_PROBE)
    div_build = build_probe(nvcc, tmpdir, "div_probe", DIV_PROBE)
    lib_paths, build_s = _native.build(force=True)
    _native.load()
    usage = "not measured"
    fb_sass = {}
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if os.path.exists(cuobjdump):
        lines = []
        for p in lib_paths:
            res = subprocess.run([cuobjdump, "--dump-resource-usage", str(p)],
                                 capture_output=True, text=True, timeout=60)
            lines += [ln.strip() for ln in res.stdout.splitlines()
                      if "REG" in ln or "Function" in ln]
        usage = " | ".join(lines) or "cuobjdump printed no resource usage"
        # #2's sweep in its SASS, for the diagnostic beside its bound
        (bounce_lib,) = (p for p in lib_paths if "bounce" in os.path.basename(str(p)))
        fb_sass = sweep_sass(subprocess.run([cuobjdump, "-sass", str(bounce_lib)],
                                            capture_output=True, text=True, timeout=120,
                                            check=True).stdout, "first_bounce_kernel")
    say("build", nvcc_wall_seconds=build_s,
        libraries=[os.path.relpath(p, HERE) for p in lib_paths],
        resource_usage=usage)
    ptx = {}
    for src, kernel in ptxas_of:
        ptx.update(ptxas_usage(ptxas[src], kernel))
        say("ptxas", source=f"{PKG}/csrc/{src}", flags="-Xptxas -v",
            **{kernel: {k: v for k, v in ptx.items() if re.search(kernel, k)}})
    # the kernels' SASS against another checkout's (with --sass-other): every
    # function both trees have must be the same, but those --sass-allow
    # names; the surface stage's twins may be new
    allow = re.compile(args.sass_allow) if args.sass_allow else None
    if args.sass_other:
        res = subprocess.run([sys.executable, os.path.join(HERE, "tools", "torch_sass_diff.py"),
                              "--other", args.sass_other], capture_output=True, text=True,
                             timeout=900, cwd=HERE)
        if res.returncode != 0:
            raise RuntimeError(f"torch_sass_diff: {res.stderr[-3000:]}")
        diff = json.loads(res.stdout.strip().splitlines()[-1])["sass_vs_other"]
        say("sass_vs_other", other=args.sass_other, allowed=args.sass_allow, functions=diff)
        changed = {k: v for k, v in diff.items() if (v.startswith("differs")
                   and not (allow and allow.search(k))) or v == "only in the other tree"}
        if changed:
            raise RuntimeError(f"kernels' SASS changed: {changed}")
    # #6's registers, for the persistent grid of its lane-use model
    (nee_regs,) = (int(re.search(r"Used (\d+) registers", v).group(1))
                   for k, v in ptx.items()
                   if "full_iteration_nee" in k and "TexTables" not in k and "MeshOf" not in k)

    # ---- 3. every kernel against its plain version on the card ----
    err800 = {}
    for res in ((64, 64), (37, 23)):
        for name, kw in FULL_PARITY:
            *r, off = full_parity(dev, name, kw, res)
            check_parity("full_iteration", {"config": name, "settings": kw,
                                            "res": f"{res[0]}x{res[1]}",
                                            "not_bit_identical": off,
                                            "bit_rule": f"<={FULL_BITS_OFF}",
                                            "per_bounce_kernels": "bit-identical"}, *r)
    *r, off = full_parity(dev, "cornell.txt", {"antialias": True}, (800, 800), 1)
    check_parity("full_iteration", {"config": "cornell.txt",
                                    "settings": {"antialias": True},
                                    "res": "800x800", "not_bit_identical": off,
                                    "bit_rule": f"<={FULL_BITS_OFF}",
                                    "per_bounce_kernels": "bit-identical"}, *r)
    err800["full_iteration"] = r[2]
    for name, kw in BOUNCE_PARITY:
        for kernel, r in bounce_parity(dev, name, kw, (64, 64)).items():
            check_parity(kernel, {"config": name, "settings": kw,
                                  "res": "64x64"}, *r)
    for kernel, r in bounce_parity(dev, "cornell.txt", {"antialias": True},
                                   (800, 800), 1).items():
        check_parity(kernel, {"config": "cornell.txt",
                              "settings": {"antialias": True},
                              "res": "800x800"}, *r)
        err800[kernel] = r[2]
    # #2's paired division: bit for bit IEEE division for every divisor
    say("div_pair_exhaustive", kernel="first_bounce", source=f"{PKG}/csrc/path_common.cuh",
        **div_probe_check(dev, div_build))
    # #5 and #6 (NEE + MIS), at 64x64 and 800x800; the error kept for the
    # kernels line is the main NEE path's (Cornell AA, 800x800)
    for res in ((64, 64), (800, 800)):
        for name, kw, glossy in NEE_PARITY:
            what = {"config": name, "settings": dict(kw, nee_mis=True),
                    "glossy_sphere": glossy, "res": f"{res[0]}x{res[1]}"}
            # one iteration, and a run of iterations in one call (one
            # launch of ITERATIONS_PER_LAUNCH at 64x64)
            r6 = (0.0, 0.0, 0.0)
            for n in (1, mk.ITERATIONS_PER_LAUNCH if res == (64, 64) else NEE_RUN_800):
                # the run of ITERATIONS_PER_LAUNCH at depth NEE_RUN_DEPTH but
                # on the first config (its plain iterations set the cost)
                depth = (NEE_RUN_DEPTH if n == mk.ITERATIONS_PER_LAUNCH
                         and (name, kw, glossy) != NEE_PARITY[0] else 8)
                setup = on_card(dev, name, dict(kw, nee_mis=True), res, depth=depth,
                                glossy=glossy)
                r = full_nee_parity(dev, name, kw, res, glossy, n_iters=n, setup=setup)
                check_parity("full_iteration_nee", dict(what, iterations=n, depth=depth),
                             *r, max_frac=NEE_PARITY_FRAC)
                r6 = tuple(max(a, b) for a, b in zip(r6, r))
            *r5, alive_frac = bounce_nee_parity(dev, name, kw, res, glossy)
            check_parity("bounce_step_nee",
                         dict(what, pix="exact", alive_mismatch=alive_frac,
                              alive_rule=f"<={ALIVE_FRAC}"),
                         *r5, max_frac=NEE_PARITY_FRAC)
            if alive_frac > ALIVE_FRAC:
                raise RuntimeError(f"bounce_step_nee: alive differs on "
                                   f"{alive_frac:.2%} of lanes: {what}")
            if res == (800, 800) and (name, kw, glossy) == NEE_PARITY[0]:
                err800["full_iteration_nee"] = r6[2]
                err800["bounce_step_nee"] = r5[2]
    # #6 against the #5 route, bit for bit on every pixel whose camera ray
    # the plain raygen reproduces, on the same configs and on (h)'s
    # many_materials 1920x1080 RR
    probe = load_raygen_probe(*probe_build)
    for res, name, kw, glossy in ([(r, *c) for r in ((64, 64), (800, 800)) for c in NEE_PARITY]
                                  + [((1920, 1080), "many_materials.txt",
                                      {"russian_roulette": True}, False)]):
        rays_off, pixels_off = nee_route_bits(dev, name, kw, res, glossy, probe)
        say("nee_route_bits", kernels=["full_iteration_nee", "bounce_step_nee"],
            config=name, settings=dict(kw, nee_mis=True), glossy_sphere=glossy,
            res=f"{res[0]}x{res[1]}", camera_rays_differing=rays_off,
            pixels_differing=pixels_off,
            rule="bit-identical on every pixel whose camera ray is; rays differ on <=50%")

    # #7-#10 (the mesh pipeline) on mesh.txt; the error kept for the
    # kernels line is the mesh path's (AA, 800x800)
    for res in ((64, 64), (800, 800)):
        for kw in MESH_PARITY:
            depth = 8 if res == (64, 64) else MESH_PARITY_DEPTH_800
            worst, cand_off = mesh_parity(dev, kw, res, depth=depth)
            what = {"config": "mesh.txt", "settings": kw,
                    "res": f"{res[0]}x{res[1]}", "depths": depth}
            say("mesh_parity", **what, candidate_mismatch=cand_off,
                candidate_rule=f"<={CAND_FRAC}", pix="exact",
                lanes={k: {"outlier_share": w, "max_abs_err": e}
                       for k, (w, e) in worst.items()},
                rule=f"share(|d|>{LANE_ATOL})<={LANE_FRAC}")
            if cand_off > CAND_FRAC:
                raise RuntimeError(f"mesh_candidates: candidacy differs on "
                                   f"{cand_off:.3%} of lanes: {what}")
            for k, (w, e) in worst.items():
                if w > LANE_FRAC:
                    raise RuntimeError(f"{k} disagrees with its plain version "
                                       f"on {w:.2%} of lanes: {what}")
                if res == (800, 800) and kw == {"antialias": True}:
                    err800[k] = e

    # the surface stage's twins (file textures, bump maps, the lat-long env
    # map, SSS) of #1-#6 and #9 against their plain versions; the errors
    # kept for the kernels line are textured.txt's at 800x800 (#9's
    # mesh_textured's, AA)
    for res in ((64, 64), (800, 800)):
        r_s = f"{res[0]}x{res[1]}"
        it = 1 if res == (800, 800) else 3
        for name, kw in SURFACE_PARITY:
            what = {"config": name, "settings": kw, "res": r_s, "stage": "surface"}
            *r, off = full_parity(dev, name, kw, res, it, bits_rule=False)
            check_parity("full_iteration@surface", dict(
                what, not_bit_identical=off, per_bounce_kernels="bit-identical"), *r)
            keep = res == (800, 800) and name == "textured.txt"
            if keep:
                err800["full_iteration@surface"] = r[2]
            for kernel, rr in bounce_parity(dev, name, kw, res, it).items():
                check_parity(f"{kernel}@surface", what, *rr)
                if keep:
                    err800[f"{kernel}@surface"] = rr[2]
        for name, kw in SURFACE_NEE:
            what = {"config": name, "settings": dict(kw, nee_mis=True), "res": r_s,
                    "stage": "surface"}
            r6 = full_nee_parity(dev, name, kw, res, False, n_iters=2)
            check_parity("full_iteration_nee@surface", dict(what, iterations=2), *r6,
                         max_frac=NEE_PARITY_FRAC)
            *r5, alive_frac = bounce_nee_parity(dev, name, kw, res, False)
            check_parity("bounce_step_nee@surface",
                         dict(what, pix="exact", alive_mismatch=alive_frac,
                              alive_rule=f"<={ALIVE_FRAC}"),
                         *r5, max_frac=NEE_PARITY_FRAC)
            if alive_frac > ALIVE_FRAC:
                raise RuntimeError(f"bounce_step_nee@surface: alive differs on "
                                   f"{alive_frac:.2%} of lanes: {what}")
            if res == (800, 800) and name == "textured.txt":
                err800["full_iteration_nee@surface"] = r6[2]
                err800["bounce_step_nee@surface"] = r5[2]
        for kw in SURFACE_MESH:
            worst, cand_off = mesh_parity(dev, kw, res, name="mesh_textured.txt")
            what = {"config": "mesh_textured.txt", "settings": kw, "res": r_s,
                    "stage": "surface (#9)"}
            say("mesh_parity", **what, candidate_mismatch=cand_off,
                candidate_rule=f"<={CAND_FRAC}", pix="exact",
                lanes={k: {"outlier_share": w, "max_abs_err": e}
                       for k, (w, e) in worst.items()},
                rule=f"share(|d|>{LANE_ATOL})<={LANE_FRAC}")
            if cand_off > CAND_FRAC:
                raise RuntimeError(f"mesh_candidates: candidacy differs on "
                                   f"{cand_off:.3%} of lanes: {what}")
            for k, (w, e) in worst.items():
                if w > LANE_FRAC:
                    raise RuntimeError(f"{k} disagrees with its plain version "
                                       f"on {w:.2%} of lanes: {what}")
            if res == (800, 800) and kw == {"antialias": True}:
                err800["bounce_step_mesh@surface"] = worst["bounce_step_mesh"][1]
        *r4, uv_lanes = mesh_cache_parity(dev, res)
        check_parity("shade_step@surface", {"config": "mesh_textured.txt",
                                            "settings": {"cache_first_bounce": True},
                                            "res": r_s, "isect": "#7 -> #8 -> #10",
                                            "lanes_with_uv": uv_lanes}, *r4)
        if not uv_lanes:
            raise RuntimeError("mesh_textured: no cached lane has UVs")

    # A-D (the sorted route, #11-#14's counterparts) on the big-mesh scenes,
    # each loaded once: mesh_big at 64x64 and 800x800 at every depth, bunny
    # at 800x800 depth 0; the error kept for the kernels line is mesh_big's
    # at 800x800 (AA), whose plain route also gives the work counts
    big = {}
    for name in BIG_SCENES:
        t0 = time.perf_counter()
        scene = small_scene(name, (128, 128))
        # built under --nee, so its tables also hold the light pdf model
        # that the NEE paths read; it renders without --nee until a phase
        # sets other settings
        big[name] = Renderer(scene, RenderSettings(trace_depth=8, nee_mis=True), device=dev)
        big[name].settings = RenderSettings(trace_depth=8)
        ds_big = big[name].dev_scene
        say("load", scene=name, seconds=time.perf_counter() - t0,
            triangles=int(scene.triangles.count),
            sorted_geoms=list(pl.sorted_geoms(ds_big)),
            supernodes=[ds_big.super_ranges[g][1] for g in pl.sorted_geoms(ds_big)])
        if not pl.sorted_geoms(ds_big):
            raise RuntimeError(f"{name}: no geom takes the sorted route")
    aa = {"antialias": True}
    for name, res, depths in (("mesh_big.txt", (64, 64), range(8)),
                              ("mesh_big.txt", (800, 800), range(8)),
                              ("bunny.txt", (800, 800), (0,))):
        rb = big[name]
        bcam = camera_to_device(camera_at(rb.scene.state.camera, res), dev)
        split = {} if (name, res) == ("mesh_big.txt", (800, 800)) else None
        worst, work, plain, library, rwork = sorted_parity(
            rb.dev_scene, bcam, RenderSettings(trace_depth=8, **aa),
            tuple(depths), rb.tables, split=split)
        if split:
            w, t = np.array(split["window_ms"]), np.array(split["tail_ms"])
            say("window_sweep_split", config=name, res=f"{res[0]}x{res[1]}",
                settings=aa, device=smi, per_depth=split,
                tail_share=(t / (w + t)).tolist(),
                tail_share_all_depths=float(t.sum() / (w + t).sum()))
        what = {"config": name, "settings": aa, "res": f"{res[0]}x{res[1]}",
                "depths": list(depths), "E": pl.SORT_EXPAND}
        radix = ("route_entries", "route_lanes", "radix_chain")
        say("sorted_parity", **what, keys="exact", stream="exact per key",
            pix="exact",
            lanes={k: {"outlier_share": w, "max_abs_err": e}
                   for k, (w, e) in worst.items() if k not in radix},
            rule=f"share(|d|>{LANE_ATOL})<={LANE_FRAC}")
        # the radix route: the compaction split, each pass, a one-bit pass,
        # the unscatter, the sorted stream and the round trip exact
        # (radix_check raises otherwise); the route against the counting
        # route, the share of entries / lanes not bit-equal
        bits = pl.radix_key_bits(2 * max(rb.dev_scene.super_ranges[g][1]
                                         for g in pl.sorted_geoms(rb.dev_scene)))
        say("radix_parity", **what, bits=bits, passes=pl.radix_passes(bits),
            compaction_split="exact (keys, rays, ids, length, digit histograms)",
            digit_passes="exact", one_bit_pass="exact", unscatter="exact",
            sorted_stream="stable torch.sort gather", round_trip="exact",
            not_bit_equal={k: {"share": worst[k][0], "max_abs_err": worst[k][1]}
                           for k in radix},
            window_sweep_stream={"outlier_share": worst["window_sweep_stream"][0],
                                 "max_abs_err": worst["window_sweep_stream"][1]},
            library_ms=library,
            plain_ms={k: plain[k] for k in RADIX_KERNELS})
        # the radix route's work per checked depth: tiles of the compaction
        # split (over the listed columns) and of each pass, its launches
        # and the look-back's steps and spins (a probed run of the splits)
        say("radix_work", **what, tile=pl.RADIX_TILE, per_depth=rwork,
            steps_per_lookback=float(sum(rwork["lookback_steps"])
                                     / max(1, sum(rwork["lookbacks"]))))
        for k, (w, e) in worst.items():
            if w > LANE_FRAC and k not in radix:
                raise RuntimeError(f"{k} disagrees with its plain version on "
                                   f"{w:.2%} of lanes: {what}")
        if name == "mesh_big.txt" and res == (800, 800):
            for k in SORTED_KERNELS + ("window_sweep_stream",):
                err800[k] = worst[k][1]
            for k in RADIX_KERNELS[:2]:
                err800[k] = 0.0  # held exactly
            big_work, big_plain, big_library = work, plain, library
            cand = np.maximum(np.array(work["candidates"], np.float64), 1)
            ent = np.maximum(np.array(work["entries"], np.float64), 1)
            say("sorted_work", config=name, res="800x800", settings=aa,
                counts=work,
                entries_per_candidate=(np.array(work["entries"]) / cand).tolist(),
                tail_share=(np.array(work["tail_entries"]) / ent).tolist(),
                triangles_per_entry=(np.array(work["tris"]) / ent).tolist(),
                chunks_per_entry=(np.array(work["chunks"]) / ent).tolist(),
                plain_ms=plain)

    # #5 and #6 on mesh scenes (their instantiations on MeshOf, which walk
    # each mesh geom's binary BVH for the hit and the shadow ray) against
    # their plain versions, by the NEE rule, #6 over one iteration; the
    # big-mesh scenes' device scenes from `big`; the errors kept for the
    # kernels line are mesh.txt's (MeshOf<Tables>) and mesh_textured's
    # (MeshOf<TexTables>) at 800x800; then #6 bit for bit against the #5
    # route on mesh.txt
    mesh_nee_kw = {"antialias": True, "nee_mis": True}

    def mesh_nee_setup(name, res, depth=8):
        if name in big:
            ds_m = big[name].dev_scene
            cam_m = camera_to_device(camera_at(big[name].scene.state.camera, res), dev)
            return ds_m, cam_m, RenderSettings(trace_depth=depth, **mesh_nee_kw)
        if name.endswith("#chain"):
            ds_m, cam_m, set_m = on_card(dev, name[:-len("#chain")], mesh_nee_kw, res,
                                         depth=depth)
            return chain_bvh(ds_m, ds_m.mesh_geoms[0], MESH_CHAIN_TRIS), cam_m, set_m
        return on_card(dev, name, mesh_nee_kw, res, depth=depth)

    for name, res, depth in MESH_NEE_PARITY:
        t0 = time.perf_counter()
        setup = mesh_nee_setup(name, res, depth)
        what = {"config": name, "settings": mesh_nee_kw, "res": f"{res[0]}x{res[1]}",
                "depth": depth,
                "mesh_geoms": len(setup[0].mesh_geoms),
                "triangles": int(setup[0].tri_v0.x.shape[0])}
        if name.endswith("#chain"):
            what.update(chain_triangles=MESH_CHAIN_TRIS,
                        binary_nodes=int(setup[0].bvh_first.shape[0]),
                        wide_depth=wide_depth(setup[0]))
        suffix = "@mesh_surface" if name == "mesh_textured.txt" else "@mesh"
        r6 = full_nee_parity(dev, name, {}, res, False, setup=setup)
        check_parity(f"full_iteration_nee{suffix}", dict(what, iterations=1), *r6,
                     max_frac=NEE_PARITY_FRAC)
        *r5, alive_frac = bounce_nee_parity(dev, name, {}, res, False, setup=setup)
        check_parity(f"bounce_step_nee{suffix}",
                     dict(what, pix="exact", alive_mismatch=alive_frac,
                          alive_rule=f"<={ALIVE_FRAC}",
                          seconds=time.perf_counter() - t0),
                     *r5, max_frac=NEE_PARITY_FRAC)
        if alive_frac > ALIVE_FRAC:
            raise RuntimeError(f"bounce_step_nee{suffix}: alive differs on "
                               f"{alive_frac:.2%} of lanes: {what}")
        if res == (800, 800) and name in ("mesh.txt", "mesh_textured.txt"):
            err800[f"full_iteration_nee{suffix}"] = r6[2]
            err800[f"bounce_step_nee{suffix}"] = r5[2]
    for res in ((64, 64), (800, 800)):
        rays_off, pixels_off = nee_route_bits(dev, "mesh.txt", {}, res, False, probe,
                                              setup=mesh_nee_setup("mesh.txt", res))
        say("nee_route_bits", kernels=["full_iteration_nee@mesh", "bounce_step_nee@mesh"],
            config="mesh.txt", settings=mesh_nee_kw, res=f"{res[0]}x{res[1]}",
            camera_rays_differing=rays_off, pixels_differing=pixels_off,
            rule="bit-identical on every pixel whose camera ray is; rays differ on <=50%")

    # ---- 4. the smoke configs against the XLA goldens, both paths ----
    goldens = np.load(os.path.join(HERE, "tools", "goldens", "smoke_128.npz"))
    for name, kw, key in SMOKE:
        for route in ("step_batch", "step"):
            scene = small_scene(name, (128, 128))
            settings = RenderSettings(
                trace_depth=min(scene.state.trace_depth or 8, 8), **kw
            )
            r = Renderer(scene, settings, device=dev)
            if route == "step":
                r.step()
                r.step()
            else:
                r.step_batch(2)
            img = r.image()
            if not (np.isfinite(img).all() and img.max() > 0):
                raise RuntimeError(f"{name}: non-finite or black render")
            diff = np.abs(np.clip(img / 2, 0.0, 1.0) - goldens[key].astype(np.float32))
            badfrac = float((diff > GOLDEN_BAD).mean())
            say("golden", config=key, settings=kw, route=route,
                badfrac=badfrac, mad=float(diff.mean()),
                rule=f"badfrac<={GOLDEN_FRAC}")
            if badfrac > GOLDEN_FRAC:
                raise RuntimeError(f"{key} via {route}: badfrac {badfrac} > {GOLDEN_FRAC}")
    # the big-mesh scenes through the sorted route, each Renderer reused
    # (set_camera resets its accumulator); then through the radix route
    # (SORT_RADIX set here and restored, as the JAX package's
    # tools/ab_bigmesh.py toggles its module constant): all four through
    # step_batch, mesh_big through step() too
    runs = [(name, route, False) for name in BIG_SCENES
            for route in ("step_batch", "step")]
    runs += [(name, "step_batch", True) for name in BIG_SCENES]
    runs += [("mesh_big.txt", "step", True)]
    for name, route, radix in runs:
        rb = big[name]
        rb.set_camera(rb.camera)
        pl.SORT_RADIX, flag = radix, pl.SORT_RADIX
        try:
            if route == "step":
                rb.step()
                rb.step()
            else:
                rb.step_batch(2)
        finally:
            pl.SORT_RADIX = flag
        img = rb.image()
        if not (np.isfinite(img).all() and img.max() > 0):
            raise RuntimeError(f"{name}: non-finite or black render")
        diff = np.abs(np.clip(img / 2, 0.0, 1.0) - goldens[name].astype(np.float32))
        badfrac = float((diff > GOLDEN_BAD).mean())
        say("golden", config=name, settings={}, route=route,
            sort="radix" if radix else "counting", badfrac=badfrac,
            mad=float(diff.mean()), rule=f"badfrac<={GOLDEN_FRAC}")
        if badfrac > GOLDEN_FRAC:
            raise RuntimeError(f"{name} via {route} (radix {radix}): badfrac "
                               f"{badfrac} > {GOLDEN_FRAC}")

    # mesh.txt and mesh_big.txt under --nee at 128x128 (no golden has them):
    # step_batch (#6) and step() (#5) against the plain path's iteration
    # (the plain #6), by the golden rule; and mesh.txt with the icosphere
    # moving under --motion-blur, whose step_batch runs #5 at every depth
    # on the tables re-packed at the shutter time, against the plain #6 on
    # the geoms moved there
    for name in ("mesh.txt", "mesh_big.txt", "moving_mesh"):
        settings = RenderSettings(trace_depth=8, nee_mis=True,
                                  motion_blur=name == "moving_mesh")
        if name in big:  # the loaded Renderer (its tables hold the light pdf model)
            r = big[name]
            r.settings = settings
            r.set_camera(camera_at(r.camera, (128, 128)))
        elif name == "moving_mesh":
            moving = small_scene("mesh.txt", (128, 128))
            moving.geoms.velocity[moving.geoms.gtype == GeomType.MESH] = (2.0, 0.0, 0.0)
            r = Renderer(moving, settings, device=dev)
        else:
            r = Renderer(small_scene(name, (128, 128)), settings, device=dev)
        plain_scene = r.dev_scene
        if settings.motion_blur:
            plain_scene = advance_time(r.dev_scene, shutter_time(1))
        plain = plain_run(mk.full_iteration_nee_reference, plain_scene, r.dev_camera, 1,
                          settings, 1)
        want = np.stack([a.cpu().numpy() for a in plain], -1).reshape(128, 128, 3)
        for route in ("step_batch",) if settings.motion_blur else ("step_batch", "step"):
            r.set_camera(r.camera)
            reset_launches()
            if route == "step":
                r.step()
            else:
                r.step_batch(1)
            torch.cuda.synchronize()
            got_l = read_launches()
            per_depth = route == "step" or settings.motion_blur
            kernel = "bounce_step_nee" if per_depth else "full_iteration_nee"
            if got_l != dict(NO_LAUNCHES, **{kernel: 8 if per_depth else 1}):
                raise RuntimeError(f"{name} --nee via {route}: launches {got_l}")
            img = r.image()
            if not (np.isfinite(img).all() and img.max() > 0):
                raise RuntimeError(f"{name} --nee: non-finite or black render")
            diff = np.abs(np.clip(img, 0.0, 1.0) - np.clip(want, 0.0, 1.0))
            badfrac = float((diff > GOLDEN_BAD).mean())
            say("mesh_nee_render", config=name,
                settings={"nee_mis": True, "motion_blur": settings.motion_blur}, route=route,
                res="128x128", against="the plain path (plain #6), 1 iteration",
                badfrac=badfrac, mad=float(diff.mean()), launches={kernel: got_l[kernel]},
                rule=f"badfrac<={GOLDEN_FRAC}")
            if badfrac > GOLDEN_FRAC:
                raise RuntimeError(f"{name} --nee via {route}: badfrac {badfrac} > {GOLDEN_FRAC}")

    # ---- 4b. the material sort (--sort-materials): per depth #7 [-> #8 ->
    # A-D] -> #10, a radix_split digit pass by material, #4 over the
    # sorted pool ----
    # the pieces at every depth of an iteration driven by the kernels, at
    # 64x64 and 800x800 (the big-mesh scene from `big`)
    for name in ("cornell.txt", "many_materials.txt", "mesh.txt", "mesh_big.txt"):
        for res in ((64, 64), (800, 800)):
            t0 = time.perf_counter()
            if name in big:
                ds_s, tables_s = big[name].dev_scene, big[name].tables
                cam_s = camera_to_device(camera_at(big[name].scene.state.camera, res), dev)
            else:
                ds_s, cam_s, _ = on_card(dev, name, {}, res)
                tables_s = mk.pack_scene_tables(ds_s)
            isect_r, per_depth = material_sort_check(dev, ds_s, cam_s, tables_s)
            say("material_sort_check", config=name, res=f"{res[0]}x{res[1]}",
                settings={"antialias": True, "sort_by_material": True}, depths=8,
                launches_per_depth=per_depth,
                permutation="exactly a stable torch.sort of the keys (pool and hits)",
                shade_step_on_sorted_pool="bit-identical to the sorted unsorted output",
                analytic_intersect=None if isect_r is None else {
                    "kernels": "mesh_candidates -> intersect_mesh (no mesh geom)",
                    "against": "plain intersect_scene", "outlier_share": isect_r[0],
                    "max_abs_err": isect_r[1],
                    "rule": (f"share(t: |d|>1e-5+1e-5|t|; normal: |d|>{ISECT_NORMAL_ATOL}; "
                             f"material, side, UVs: d!=0)<={LANE_FRAC}")},
                seconds=time.perf_counter() - t0)
            if isect_r is not None and isect_r[0] > LANE_FRAC:
                raise RuntimeError(f"#7 -> #10 on {name} off plain intersect_scene on "
                                   f"{isect_r[0]:.2%} of lanes")
    # the smoke configs without --nee (and the four big-mesh scenes) under
    # --sort-materials against their goldens, through step_batch and step():
    # no whole-iteration, first-bounce, bounce or mesh-bounce kernel runs
    not_sorted = ("full_iteration", "first_bounce", "bounce_step", "bounce_step_mesh",
                  "full_iteration_nee", "bounce_step_nee")
    sort_runs = [(name, kw, key) for name, kw, key in SMOKE if not kw.get("nee_mis")]
    sort_runs += [(name, {}, name) for name in BIG_SCENES]
    for name, kw, key in sort_runs:
        for route in ("step_batch", "step"):
            if name in big:
                r = big[name]
                r.settings = settings = RenderSettings(trace_depth=8, sort_by_material=True)
                r.set_camera(r.camera)
            else:
                scene = small_scene(name, (128, 128))
                settings = RenderSettings(trace_depth=min(scene.state.trace_depth or 8, 8),
                                          sort_by_material=True, **kw)
                r = Renderer(scene, settings, device=dev)
            reset_launches()
            if route == "step":
                r.step()
                r.step()
            else:
                r.step_batch(2)
            torch.cuda.synchronize()
            got_l = read_launches()
            per_depth = 2 * settings.trace_depth
            if any(got_l[k] for k in not_sorted) or got_l["shade_step"] != per_depth \
                    or got_l["radix_split"] != per_depth:
                raise RuntimeError(f"{key} sorted via {route}: launches {got_l}")
            img = r.image()
            if not (np.isfinite(img).all() and img.max() > 0):
                raise RuntimeError(f"{name} sorted: non-finite or black render")
            diff = np.abs(np.clip(img / 2, 0.0, 1.0) - goldens[key].astype(np.float32))
            badfrac = float((diff > GOLDEN_BAD).mean())
            say("golden", config=key, settings=dict(kw, sort_by_material=True), route=route,
                badfrac=badfrac, mad=float(diff.mean()), rule=f"badfrac<={GOLDEN_FRAC}")
            if badfrac > GOLDEN_FRAC:
                raise RuntimeError(f"{key} sorted via {route}: badfrac {badfrac} > "
                                   f"{GOLDEN_FRAC}")
    for name in BIG_SCENES:
        big[name].settings = RenderSettings(trace_depth=8)

    # ---- 4c. sharding (parallel/shard.py), every shard on this one card
    # (a check of the path, not a scale-out): spp=2 and px=2 on Cornell,
    # tri=2 on mesh.txt, mesh_big and mesh_textured; their goldens; cells
    # (ak)-(an) ----
    shard_out = run_shard_phase()

    # ---- 5. the main path at full size: Cornell 800x800 d8 AA, step_batch ----
    scene = load_scene(os.path.join(HERE, "scenes", "cornell.txt"))
    pixels = scene.state.camera.pixel_count
    settings = RenderSettings(trace_depth=8, antialias=True)
    reset_launches()
    r = Renderer(scene, settings, device=dev)
    batch = 25
    r.step_batch(batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        r.step_batch(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    main_launches = read_launches()
    per_batch = -(-batch // mk.ITERATIONS_PER_LAUNCH)  # #1's launches per call
    if main_launches != dict(NO_LAUNCHES, full_iteration=9 * per_batch) \
            or r.iteration != 9 * batch:
        raise RuntimeError(f"main path launches {main_launches} for "
                           f"{r.iteration} iterations")
    img = r.image()
    if img.shape != (800, 800, 3) or not np.isfinite(img).all():
        raise RuntimeError(f"main path image bad: shape {img.shape}")
    mean = float(img.mean() / r.iteration)
    if not 0.05 < mean < 2.0:
        raise RuntimeError(f"main path mean radiance {mean} out of range")
    n_timed = 8 * batch
    ms_per_frame = 1e3 * dt / n_timed
    mrays = pixels * settings.trace_depth * n_timed / dt / 1e6
    # one call as the path makes it: #1's ms per launch covers `batch`
    # iterations
    main_busy, main_kernel_ms, seen, _ = profile_device(lambda: r.step_batch(batch), batch)
    say("profile", path="main", busy_ms_per_iteration=main_busy,
        device_idle_share=max(0.0, 1.0 - main_busy / ms_per_frame),
        kernel_ms=main_kernel_ms,
        profiled_launches={k: n for k, n in seen.items() if n})

    ds = scene_to_device(scene, dev)
    cam = camera_to_device(scene.state.camera, dev)
    mk.full_iteration_reference(ds, cam, 1, settings)  # warm-up
    # the plain version over the `batch` iterations of one main-path call
    # (the work of #1's launch in the kernels line)
    plain_run_ms = event_ms(lambda: plain_run(mk.full_iteration_reference, ds, cam, 2,
                                              settings, batch), 1)
    plain_ms = plain_run_ms / batch
    print(json.dumps({
        "metric": "Mrays/sec (Cornell 800x800 depth-8 AA, one GPU)",
        "value": mrays,
        "unit": "Mrays/s",
        "ms_per_frame": ms_per_frame,
        "time_to_5000spp_s": ms_per_frame * 5000 / 1e3,
        "device": smi,
        "plain_ms_per_frame": plain_ms,
        "kernel_launches": main_launches["full_iteration"],
        "iterations": r.iteration,
        "mean_radiance": mean,
    }), flush=True)
    # #1 at 1x, 2x and 4x the main path's pixels (Cornell AA, its camera at
    # each size), 20 iterations a launch: the persistent warps' last paths
    # end in a tail that does not grow with the pixels, so the time per
    # pixel falls with the size
    scaling = {}
    for side in (800, 1131, 1600):
        sds, scam, sset = on_card(dev, "cornell.txt", {"antialias": True}, (side, side))
        acc = Vec3.zeros(side * side, dev)
        stables = mk.pack_scene_tables(sds)
        mk.full_iteration(sds, scam, 1, sset, acc, n_iters=2, tables=stables)  # warm-up
        ms = event_ms(lambda: mk.full_iteration(  # noqa: B023
            sds, scam, 3, sset, acc, n_iters=20, tables=stables), 3) / 20
        scaling[f"{side}x{side}"] = {"ms": ms, "ns_per_pixel": 1e6 * ms / side**2}
    say("full_iteration_scaling", device=smi, settings={"antialias": True}, depth=8,
        per_size=scaling)

    # ---- 6. the per-bounce and NEE paths at their scenes' own size, depth 8 ----
    D = 8
    paths = [  # (label, scene, scene file or None, settings, route)
        ("step", "cornell.txt", None, {"antialias": True}, "step"),
        ("compact", "cornell.txt", None, {"antialias": True, "compact": True},
         "step_batch"),
        ("cache", "cornell.txt", None, {"cache_first_bounce": True},
         "step_batch"),
        ("motion_blur", "cornell_moving.txt", moving_cornell(tmpdir),
         {"antialias": True, "motion_blur": True}, "step_batch"),
        ("direct_lighting", "cornell.txt", None,
         {"antialias": True, "direct_lighting": True}, "step_batch"),
        ("nee", "cornell.txt", None, {"antialias": True, "nee_mis": True},
         "step_batch"),
        ("nee_step", "cornell.txt", None, {"antialias": True, "nee_mis": True},
         "step"),
        ("many_materials_nee", "many_materials.txt", None,
         {"russian_roulette": True, "nee_mis": True}, "step_batch"),
        ("many_materials_nee_step", "many_materials.txt", None,
         {"russian_roulette": True, "nee_mis": True}, "step"),
        # the mesh path: #7 -> #8 -> #9 at every depth
        ("mesh", "mesh.txt", None, {"antialias": True}, "step_batch"),
        ("mesh_step", "mesh.txt", None, {"antialias": True}, "step"),
        ("mesh_cache", "mesh.txt", None, {"cache_first_bounce": True},
         "step_batch"),
        ("mesh_direct_lighting", "mesh.txt", None,
         {"antialias": True, "direct_lighting": True}, "step_batch"),
        # the big-mesh route: #7 -> #8 -> A -> B -> C -> D -> #9 at every
        # depth, on the Renderers loaded above at their own 800x800
        ("big_mesh", "mesh_big.txt", None, {"antialias": True}, "step_batch"),
        ("big_mesh_step", "mesh_big.txt", None, {"antialias": True}, "step"),
        ("bunny", "bunny.txt", None, {"antialias": True}, "step_batch"),
        # the radix route (SORT_RADIX set for these only): #7 -> #8 -> A ->
        # the compaction split and one 8-bit pass -> C in stream order ->
        # one unscatter -> D -> #9 at every depth
        ("big_mesh_radix", "mesh_big.txt", None, {"antialias": True},
         "step_batch"),
        ("bunny_radix", "bunny.txt", None, {"antialias": True}, "step_batch"),
        # the surface stage's twins: #1 on the texture, env-map and SSS
        # scenes, #9 on mesh_textured, #2 + #3 through step(), #4 under the
        # cache, #6 and #5 under --nee
        ("textured", "textured.txt", None, {"antialias": True}, "step_batch"),
        ("envmap", "envmap.txt", None, {"antialias": True}, "step_batch"),
        ("sss", "cornell_sss.txt", None, {"antialias": True}, "step_batch"),
        ("mesh_textured", "mesh_textured.txt", None, {"antialias": True},
         "step_batch"),
        ("textured_step", "textured.txt", None, {"antialias": True}, "step"),
        ("textured_cache", "textured.txt", None, {"cache_first_bounce": True},
         "step_batch"),
        ("textured_nee", "textured.txt", None, {"antialias": True, "nee_mis": True},
         "step_batch"),
        ("textured_nee_step", "textured.txt", None,
         {"antialias": True, "nee_mis": True}, "step"),
        # --nee on mesh scenes: #6's and #5's instantiations on MeshOf
        # (the binary BVH walks), (aa) mesh.txt through step_batch, (ab)
        # through step(), (ac) mesh_big.txt through step_batch; and on
        # mesh_textured (MeshOf<TexTables>) through both
        ("mesh_nee", "mesh.txt", None, {"antialias": True, "nee_mis": True},
         "step_batch"),
        ("mesh_nee_step", "mesh.txt", None, {"antialias": True, "nee_mis": True},
         "step"),
        ("big_mesh_nee", "mesh_big.txt", None, {"antialias": True, "nee_mis": True},
         "step_batch"),
        ("mesh_textured_nee", "mesh_textured.txt", None,
         {"antialias": True, "nee_mis": True}, "step_batch"),
        ("mesh_textured_nee_step", "mesh_textured.txt", None,
         {"antialias": True, "nee_mis": True}, "step"),
        # --sort-materials: per depth #7 [-> #8 -> A-D] -> #10, the
        # material sort's radix_split digit pass, #4 over the sorted pool;
        # (af) Cornell, (ag) many_materials 1920x1080 RR (32 materials),
        # (ah) mesh.txt, (ai) mesh_big (the counting route), (aj) Cornell
        # with --compact
        ("sort_cornell", "cornell.txt", None,
         {"antialias": True, "sort_by_material": True}, "step_batch"),
        ("sort_many_materials", "many_materials.txt", None,
         {"russian_roulette": True, "sort_by_material": True}, "step_batch"),
        ("sort_mesh", "mesh.txt", None, {"antialias": True, "sort_by_material": True},
         "step_batch"),
        ("sort_big_mesh", "mesh_big.txt", None,
         {"antialias": True, "sort_by_material": True}, "step_batch"),
        ("sort_compact", "cornell.txt", None,
         {"antialias": True, "sort_by_material": True, "compact": True}, "step_batch"),
    ]
    sort_paths = ("sort_cornell", "sort_many_materials", "sort_mesh", "sort_big_mesh",
                  "sort_compact")
    mesh_nee_paths = ("mesh_nee", "big_mesh_nee", "mesh_textured_nee")
    radix_paths = ("big_mesh_radix", "bunny_radix")
    # #3 once a depth: (a)-(e)
    per_bounce = ("step", "compact", "cache", "motion_blur", "direct_lighting")
    one_walk_a_depth = ("mesh", "mesh_step", "big_mesh", "big_mesh_step", "bunny",
                        "big_mesh_radix", "bunny_radix")  # one #7 launch a depth

    def expected_launches(settings, route, calls, mesh, n_sorted=0,
                          splits=None):
        """The launches of the route's calls, `calls` iterations each
        (n_sorted: the scene's geoms on the sorted route, each running A-D
        once per #8; splits: under the radix route, the splits of one #8
        summed over those geoms, each 1 + ceil(bit_length(2 * n_supers) /
        8), which with one unscatter per geom take the place of B and C)."""
        n_it, n_calls = sum(calls), len(calls)
        if settings.nee_mis:
            if route == "step" or settings.motion_blur:
                return dict(NO_LAUNCHES, bounce_step_nee=n_it * D)
            return dict(NO_LAUNCHES, full_iteration_nee=sum(
                -(-n // mk.ITERATIONS_PER_LAUNCH) for n in calls))
        if route == "step_batch" and not mesh and whole_kernel(settings):
            return dict(NO_LAUNCHES, full_iteration=sum(
                -(-n // mk.ITERATIONS_PER_LAUNCH) for n in calls))
        cached = settings.effective_cache()
        bounces = D - 2 if settings.direct_lighting else D - 1
        # the cache filled through #7 [-> #8 -> A-D] -> #10 once per batch
        # (once in all by step()); --direct-lighting's final step
        # intersects twice the same way (#7 -> #10 on an analytic scene)
        fills = (n_calls if route == "step_batch" else 1) if cached else 0
        isects = fills + (2 * n_it if settings.direct_lighting else 0)
        shaded = n_it * (bounces + (0 if cached else 1))
        if settings.sort_by_material:
            # every depth but a cached depth 0 intersects; every depth
            # sorts (one digit pass up to 255 materials) and runs #4
            walks = isects + shaded
            out = dict(NO_LAUNCHES, mesh_candidates=walks, intersect_mesh=walks,
                       shade_step=n_it * (bounces + 1), radix_split=n_it * (bounces + 1))
            if mesh:
                out.update(mesh_sweep=walks, **dict.fromkeys(SORTED_KERNELS, n_sorted * walks))
            return out
        if not mesh:
            return dict(NO_LAUNCHES, first_bounce=0 if cached else n_it,
                        bounce_step=n_it * bounces,
                        shade_step=n_it if cached else 0,
                        mesh_candidates=isects, intersect_mesh=isects)
        # depth 0 through the pipeline too, or #4 over the cache
        walks = isects + shaded
        out = dict(NO_LAUNCHES, mesh_candidates=walks, mesh_sweep=walks,
                   bounce_step_mesh=shaded, intersect_mesh=isects,
                   shade_step=n_it if cached else 0,
                   **dict.fromkeys(SORTED_KERNELS, n_sorted * walks))
        if splits is not None:
            out.update(place_entries=0, window_sweep=0,
                       window_sweep_stream=n_sorted * walks,
                       radix_split=splits * walks, radix_unscatter=n_sorted * walks)
        return out

    launches_of = {}
    kernel_ms_of = {}
    frame_ms_of = {}
    busy_of = {}
    def big_renderer(name, settings):
        """The loaded Renderer of a big-mesh scene, at the scene file's own
        resolution with `settings` (its tables, packed under --nee, serve
        every settings)."""
        rb = big[name]
        rb.settings = settings
        rb.set_camera(camera_at(rb.camera, load_res[name]))
        return rb

    load_res = {name: (800, 800) for name in BIG_SCENES}
    radix_default = pl.SORT_RADIX
    for label, name, path, kw, route in paths:
        settings = RenderSettings(trace_depth=D, **kw)
        reset_launches()
        if name in big:
            r = big_renderer(name, settings)
            scene = r.scene
        else:
            scene = load_scene(path or os.path.join(HERE, "scenes", name))
            r = Renderer(scene, settings, device=dev)
        res = r.camera.resolution
        radix = label in radix_paths
        splits = sum(1 + len(pl.radix_passes(pl.radix_key_bits(
            2 * r.dev_scene.super_ranges[g][1]))) for g in pl.sorted_geoms(r.dev_scene)
                     ) if radix else None

        def run(n):
            pl.SORT_RADIX = radix
            try:
                if route == "step":
                    for _ in range(n):
                        r.step()
                else:
                    r.step_batch(n)
            finally:
                pl.SORT_RADIX = radix_default

        n_warm, n_timed = 5, 40
        run(n_warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n_timed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = read_launches()
        n_it = n_warm + n_timed
        want = expected_launches(settings, route, (n_warm, n_timed),
                                 bool(scene.triangles.count),
                                 len(pl.sorted_geoms(r.dev_scene)), splits)
        if got != want or r.iteration != n_it:
            raise RuntimeError(f"{label}: launches {got}, expected {want}")
        img = r.image()
        mean = float(img.mean() / r.iteration)
        if not (np.isfinite(img).all() and 0.05 < mean < 2.0):
            raise RuntimeError(f"{label}: bad image (mean {mean})")
        launches_of[label] = got
        r.step()  # one more iteration, for its alive counts
        counts = r.last_alive_counts.cpu().tolist()
        ms = 1e3 * dt / n_timed
        # a window of 10 iterations; under --nee through step_batch one
        # launch of #6 of ITERATIONS_PER_LAUNCH iterations; on the surface
        # paths of #1 and #6 one launch of SURFACE_RUN
        n_prof = (mk.ITERATIONS_PER_LAUNCH if settings.nee_mis and route == "step_batch"
                  else 10)
        if label in ("textured", "textured_nee"):
            n_prof = SURFACE_RUN
        if label in mesh_nee_paths:
            n_prof = MESH_NEE_RUN
        # per depth: #7 and #9 where they run once a depth, and the big-mesh
        # routes' kernels
        by_depth = (("mesh_candidates", "bounce_step_mesh") if label in one_walk_a_depth
                    else ())
        if label in per_bounce:
            by_depth += ("bounce_step",)
        if name in BIG_SCENES:
            by_depth += SORTED_KERNELS + ("window_sweep_stream", "radix_split@compaction",
                                          "radix_split@pass", "radix_unscatter")
        if label in sort_paths:
            by_depth = ("mesh_candidates", "intersect_mesh", "shade_step") + tuple(
                k for k in by_depth if k not in ("mesh_candidates", "bounce_step_mesh"))
            if name not in BIG_SCENES:
                by_depth += ("radix_split@pass",)
        busy, kernel_ms_of[label], seen, events = profile_device(
            lambda: run(n_prof), n_prof, by_depth=by_depth)
        frame_ms_of[label], busy_of[label] = ms, busy
        say("path", path=label, scene=name, settings=kw,
            route=f"Renderer.{route}", res=f"{res[0]}x{res[1]}", depth=D,
            sort="radix" if radix else "counting",
            ms_per_frame=ms,
            mrays_per_s=res[0] * res[1] * D * n_timed / dt / 1e6,
            launches=got, iterations=n_it, alive_counts=counts,
            mean_radiance=mean, device_busy_ms_per_iteration=busy,
            device_idle_share=max(0.0, 1.0 - busy / ms),
            kernel_device_ms=kernel_ms_of[label],
            # the launches the profiler saw of the 10 iterations' (when
            # it drops one, the busy time and so the idle share are off)
            profiled_launches={k: n for k, n in seen.items() if n},
            # kernels, memsets and PyTorch's own launches on the device
            device_events_per_iteration=events, device_events_per_depth=events / D)

    # the yardstick (no path of the port): mesh_big 800x800 d8 AA through
    # step_batch with its geom on the dense BVH walk (#7 -> #8 -> #9), the
    # routing threshold raised here only
    threshold = pl.SORT_SUPER_MIN_TRIS
    r = big_renderer("mesh_big.txt", RenderSettings(trace_depth=D, antialias=True))
    pl.SORT_SUPER_MIN_TRIS = 2**31
    try:
        r.tables = mk.pack_scene_tables(r.dev_scene)  # #8 walks the geom again
        reset_launches()
        r.step_batch(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step_batch(40)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = read_launches()
        want = expected_launches(r.settings, "step_batch", (5, 40), True)
        if got != want:
            raise RuntimeError(f"dense-walk yardstick: launches {got}, expected {want}")
        img = r.image()
        if not np.isfinite(img).all():
            raise RuntimeError("dense-walk yardstick: non-finite image")
        busy, walk_ms, seen, _ = profile_device(lambda: r.step_batch(10), 10,
                                             by_depth=("mesh_sweep",))
        say("yardstick", path="mesh_big dense BVH walk (not a path of the port)",
            scene="mesh_big.txt", settings={"antialias": True},
            route="Renderer.step_batch", res="800x800", depth=D,
            ms_per_frame=1e3 * dt / 40, device_busy_ms_per_iteration=busy,
            device_idle_share=max(0.0, 1.0 - busy / (1e3 * dt / 40)),
            kernel_device_ms=walk_ms,
            profiled_launches={k: n for k, n in seen.items() if n},
            sorted_route_ms_per_frame=frame_ms_of["big_mesh"],
            sorted_route_busy_ms_per_iteration=busy_of["big_mesh"],
            radix_route_ms_per_frame=frame_ms_of["big_mesh_radix"],
            radix_route_busy_ms_per_iteration=busy_of["big_mesh_radix"])
    finally:
        pl.SORT_SUPER_MIN_TRIS = threshold
        r.tables = mk.pack_scene_tables(r.dev_scene)

    # the sorted cells (af)-(aj): each beside its unsorted counterpart
    # ((c)'s #4, (j)'s #7), and the sort's own device ms a depth (keys,
    # digit counts, the split) beside one stable torch.sort of the same
    # keys and the gathers', on the pool entering depth 1
    sort_cells = {}
    for label, name, _, kw, route in paths:
        if label not in sort_paths:
            continue
        settings = RenderSettings(trace_depth=D, **kw)
        rs = (big_renderer(name, settings) if name in big else
              Renderer(load_scene(os.path.join(HERE, "scenes", name)), settings, device=dev))
        costs = sort_costs(rs)
        kms = kernel_ms_of[label]
        sort_cells[label] = dict(
            scene=name, settings=kw, res="x".join(map(str, rs.camera.resolution)),
            ms_per_frame=frame_ms_of[label], device_busy_ms_per_iteration=busy_of[label],
            device_idle_share=max(0.0, 1.0 - busy_of[label] / frame_ms_of[label]),
            launches=launches_of[label],
            shade_step_ms=kms.get("shade_step"), intersect_mesh_ms=kms.get("intersect_mesh"),
            mesh_candidates_ms=kms.get("mesh_candidates"), mesh_sweep_ms=kms.get("mesh_sweep"),
            split_ms_per_depth=kms.get("radix_split@pass@depth"), **costs)
    say("material_sort_cells", device=smi, depth=D, cells=sort_cells,
        unsorted={"cache_shade_step_ms": kernel_ms_of["cache"].get("shade_step"),
                  "mesh_mesh_candidates_ms": kernel_ms_of["mesh"].get("mesh_candidates"),
                  "cornell_step_batch_busy_ms": main_busy,
                  "step_busy_ms": busy_of["step"], "mesh_busy_ms": busy_of["mesh"],
                  "big_mesh_busy_ms": busy_of["big_mesh"]},
        bound_by="16 B and OPS_RADIX operations per key and pass")

    # ---- 7. the plain versions and the bounds at the main path's shapes ----
    settings = RenderSettings(trace_depth=D, antialias=True)
    it = 7
    P = pixels
    _, _, _, counts = trace_paths(ds, cam, it, None, settings, False)
    counts = counts.cpu().tolist()
    lanes_in = [P] + counts[:-1]  # live lanes entering each depth
    per_lane = sweep_ops(ds) + OPS_NORMAL + OPS_SHADE
    n_an = sum(1 for g in ds.gtypes if g != 2)
    fb_hits = sweep_hits(ds, cam, it)

    fb_plain = event_ms(lambda: mk.first_bounce_reference(ds, cam, it, settings), 3)
    pool = mk.first_bounce_reference(ds, cam, it, settings)
    bs_plain = 0.0
    length = torch.ones(P, dtype=torch.int64, device=dev)  # depths run, per pixel
    # #3's live lanes per depth, the warps of 32 lanes and the 32-byte
    # sectors of a float lane (8 lanes) that hold one
    bs_live, bs_warps, bs_sectors = [], [], []
    for depth in range(1, D):
        length += (pool[4] != 0).long()
        bs_live.append(int((pool[4] != 0).sum()))
        bs_warps.append(int((pool[4] != 0).view(-1, 32).any(1).sum()))
        bs_sectors.append(int((pool[4] != 0).view(-1, 8).any(1).sum()))
        t0 = time.perf_counter()
        pool = mk.bounce_step_reference(pool, ds, it, depth, settings)
        torch.cuda.synchronize()
        bs_plain += 1e3 * (time.perf_counter() - t0) / (D - 1)
    # #1's lane use with one thread per pixel: warps of 32 consecutive
    # pixels each run as many steps as their longest path; the persistent
    # warps keep every lane on a path until the pixels run out
    warps = length.view(-1, 32)
    steps = int(warps.max(1).values.sum())
    say("lane_use", kernel="full_iteration", config="cornell.txt", res="800x800",
        settings={"antialias": True}, iteration=it, depth=D,
        pixels_by_length=torch.bincount(length, minlength=D + 1)[1:].tolist(),
        lane_bounces=int(length.sum()), share_of_p_x_d=float(length.sum()) / (P * D),
        thread_per_pixel_busy_share=float(length.sum()) / (32 * steps),
        warps_running_all_depths=float((warps.max(1).values == D).float().mean()))
    cache_settings = RenderSettings(trace_depth=D, cache_first_bounce=True)
    origins, dirs, pix = generate_rays(cam, it, False, False)
    pool0 = (Vec3(*(c.contiguous() for c in origins)), dirs, Vec3.ones(P, dev),
             Vec3.zeros(P, dev), torch.ones(P, dtype=torch.int32, device=dev), pix)
    isect_ms = event_ms(lambda: intersect_scene(origins, dirs, ds), 5)
    isect = intersect_scene(origins, dirs, ds)
    ss_plain = event_ms(lambda: mk.shade_step_reference(pool0, isect, ds, it, 0,
                                                        cache_settings), 3)
    # the NEE kernels' plain versions and lanes (Cornell 800x800 d8 AA --nee)
    nee_settings = RenderSettings(trace_depth=D, antialias=True, nee_mis=True)
    nee_counts, nee_ops, nee_length = nee_work(ds, cam, it, nee_settings)
    nee_in = nee_counts["lanes_in"]
    # #6's plain version over one launch's ITERATIONS_PER_LAUNCH
    # iterations, against that launch on the same iterations
    n_run = mk.ITERATIONS_PER_LAUNCH
    runs = {}
    fn_plain_run = event_ms(lambda: runs.update(plain=plain_run(
        mk.full_iteration_nee_reference, ds, cam, it, nee_settings, n_run)), 1)
    fn_plain = fn_plain_run / n_run
    runs["kernel"] = Vec3.zeros(P, dev)
    mk.full_iteration_nee(ds, cam, it, nee_settings, runs["kernel"], n_iters=n_run)
    torch.cuda.synchronize()
    r = compare([a / n_run for a in runs["kernel"]], [a / n_run for a in runs["plain"]])
    check_parity("full_iteration_nee", {"config": "cornell.txt",
                                        "settings": {"antialias": True, "nee_mis": True},
                                        "res": "800x800", "iterations": n_run}, *r,
                 max_frac=NEE_PARITY_FRAC)
    err800["full_iteration_nee"] = max(err800["full_iteration_nee"], r[2])
    pool, aux = nee_pool(dev, cam, it, nee_settings)
    bn_plain = 0.0
    for depth in range(D):
        t0 = time.perf_counter()
        pool, aux = mk.bounce_step_nee_reference(pool, aux, ds, it, depth,
                                                 nee_settings, depth == D - 1)
        torch.cuda.synchronize()
        bn_plain += 1e3 * (time.perf_counter() - t0) / D
    # the same counts on (h) and (i)'s many_materials 1920x1080 RR --nee
    mm_scene = load_scene(os.path.join(HERE, "scenes", "many_materials.txt"))
    mm_ds = scene_to_device(mm_scene, dev)
    mm_cam = camera_to_device(mm_scene.state.camera, dev)
    mm_P = mm_scene.state.camera.pixel_count
    mm_settings = RenderSettings(trace_depth=D, russian_roulette=True, nee_mis=True)
    mm_counts, mm_ops, mm_length = nee_work(mm_ds, mm_cam, it, mm_settings)
    # #6's lane use: one thread per pixel (the path lengths of one plain
    # iteration, warps of 32 consecutive pixels) against the persistent
    # warps' model (`regenerated_busy_share`, as many lanes as #6's grid
    # holds at its registers) over this iteration's paths: also its share
    # for a launch of many iterations whose paths repeat these, and a
    # lower bound for independent paths, whose sums per pixel spread
    # less; #5's warp-slots against live lanes per depth: one
    # thread per slot runs every warp of 32 slots that holds a live one,
    # the packed kernel ceil(live / 32) warps (and at most one more per
    # persistent warp, for its last slots)
    lanes6 = resident_lanes(nee_regs, torch.cuda.get_device_properties(dev).multi_processor_count)
    for (l6, l5), name, res_n, counts_n, length in (
            (("nee", "nee_step"), "cornell.txt", "800x800", nee_counts, nee_length),
            (("many_materials_nee", "many_materials_nee_step"), "many_materials.txt",
             "1920x1080", mm_counts, mm_length)):
        L = length.cpu().numpy()
        say("nee_lane_use", kernel="full_iteration_nee", path=l6, config=name, res=res_n,
            iteration=it, depth=D, device=smi,
            pixels_by_length=np.bincount(L, minlength=D + 1)[1:].tolist(),
            lane_bounces=int(L.sum()), share_of_p_x_d=float(L.sum()) / (L.size * D),
            thread_per_pixel_busy_share=warp_busy_share(length),
            regenerated_busy_share=regenerated_busy_share(L, lanes6),
            model_lanes=lanes6, registers=nee_regs)
        live = np.array(counts_n["lanes_in"], np.int64)
        warps = np.array(counts_n["warps_with_live"], np.int64)
        packed = -(-live // 32)
        say("nee_pack", kernel="bounce_step_nee", path=l5, config=name, res=res_n,
            iteration=it, depth=D, device=smi, live_lanes=live.tolist(),
            thread_per_slot_warps=warps.tolist(), packed_warps=packed.tolist(),
            warp_slots_per_pixel={"thread_per_slot": float(32 * warps.sum()) / L.size,
                                  "packed": float(32 * packed.sum()) / L.size},
            live_lane_bounces_per_pixel=float(live.sum()) / L.size)
    # --direct-lighting's final step alone (plain PyTorch on every device),
    # on the pool entering depth D-1
    dl_settings = RenderSettings(trace_depth=D, antialias=True,
                                 direct_lighting=True)
    pool = mk.first_bounce_reference(ds, cam, it, dl_settings)
    for depth in range(1, D - 1):
        pool = mk.bounce_step_reference(pool, ds, it, depth, dl_settings)
    final_pool = pool[:4] + (pool[4] != 0, pool[5])
    final_ms = event_ms(
        lambda: _nee_final_step(final_pool, ds, it, dl_settings), 5)
    # the plain AA raygen that the #5 route and the mesh path run before
    # their depth 0
    raygen_ms = event_ms(lambda: generate_rays(cam, it, True, False), 5)
    # the mesh kernels' plain versions and lanes (mesh.txt 800x800 d8 AA)
    mesh_scene = load_scene(os.path.join(HERE, "scenes", "mesh.txt"))
    mds = scene_to_device(mesh_scene, dev)
    mcam = camera_to_device(mesh_scene.state.camera, dev)
    mesh_settings = RenderSettings(trace_depth=D, antialias=True)
    mesh_counts, mesh_plain = mesh_work(mds, mcam, it, mesh_settings)
    # #10 at the cache fill: the pinhole camera rays, every lane alive
    morigins, mdirs, _ = generate_rays(mcam, it, False, False)
    fill_cands = pl.mesh_candidates_reference(morigins, mdirs, None, mds)
    fill_hits = pl.mesh_sweep_reference(morigins, mdirs, fill_cands, mds)
    fill_n = int(fill_cands.count[0])
    mesh_plain["intersect_mesh"] = event_ms(
        lambda: pl.merge_hits(fill_cands, fill_hits), 5)
    mesh_table_bytes = sum(a.numel() * a.element_size()
                           for a in mk.pack_mesh_tables(mds))
    mc8 = {k: float(sum(v)) for k, v in mesh_counts.items()}
    walks8 = max(mc8["walks"], 1.0)
    say("mesh_sweep_work", config="mesh.txt", res="800x800", settings={"antialias": True},
        iteration=it, depth=D, per_walk={
            "binary_nodes": mc8["nodes"] / walks8, "binary_tris": mc8["tris"] / walks8,
            "wide_nodes": mc8["wide_nodes"] / walks8,
            "wide_leaves": mc8["wide_leaves"] / walks8,
            "wide_tris": mc8["wide_tris"] / walks8},
        wide_stack_max=max(mesh_counts["wide_stack_max"]),
        slab_ulp_lanes=int(mc8["slab_ulp_lanes"]), candidates=int(mc8["candidates"]),
        bound_from="the binary walk's counts (mesh_bounds), unchanged")
    say("plain_times", device=smi, res="800x800", depth=D,
        first_bounce_plain_ms=fb_plain, bounce_step_plain_ms=bs_plain,
        shade_step_plain_ms=ss_plain, cache_fill_intersect_scene_ms=isect_ms,
        alive_counts=counts, full_iteration_nee_plain_ms=fn_plain,
        full_iteration_nee_plain_ms_per_launch=fn_plain_run,
        full_iteration_plain_ms_per_launch=plain_run_ms,
        bounce_step_nee_plain_ms=bn_plain, nee_lanes=nee_counts,
        nee_ops_per_depth=nee_ops, many_materials_nee_lanes=mm_counts,
        many_materials_nee_ops_per_depth=mm_ops,
        direct_lighting_final_step_ms=final_ms,
        direct_lighting_final_step_lanes=int(final_pool[4].sum()),
        plain_generate_rays_aa_ms=raygen_ms,
        mesh_lanes=mesh_counts, mesh_plain_ms=mesh_plain,
        mesh_cache_fill_candidates=fill_n)
    # #3 per depth on the per-bounce paths beside the pool it meets: (a)'s
    # live lanes, the warps of 32 lanes that hold one (a thread per lane
    # runs each such warp whole) and the warps they pack into (the
    # compacted pool of (b) holds them first), and likewise the 32-byte
    # sectors of a lane array that hold one (each is read and written
    # whole, packed or not); A per depth on (n) and (p)
    # beside its listed lanes (#7's count on a kernels' run of iteration 2)
    say("bounce_step_depths", kernel="bounce_step", device=smi, res="800x800",
        depths=list(range(1, D)),
        ms_per_depth={label: kernel_ms_of[label].get("bounce_step@depth")
                      for label in per_bounce},
        lanes_in=bs_live, warps_with_live=bs_warps,
        packed_warps=[-(-n // 32) for n in bs_live], sectors_with_live=bs_sectors,
        packed_sectors=[-(-n // 8) for n in bs_live],
        lanes_from="the plain version's pools of (a), iteration 7")
    say("super_keys_depths", kernel="super_keys", device=smi, res="800x800",
        settings={"antialias": True}, depths=list(range(D)), per_path={
            label: {"ms_per_depth": kernel_ms_of[label].get("super_keys@depth"),
                    "listed": listed_per_depth(big[name], D)}
            for label, name in (("big_mesh", "mesh_big.txt"), ("bunny", "bunny.txt"))})
    # #9 per depth on (j), (n) and (p) beside the pool it meets, D on (n)
    # and (p) beside its lists, from an iteration driven by the kernels
    # that also holds both against their plain versions at every depth
    depth_paths = {"mesh": Renderer(load_scene(os.path.join(HERE, "scenes", "mesh.txt")),
                                    RenderSettings(trace_depth=D, antialias=True),
                                    device=dev),
                   "big_mesh": big_renderer("mesh_big.txt", RenderSettings(trace_depth=D)),
                   "bunny": big_renderer("bunny.txt", RenderSettings(trace_depth=D))}
    depth_work, depth_worst = {}, {}
    for label, rd in depth_paths.items():
        depth_worst[label], depth_work[label] = mesh_depths(rd, D)
    rule = f"share(|d|>{LANE_ATOL})<={LANE_FRAC}, pix exact"
    say("bounce_step_mesh_depths", kernel="bounce_step_mesh", device=smi, res="800x800",
        settings={"antialias": True}, depths=list(range(D)), per_path={
            label: {"ms_per_depth": kernel_ms_of[label].get("bounce_step_mesh@depth"),
                    **{k: depth_work[label][k] for k in (
                        "lanes_in", "warps_with_live", "sectors_with_live", "candidates")},
                    "against_plain": dict(zip(("outlier_share", "max_abs_err"),
                                              depth_worst[label]["bounce_step_mesh"]))}
            for label in depth_paths}, rule=rule,
        lanes_from="an iteration (2) driven by the kernels")
    say("merge_entries_depths", kernel="merge_entries", device=smi, res="800x800",
        settings={"antialias": True}, depths=list(range(D)), E=pl.SORT_EXPAND, per_path={
            label: {"ms_per_depth": kernel_ms_of[label].get("merge_entries@depth"),
                    **{k: depth_work[label][k] for k in ("listed", "entries", "hits")},
                    "against_plain": dict(zip(("outlier_share", "max_abs_err"),
                                              depth_worst[label]["merge_entries"]))}
            for label in ("big_mesh", "bunny")}, rule=rule,
        lanes_from="an iteration (2) driven by the kernels")
    # the mesh kernels' bounds, per launch averaged over the depths
    n_mesh = len(mds.mesh_geoms)
    mc = {k: np.array(v, np.float64) for k, v in mesh_counts.items()}
    mesh_bounds = {
        # every lane's alive; per live lane 6 ray lanes in, the analytic
        # winner out (22 B); per candidate its list entry
        "mesh_candidates": bound(
            np.mean(4 * P + 46 * mc["lanes_in"] + 4 * mc["candidates"]),
            np.mean(mc["lanes_in"] * (sweep_ops(mds) + OPS_NORMAL
                                      + n_mesh * OPS_CANDIDACY)
                    + mc["candidates"] * OPS_APPEND)),
        # the tables once; per candidate its list entry, ray, t_a in and
        # 9 lanes (30 B) out
        "mesh_sweep": bound(
            np.mean(mesh_table_bytes + 62 * mc["candidates"]),
            np.mean(mc["candidates"] * n_mesh * OPS_CANDIDACY
                    + mc["nodes"] * OPS_NODE + mc["tris"] * OPS_MT
                    + mc["mesh_hits"] * OPS_MESH_HIT)),
        # #3's pool bytes and, per live lane, its candidacy flag, its
        # analytic t and the winner's normal, material and side (22 B);
        # per candidate its mesh t (the other fields are read from the
        # winner's lanes alone)
        "bounce_step_mesh": bound(
            np.mean(4 * P + 126 * mc["lanes_in"] + 4 * mc["candidates"]),
            np.mean(mc["lanes_in"] * (OPS_MERGE + OPS_SHADE))),
        # the cache fill: every lane's analytic winner in, 9 lanes out; the
        # mesh winner of each candidate. The bytes' time is DRAM's; #10
        # runs below it (about 0.0098 against 0.0101 ms on an H100)
        # because #7 and #8 wrote its inputs just before and the 50 MB L2
        # serves them, so it is no kernel at its bound
        "intersect_mesh": bound(52 * P + 30 * fill_n, P * OPS_MERGE),
    }
    bounds = {
        # per launch: the main path's `batch` iterations of one call
        "full_iteration": bound(24 * P * batch,
                                batch * (P * OPS_RAYGEN_AA + sum(lanes_in) * per_lane)),
        # what a pinhole camera needs (two draws; the origin terms once per
        # geom; the winner's normal from its test's own values); the
        # per-lane count P * (OPS_RAYGEN_AA + per_lane) is printed beside
        # it (first_bounce_sass, fb_per_lane_bound_ms)
        "first_bounce": bound(56 * P, P * (OPS_RAYGEN_AA - 2 * OPS_DRAW + sweep_ops(ds)
                                           - n_an * OPS_ORIGIN + OPS_WINNER_NORMAL
                                           + OPS_SHADE) + n_an * OPS_ORIGIN),
        "bounce_step": bound(
            sum(4 * P + 104 * n for n in lanes_in[1:]) / (D - 1),
            sum(n * per_lane for n in lanes_in[1:]) / (D - 1),
        ),
        "shade_step": bound(132 * P, P * OPS_SHADE),
        # per launch of ITERATIONS_PER_LAUNCH iterations: the
        # accumulator read and written once, every iteration's work
        "full_iteration_nee": bound(24 * P, n_run * (P * OPS_RAYGEN_AA + sum(nee_ops))),
        # every lane's alive flag, then 15 lanes read and 15 written per
        # live lane (pool + aux, less alive and pix), averaged over depths
        "bounce_step_nee": bound(sum(4 * P + 120 * n for n in nee_in) / D,
                                 sum(nee_ops) / D),
    }
    # #2's bound with every term per lane, and its sweep's SASS per lane on
    # this run's camera rays (a diagnostic: instructions read from the
    # listing, weighted by the plain tests' hits)
    say("first_bounce_sass", device=smi, bound_ms=bounds["first_bounce"][0],
        bound_by=bounds["first_bounce"][1],
        fb_per_lane_bound_ms=bound(56 * P, P * (OPS_RAYGEN_AA + per_lane))[0],
        geoms_per_lane=fb_hits, sass={
            fn: dict(c, sweep_per_lane=(
                fb_hits["box"] * c["box_miss"]
                + fb_hits["box_hits"] * (c["box_hit"] - c["box_miss"])
                + fb_hits["sphere"] * c["sphere_miss"]
                + fb_hits["sphere_hits"] * (c["sphere_hit"] - c["sphere_miss"])))
            for fn, c in fb_sass.items()})
    # the same on (h) and (i), for PERF.md's ranking
    mm_in = mm_counts["lanes_in"]
    nee_path_bounds = {
        "many_materials_nee": bound(24 * mm_P, n_run * (mm_P * OPS_RAYGEN + sum(mm_ops))),
        "many_materials_nee_step": bound(sum(4 * mm_P + 120 * n for n in mm_in) / D,
                                         sum(mm_ops) / D),
        "nee": bounds["full_iteration_nee"], "nee_step": bounds["bounce_step_nee"],
    }
    say("nee_paths", device=smi, paths={
        label: {"kernel": kernel, "ms_per_launch": kernel_ms_of[label][kernel],
                "launches": launches_of[label][kernel],
                "iterations_per_profiled_launch": n_run if kernel == "full_iteration_nee" else 1,
                "bound_ms": nee_path_bounds[label][0], "bound_by": nee_path_bounds[label][1],
                "device_busy_ms_per_iteration": busy_of[label]}
        for label, kernel in (("nee", "full_iteration_nee"), ("nee_step", "bounce_step_nee"),
                              ("many_materials_nee", "full_iteration_nee"),
                              ("many_materials_nee_step", "bounce_step_nee"))})
    # device ms per launch from the profiles, beside the plain versions
    timing = {
        "full_iteration": (main_kernel_ms["full_iteration"], plain_run_ms,
                           main_launches["full_iteration"]),
        "first_bounce": (kernel_ms_of["step"]["first_bounce"], fb_plain,
                         launches_of["step"]["first_bounce"]),
        "bounce_step": (kernel_ms_of["step"]["bounce_step"], bs_plain,
                        launches_of["step"]["bounce_step"]),
        "shade_step": (kernel_ms_of["cache"]["shade_step"], ss_plain,
                       launches_of["cache"]["shade_step"]),
        # per launch of ITERATIONS_PER_LAUNCH iterations
        "full_iteration_nee": (kernel_ms_of["nee"]["full_iteration_nee"],
                               fn_plain_run,
                               launches_of["nee"]["full_iteration_nee"]),
        "bounce_step_nee": (kernel_ms_of["nee_step"]["bounce_step_nee"],
                            bn_plain,
                            launches_of["nee_step"]["bounce_step_nee"]),
    }
    bounds.update(mesh_bounds)
    for name in MESH_KERNELS[:4]:
        path = "mesh_cache" if name == "intersect_mesh" else "mesh"
        timing[name] = (kernel_ms_of[path][name], mesh_plain[name],
                        launches_of[path][name])
    # the sorted route's bounds, per launch averaged over the depths of
    # mesh_big 800x800 d8 AA (sorted_work's counts of the plain route)
    bds = big["mesh_big.txt"].dev_scene
    (bg,) = pl.sorted_geoms(bds)
    b_sn, b_cn, b_tc = (bds.super_ranges[bg][1], bds.chunk_ranges[bg][1],
                        bds.tri_ranges[bg][1])
    b_p = 800 * 800
    E = pl.SORT_EXPAND
    bw = {k: np.array(v, np.float64) for k, v in big_work.items()}
    bounds.update({
        # per listed lane: list entry, world ray, both t in (36 B), E keys,
        # the object ray and bt0 out; the supernode boxes once
        "super_keys": bound(
            32 * b_sn + np.mean((36 + 4 * E + 28) * bw["candidates"]),
            np.mean(bw["candidates"] * (OPS_OBJ_RAY + b_sn * OPS_SUPER_TEST))),
        # every listed lane's E keys and A's histogram read, each key's
        # cursor read and written, each real entry's key and id and the
        # total out (no slot past the count is read)
        "place_entries": bound(
            np.mean(4 * E * bw["candidates"] + 8 * bw["entries"]) + 24 * b_sn + 4,
            np.mean(OPS_PLACE * bw["entries"])),
        # the geom's triangles (48 B) and chunk boxes once; per entry its
        # key, id and object ray in, (t, triangle, u, v) out
        "window_sweep": bound(
            48 * b_tc + 32 * b_cn + np.mean(48 * bw["entries"]),
            np.mean(OPS_CHUNK_TEST * bw["chunks"] + OPS_MT * bw["tris"])),
        # what D needs: per listed lane its E keys and bt0; per real entry
        # C's t; per lane under its bound its list entry, object ray (24
        # B), the winner's triangle, u and v, its world ray and hit t (68
        # B); per merged hit the corner normals and UVs (64 B) in and 9
        # hit lanes (30 B) out
        "merge_entries": bound(
            np.mean((4 * E + 4) * bw["candidates"] + 4 * bw["entries"]
                    + 68 * bw["under_bound"] + 94 * bw["mesh_hits"]),
            np.mean(OPS_SLOT * E * bw["candidates"]
                    + OPS_MESH_HIT * bw["under_bound"])),
    })
    for name in SORTED_KERNELS:
        timing[name] = (kernel_ms_of["big_mesh"][name], big_plain[name],
                        launches_of["big_mesh"][name])
    # the radix route's bounds, per launch averaged over its launches on
    # (q) mesh_big 800x800 d8 AA: per depth the compaction split (the
    # listed lanes' E keys and rays read once; per real entry its key, ray
    # and id out, 32 B) and `passes` digit passes (per entry 32 B in and 32
    # B out); the unscatter per entry its id and C's 16 B in, 16 B out
    passes = len(pl.radix_passes(pl.radix_key_bits(2 * b_sn)))
    cand, ent = bw["candidates"], bw["entries"]
    splits = 1 + passes
    bounds.update({
        "radix_split": bound(
            np.mean((4 * E * cand + 24 * cand + 32 * ent + 64 * passes * ent) / splits),
            np.mean(OPS_RADIX * (E * cand + passes * ent) / splits)),
        "radix_unscatter": bound(np.mean(36 * ent), np.mean(OPS_UNSCATTER * ent)),
        # C's: the geom's triangles and chunk boxes once, per entry its key
        # and ray in and its 16 B out
        "window_sweep_stream": bound(
            48 * b_tc + 32 * b_cn + np.mean(44 * ent),
            np.mean(OPS_CHUNK_TEST * bw["chunks"] + OPS_MT * bw["tris"])),
    })
    for name in RADIX_KERNELS:
        timing[name] = (kernel_ms_of["big_mesh_radix"][name], big_plain[name],
                        launches_of["big_mesh_radix"][name])
    # one PyTorch call computing the same function on the same inputs,
    # where there is one (timed in radix_check, used nowhere in the port):
    # B a stable torch.sort of A's masked keys; the split the whole sort's
    # call, a stable torch.sort of the compacted keys with the payload and
    # id gathers (the route's sort is its digit passes); the unscatter an
    # index_copy_ by the entry ids. No single call computes the others (a
    # path-tracing bounce, a BVH walk, a merge of two winners, a window
    # sweep).
    library = {name: big_library.get(name) for name in KERNELS}
    library["radix_split"] = big_library["sort"]
    # the material sort's digit pass on (af): held exactly (material_sort_check)
    for k, (wname, label) in SORT_KERNELS.items():
        c = sort_cells[label]
        timing[k] = (kernel_ms_of[label][k], c["plain_split_ms"], launches_of[label][wname])
        bounds[k], library[k], err800[k] = c["bound"], c["torch_sort_ms"], 0.0
    # the surface stage's twins: their plain versions and bounds at their
    # paths' shapes (surface_work), their device ms per launch and launches
    # from their paths of phase 6 (no single PyTorch call computes a bounce)
    surface_plain, surface_bounds, surface_counts = surface_work(dev)
    bounds.update(surface_bounds)
    for twin, (wname, label) in SURFACE_KERNELS.items():
        timing[twin] = (kernel_ms_of[label][twin], surface_plain[twin],
                        launches_of[label][wname])
        library[twin] = None
    untextured = {"full_iteration": main_kernel_ms["full_iteration"] / batch}
    say("surface_stage", device=smi, res="800x800", depth=D, counts=surface_counts,
        twins={twin: {"path": label, "ms_per_launch": timing[twin][0],
                      "launches": timing[twin][2], "plain_ms": timing[twin][1],
                      "bound_ms": bounds[twin][0], "bound_by": bounds[twin][1]}
               for twin, (_, label) in SURFACE_KERNELS.items()},
        full_iteration_ms_per_iteration={
            "textured": kernel_ms_of["textured"]["full_iteration@surface"] / SURFACE_RUN,
            "envmap": kernel_ms_of["envmap"]["full_iteration@surface"] / 10,
            "sss": kernel_ms_of["sss"]["full_iteration@surface"] / 10,
            "cornell_untextured": untextured["full_iteration"]},
        cells={label: {"ms_per_frame": frame_ms_of[label],
                       "device_busy_ms_per_iteration": busy_of[label],
                       "device_idle_share": max(0.0, 1.0 - busy_of[label] / frame_ms_of[label])}
               for label in ("textured", "envmap", "sss", "mesh_textured")})

    # --nee on mesh scenes: the plain versions of #6's and #5's
    # instantiations on MeshOf at their cells' shapes (mesh.txt for
    # MeshOf<Tables>, mesh_textured.txt for MeshOf<TexTables>; 800x800 d8
    # AA), #6's over its profiled launch's MESH_NEE_RUN iterations; their
    # bounds from the plain path's masks and BVH walks (nee_work); beside
    # them the cells (aa)-(ac) and the instantiations' registers and spills
    mesh_nee_lanes = {}
    for suffix, name in (("@mesh", "mesh.txt"), ("@mesh_surface", "mesh_textured.txt")):
        n_scene = load_scene(os.path.join(HERE, "scenes", name))
        n_ds = scene_to_device(n_scene, dev)
        n_cam = camera_to_device(n_scene.state.camera, dev)
        n_set = RenderSettings(trace_depth=D, antialias=True, nee_mis=True)
        n_P = n_scene.state.camera.pixel_count
        n_counts, n_ops, _ = nee_work(n_ds, n_cam, it, n_set)
        mesh_nee_lanes[name] = dict(n_counts, ops_per_depth=n_ops)
        run_ms = event_ms(lambda: plain_run(  # noqa: B023
            mk.full_iteration_nee_reference, n_ds, n_cam, it, n_set, MESH_NEE_RUN), 1)
        pool, aux = nee_pool(dev, n_cam, it, n_set)
        step_ms = 0.0
        for depth in range(D):
            t0 = time.perf_counter()
            pool, aux = mk.bounce_step_nee_reference(pool, aux, n_ds, it, depth, n_set,
                                                     depth == D - 1)
            torch.cuda.synchronize()
            step_ms += 1e3 * (time.perf_counter() - t0) / D
        # as #6's and #5's bounds above, with the walks' work in the ops
        bounds[f"full_iteration_nee{suffix}"] = bound(
            24 * n_P, MESH_NEE_RUN * (n_P * OPS_RAYGEN_AA + sum(n_ops)))
        bounds[f"bounce_step_nee{suffix}"] = bound(
            sum(4 * n_P + 120 * n for n in n_counts["lanes_in"]) / D, sum(n_ops) / D)
        for kname, p_ms in ((f"full_iteration_nee{suffix}", run_ms),
                            (f"bounce_step_nee{suffix}", step_ms)):
            wname, label = MESH_NEE_KERNELS[kname]
            timing[kname] = (kernel_ms_of[label][kname], p_ms, launches_of[label][wname])
            library[kname] = None
    # (ac): #6 on mesh_big through step_batch, its bound counted the same
    # way on the loaded scene at its own 800x800 (the plain estimator and
    # the walks once over one iteration, about 35 s); its plain time the
    # plain estimator's bounces in that count, per iteration
    b_r = big["mesh_big.txt"]
    b_cam = camera_to_device(camera_at(b_r.scene.state.camera, load_res["mesh_big.txt"]), dev)
    b_P = b_cam.resolution[0] * b_cam.resolution[1]
    b_counts, b_ops, _ = nee_work(b_r.dev_scene, b_cam, it,
                                  RenderSettings(trace_depth=D, antialias=True, nee_mis=True))
    b_bound = bound(24 * b_P, MESH_NEE_RUN * (b_P * OPS_RAYGEN_AA + sum(b_ops)))
    b_ms = kernel_ms_of["big_mesh_nee"]["full_iteration_nee@mesh"]
    big_mesh_nee = {"path": "big_mesh_nee", "kernel": "full_iteration_nee@mesh",
                    "ms_per_launch": b_ms, "iterations_per_launch": MESH_NEE_RUN,
                    "launches": launches_of["big_mesh_nee"]["full_iteration_nee"],
                    "bound_ms": b_bound[0], "bound_by": b_bound[1],
                    "x_bound": b_ms / b_bound[0],
                    "plain_ms_per_iteration": sum(b_counts["plain_bounce_ms"]),
                    "lanes": dict(b_counts, ops_per_depth=b_ops)}
    say("mesh_nee", device=smi, res="800x800", depth=D, settings={"antialias": True},
        lanes=mesh_nee_lanes, big_mesh_nee=big_mesh_nee,
        instantiations={k: {"path": label, "ms_per_launch": timing[k][0],
                            "iterations_per_launch": (MESH_NEE_RUN if w == "full_iteration_nee"
                                                      else 1),
                            "launches": timing[k][2], "plain_ms": timing[k][1],
                            "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                            "x_bound": timing[k][0] / bounds[k][0],
                            "ptxas": [v for f, v in ptx.items() if w in f and "MeshOf" in f
                                      and ("TexTables" in f) == ("surface" in k)]}
                        for k, (w, label) in MESH_NEE_KERNELS.items()},
        cells={label: {"scene": scene_name, "route": route,
                       "ms_per_frame": frame_ms_of[label],
                       "device_busy_ms_per_iteration": busy_of[label],
                       "device_idle_share": max(0.0, 1.0 - busy_of[label] / frame_ms_of[label]),
                       "kernel_device_ms": kernel_ms_of[label],
                       "launches": launches_of[label]}
               for label, scene_name, route in (
                   ("mesh_nee", "mesh.txt", "step_batch"),
                   ("mesh_nee_step", "mesh.txt", "step"),
                   ("big_mesh_nee", "mesh_big.txt", "step_batch"),
                   ("mesh_textured_nee", "mesh_textured.txt", "step_batch"),
                   ("mesh_textured_nee_step", "mesh_textured.txt", "step"))})

    # ---- 8. the CLI: Cornell plain, with --compact, --nee, --sort-materials
    # and --stats --profile; mesh.txt, also with --nee and --sort-materials;
    # mesh_big.txt (the sorted route), also with PT_TPU_SORT_RADIX=1. The
    # processes run at once (the kernels are built), each checked alone ----
    prof_dir = os.path.join(tmpdir, "cli_profile")
    runs = [("cornell.txt", [], {}), ("cornell.txt", ["--compact"], {}),
            ("cornell.txt", ["--nee"], {}), ("cornell.txt", ["--sort-materials"], {}),
            ("cornell.txt", ["--stats", "--profile", prof_dir], {}),
            ("mesh.txt", [], {}), ("mesh.txt", ["--nee"], {}),
            ("mesh.txt", ["--sort-materials"], {}), ("mesh_big.txt", [], {}),
            ("mesh_big.txt", [], {"PT_TPU_SORT_RADIX": "1"})]
    t0 = time.perf_counter()
    procs = []
    for name, extra, env in runs:
        out_dir = tempfile.mkdtemp(prefix="cli_", dir=tmpdir)
        procs.append((out_dir, subprocess.Popen(
            [sys.executable, "-m", PKG, os.path.join(HERE, "scenes", name),
             "--iterations", "50", "--out-dir", out_dir, *extra],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, **env))))
    try:
        for (name, extra, env), (out_dir, proc) in zip(runs, procs):
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"CLI {name} {extra} exited {proc.returncode}: {err[-3000:]}")
            pngs = [f for f in os.listdir(out_dir) if f.endswith(".50samp.png")]
            if len(pngs) != 1:
                raise RuntimeError(f"CLI {extra} wrote {os.listdir(out_dir)}")
            extra_kv = {}
            if "--stats" in extra:
                stages = re.findall(r"stage (\w+) +([\d.]+) ms", err)
                alive = re.search(r"alive rays per bounce \(iter 1\): (\[.*\])", err)
                traces = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
                if [k for k, _ in stages] != ["raygen", "intersect_sweep", "shade",
                                              "full_iteration", "bounce_kernel"] \
                        or alive is None or len(traces) != 1:
                    raise RuntimeError(f"CLI --stats/--profile: stages {stages}, "
                                       f"alive {alive}, traces {traces}: {err[-3000:]}")
                extra_kv = {"alive_per_bounce": json.loads(alive.group(1)),
                            "stage_ms": {k: float(v) for k, v in stages},
                            "trace_mb": os.path.getsize(os.path.join(prof_dir, traces[0])) / 2**20}
            say("cli", scene=name, flags=extra, env=env, rc=proc.returncode, png=pngs[0],
                seconds_all_at_once=time.perf_counter() - t0, **extra_kv)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    shutil.rmtree(tmpdir, ignore_errors=True)

    # ---- 9. the last modules: --no-pallas, --debug, --debug-nans, the
    # loaders' remainder, the viewer, the four flags through the CLI ----
    last_modules_phase(dev, big, goldens, smi)

    # the tri-shard tier's entries, from the shard phase's own process
    for k, e in shard_out["tri_kernels"].items():
        timing[k] = (e["ms_per_launch"], e["plain_ms"], e["launches"])
        bounds[k] = (e["bound_ms"], e["bound_by"])
        err800[k], library[k] = e["max_abs_err"], None

    say("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    kernels = []
    entries = [(name, *KERNELS[name]) for name in KERNELS]
    entries += [(twin, *KERNELS[wname]) for twin, (wname, _) in SURFACE_KERNELS.items()]
    entries += [(k, *KERNELS[wname]) for k, (wname, _) in MESH_NEE_KERNELS.items()]
    entries += [(k, *KERNELS[wname]) for k, (wname, _) in SORT_KERNELS.items()]
    entries += [(k, *KERNELS[wname]) for k, (wname, _) in TRI_KERNELS.items()]
    for name, source, replaces in entries:
        ms, p_ms, launches = timing[name]
        b_ms, b_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err800[name], "ms": ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library[name],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
