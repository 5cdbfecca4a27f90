"""Time variants of seven kernels at each depth of their paths on one
NVIDIA GPU, to find where their time goes: #2 (`first_bounce`,
csrc/bounce.cu), #3 (`bounce_step`, csrc/bounce.cu), A (`super_keys`,
csrc/sorted.cu), #7 (`mesh_candidates`, csrc/mesh.cu), B
(`place_entries`, csrc/sorted.cu), #9 (`bounce_step_mesh`, csrc/mesh.cu)
and D (`merge_entries`, csrc/sorted.cu).

    python tools/torch_mesh_variants.py [--kernels 2,3,a,7,b,9,d] [--parent DIR]
                                        [--out FILE]

Each variant is its source with named lines replaced (each replaced line
must be found, or the tool stops; a replacement may also name another
file under csrc/, such as the shared header, which the variant then
includes in place of the committed one), built with the port's own nvcc
flags into `_build/variants/`. With --parent DIR (another checkout or
`git archive` of the repository, whose wrappers call the same C entry
points), its #2, #3, A, #9 and D are built from DIR's own sources as the
variants "parent_2", "parent_3", "parent_a", "parent_9" and "parent_d",
and each such variant is timed twice, before and after the others, so
parent and committed kernels run in turns. #2 is timed on the camera of
iteration 2 of (a) Cornell 800x800 AA and of (h) many_materials
1920x1080 RR (38 geoms), and every variant's 14 pool lanes are also held
bit for bit against the committed kernel's, untimed, on the 26 configs of
`first_bounce_configs` (chip_smoke.py's FULL_PARITY at 64x64 and 37x23,
its BOUNCE_PARITY, 1x1 with and without depth of field, and Cornell with
300 boxes added). The other kernels' inputs are made by the port's kernels from the
camera pool of iteration 2 and one bounce per depth (800x800, depth 8):
#3's pools at depths 1-7 of Cornell AA as `Renderer.step()` leaves them
(path (a)) and compacted with their live count (path (b), `--compact`);
A's inputs at every depth of mesh_big.txt and bunny.txt AA (paths (n)
and (p)); #7's rays and alive lanes at every depth of mesh.txt AA (path
(j)); A's keys at every depth of mesh_big.txt for B; #9's pools, #7's
candidate hits and the merged mesh hits at every depth of (j) and (n);
A's, B's and C's outputs at every depth of (n) and (p) for D. For each
variant and depth, its kernel runs 10 times under torch.profiler (#3 and
#9 on a fresh copy of their pool each time, D on a fresh copy of #8's
hits: they work in place), routed to the variant's library, and its mean
device ms per launch is printed with whether its output is bit for bit
the committed kernel's (#2, #3 and #9: all 14 pool lanes; A: keys, rays
and bt0 of the listed lanes, the histogram and the cursor; #7: the
analytic lanes and flags of the live lanes, the list as a set; B: the
stream per key and the total; D: the 9 hit lanes of every lane), and with
the registers of the variant's kernel functions. "no_append_7",
"no_hist_a", "one_super_a", "no_loop_a", "loads_only_d", "floor_stores_2"
and "floor_sweep_2" are wrong on purpose (their time is what the list's
atomics, A's histogram, all of A but its loop over the supers, D's loads
without its epilogue, #2's raygen and stores alone and #2's raygen and
sweep without shading or stores cost) and are not compared; a depth
whose profile recorded no launch three times is left out of the mean and
said so. Also per depth: #3's and
#9's live lanes below the count and the warps of 32 lanes and the
32-byte sectors (8 lanes) that hold one, #9's candidates, A's listed
lanes, #7's live lanes and warps holding one, B's listed lanes and
entries, D's listed lanes, real entries and hits. Prints one JSON line
per variant and the card's name and power limit; writes them to FILE
when given.
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
# name -> (kernel, [(line in its source, its replacement)])
# #3's kernel from its first line to its bounce (replaced by the variants
# that change how a block's threads take its lanes), its last line, and its
# grid
HEAD_3 = """  __shared__ int s_lanes[kBounceThreads];  // the block's live lanes, packed
  __shared__ int s_warp[kBounceWarps];
  const int first = blockIdx.x * kBounceThreads;
  const int end = num_alive == nullptr ? n : min(n, __ldg(num_alive));
  if (first >= end) return;  // the whole block
  int i = first + threadIdx.x;
  bool live = i < end && pool.alive[i] != 0;
  if (__syncthreads_count(live) < kBounceThreads) {  // else every lane is live: no packing
    int kept;
    const int at = block_prefix<kBounceWarps>(live, s_warp, &kept);
    if (live) s_lanes[at] = i;
    __syncthreads();
    live = static_cast<int>(threadIdx.x) < kept;
    if (live) i = s_lanes[threadIdx.x];
  }
  if (!live) return;
"""
TAIL_3 = "  pool.alive[i] = alive ? 1 : 0;\n}\n"
GRID_3 = "bounce_step_kernel<<<(n + kBounceThreads - 1) / kBounceThreads, kBounceThreads, 0,"

# #9's kernel from its signature's last line to its shading (replaced by
# the variants that change how a block's threads take its lanes), its
# launch bounds and its grid
HEAD_9 = """    int n, const HitLanes a, const HitLanes mh, int iteration, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (num_alive != nullptr && i >= __ldg(num_alive)) return;
  if (pool.alive[i] == 0) return;
"""
BOUNDS_9 = "__global__ void __launch_bounds__(kThreads)\n    bounce_step_mesh_kernel"
GRID_9 = "bounce_step_mesh_kernel<<<n_blocks(n), kThreads, 0,"


def sized_9(threads: int) -> list:
    """#9 in blocks of `threads`, a lane a thread."""
    return [(BOUNDS_9, BOUNDS_9.replace("kThreads", str(threads))),
            (GRID_9, f"bounce_step_mesh_kernel<<<(n + {threads - 1}) / {threads}, {threads}, 0,")]


def packed_9(pack_max: int, threads: int = 128) -> list:
    """#9 with #3's packing: a block of `threads` lanes with at most
    `pack_max` live packs them into its first threads in lane order."""
    return sized_9(threads) + [(HEAD_9, HEAD_9.split("\n")[0] + f"""
  __shared__ int s_lanes[{threads}];
  __shared__ int s_warp[{threads // 32}];
  const int first = blockIdx.x * {threads};
  const int end = num_alive == nullptr ? n : min(n, __ldg(num_alive));
  if (first >= end) return;  // the whole block
  int i = first + threadIdx.x;
  bool live = i < end && pool.alive[i] != 0;
  if (__syncthreads_count(live) <= {pack_max}) {{
    int kept;
    const int at = block_prefix<{threads // 32}>(live, s_warp, &kept);
    if (live) s_lanes[at] = i;
    __syncthreads();
    live = static_cast<int>(threadIdx.x) < kept;
    if (live) i = s_lanes[threadIdx.x];
  }}
  if (!live) return;
""")]


# D's head (its signature's last line, the lane and the count), its slot
# loads and merge, the lane's other loads, its epilogue and merge, its
# launch bounds and its launch
HEAD_D = """                         const HitLanes out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || j >= __ldg(count)) return;
"""
SLOTS_D = """  int key[E];
  float ts[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    key[e] = __ldg(keys + e * n + j);
    ts[e] = __ldg(sw_t + e * n + j);
  }
  float bt = kFltMax;
  int win = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (key[e] < dead && ts[e] < bt) {
      bt = ts[e];
      win = e;
    }
  }
  if (!(bt < kFltMax && bt < bt0[j])) return;
  const int w = win * n + j;
  const TriHit th = {bt, sw_tri[w], sw_u[w], sw_v[w]};
"""
LANE_D = """  const int i = __ldg(list + j);
  ObjRay r;
  r.o = {q[j], q[n + j], q[2 * n + j]};
  r.d = {q[3 * n + j], q[4 * n + j], q[5 * n + j]};
"""
EPILOGUE_D = """  const MeshHit h = epilogue(s, m, g, has_uv != 0, r, th, ray_o(rays, i), ray_d(rays, i));
  const float prev = out.t[i] > 0.0f ? out.t[i] : kFltMax;
  if (!(h.t > 0.0f && prev > h.t)) return;
  out.t[i] = h.t;
  out.n[0][i] = h.n.x;
  out.n[1][i] = h.n.y;
  out.n[2][i] = h.n.z;
  out.mat[i] = __ldg(s.gmat + g);
  out.outside[i] = h.outside ? 1 : 0;
  out.flag[i] = has_uv ? 1 : 0;
  out.u[i] = h.u;
  out.v[i] = h.v;
}
"""
TAIL_D = "  out.v[i] = h.v;\n}\n"
BOUNDS_D = "__global__ void __launch_bounds__(kThreads)\n    merge_entries_kernel"
GRID_D = "kernel<<<n_blocks(n), kThreads, 0,"
# the lane's list entry, bound and object ray loaded before its slots
EARLY_D = """  const int i = __ldg(list + j);
  const float b0 = __ldg(bt0 + j);
  ObjRay r;
  r.o = {__ldg(q + j), __ldg(q + n + j), __ldg(q + 2 * n + j)};
  r.d = {__ldg(q + 3 * n + j), __ldg(q + 4 * n + j), __ldg(q + 5 * n + j)};
"""


def lanes_d(loop: str) -> list:
    """D's body run for each j of `loop` (its lane, returning early from
    a lambda in place of the kernel)."""
    return [(HEAD_D, HEAD_D.split("\n")[0] + "\n" + loop + """ [=] {
  if (j >= n || j >= __ldg(count)) return;
"""), (TAIL_D, "  out.v[i] = h.v;\n  }();\n}\n")]


def group_a(G: int) -> list:
    """A with a group of G lanes per ray, the boxes read from global
    memory: lane k of a group tests supers k, k + G, ... of each word, a
    ballot joins them, the group's first lane writes the keys."""
    return [
        ("  const int first = blockIdx.x * kKeysThreads;",
         f"  const int first = blockIdx.x * kKeysThreads / {G};"),
        ("blocks_of(n, kKeysThreads)", f"blocks_of(n, kKeysThreads / {G})"),
        (A_LOOP, f"""  const float fro = frobenius3(inv);
  const int lane = threadIdx.x & 31;
  const int k = lane % {G};
  const int g0 = lane - k;
  const unsigned bits = 0xffffffffu >> (32 - {G});
  for (int j0 = (static_cast<int>(blockIdx.x * kKeysThreads + threadIdx.x) - lane) / {G};
       j0 < n_listed; j0 += gridDim.x * kKeysThreads / {G}) {{
    const int j = j0 + lane / {G};
    const bool has = j < n_listed;
    ObjRay r = {{}};
    float bt = 0.0f;
    if (has) {{
      const int i = __ldg(list + j);
      r = object_ray(inv, ray_o(rays, i), ray_d(rays, i));
      const float ta = t_a[i];
      const float tm = t_m[i];
      const float eff = tm > 0.0f ? (ta > 0.0f ? fminf(tm, ta) : tm) : ta;
      bt = eff > 0.0f ? eff * fro : kFltMax;
    }}
    int key[kPlacePer];
#pragma unroll
    for (int e = 0; e < kPlacePer; ++e) key[e] = dead;
    int cnt = 0;
    for (int w0 = 0; w0 < n_supers; w0 += 32) {{
      unsigned m = 0;
      for (int x = 0; x < 32 / {G}; ++x) {{
        const int s = w0 + x * {G} + k;
        const int sc = min(s, n_supers - 1);
        const bool ok = has && s < n_supers &&
                        keys_enter(__ldg(boxes + 2 * sc), __ldg(boxes + 2 * sc + 1), r, bt);
        m |= ((__ballot_sync(0xffffffffu, ok) >> g0) & bits) << (x * {G});
      }}
      const int c = __popc(m);
      if (c != 0 && cnt < E) {{
#pragma unroll
        for (int e = 0; e < kPlacePer; ++e) {{
          const int rank = e - cnt;
          if (e < E && rank >= 0 && rank < c) key[e] = w0 + __fns(m, 0, rank + 1);
        }}
      }}
      cnt += c;
      if (__all_sync(0xffffffffu, !has || cnt > E)) break;
    }}
    int last = dead, em2 = dead;
#pragma unroll
    for (int e = 0; e < kPlacePer; ++e) {{
      if (e == E - 1) last = key[e];
      if (e == E - 2) em2 = key[e];
    }}
    if (cnt > E) last = E == 1 ? n_supers + key[0] : n_supers + em2 + 1;
    if (!has || k != 0) continue;
    for (int e = 0; e < E; ++e) {{
      const int v = e == E - 1 ? last : key[e];
      keys[e * n + j] = v;
      if (v != dead) atomicAdd(s_hist + v, 1);
    }}
    q[j] = r.o.x;
    q[n + j] = r.o.y;
    q[2 * n + j] = r.o.z;
    q[3 * n + j] = r.d.x;
    q[4 * n + j] = r.d.y;
    q[5 * n + j] = r.d.z;
    bt0[j] = bt;
  }}
""")]


# #2's pixel, its sweep, shading and stores, and its grid (the floors and
# the tile variant replace them)
PIX_2 = """  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = pix < resx * resy;
"""
SWEEP_2 = "  const Hit h = intersect_staged<kPinhole>(s, stage, pos, p.org, p.dir, on);\n"
SHADE_2 = """  if (on) {
    const bool alive = shade(s, p, h, static_cast<uint32_t>(iteration), 0,
                             static_cast<uint32_t>(pix));
"""
STORES_2 = """    store_path(out, pix, p);
    out.alive[pix] = alive ? 1 : 0;
    out.pix[pix] = pix;
  }
"""
GRID_2 = "    kernel<<<n_blocks(n), kThreads, 0,"
BOUNDS_2 = "__global__ void __launch_bounds__(kThreads)\n    first_bounce_kernel"
# a warp on a tile of 8 x 4 pixels, a block's four warps on four tiles in
# a row of tiles; the pool stays pixel-ordered (slot = pix)
TILE_2 = [(PIX_2, """  const int tiles_x = (resx + 7) / 8;
  const int tile = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int px = (tile % tiles_x) * 8 + (threadIdx.x & 7);
  const int py = (tile / tiles_x) * 4 + ((threadIdx.x >> 3) & 3);
  const bool on = px < resx && py < resy;
  const int pix = on ? py * resx + px : resx * resy;
"""), (GRID_2, "    kernel<<<(((resx + 7) / 8) * ((resy + 3) / 4) + 3) / 4, kThreads, 0,")]
# #2 without one element of its design (the others kept):
# (a) the origin terms computed per lane, from the staged rows
NO_HOIST_2 = [(f"    if constexpr (kPinhole) {r}", f"    if constexpr (false) {r}") for r in (
    "{\n      return {r->qo.x", "{\n      div_pair(", "return r->qo.w;")]
# (b) the rows read from the tables (16-byte loads through the read-only
# cache) in place of the staged ones
NO_STAGE_2 = [
    ("struct StagedGeom {\n  const Staged* r;",
     "struct StagedGeom {\n  const Staged* r;\n  const float* ginv;\n  const float* gxf;"),
    ("Rows3{r->inv[0], r->inv[1], r->inv[2]}",
     "Rows3{__ldg(reinterpret_cast<const float4*>(ginv)), "
     "__ldg(reinterpret_cast<const float4*>(ginv + 4)), "
     "__ldg(reinterpret_cast<const float4*>(ginv + 8))}"),
    ("Rows3{r->xf[0], r->xf[1], r->xf[2]}",
     "Rows3{__ldg(reinterpret_cast<const float4*>(gxf)), "
     "__ldg(reinterpret_cast<const float4*>(gxf + 4)), "
     "__ldg(reinterpret_cast<const float4*>(gxf + 8))}"),
    ("const StagedGeom<kPinhole> gm{stage + k};",
     "const StagedGeom<kPinhole> gm{stage + k, s.inv + 16 * (g0 + k), s.xf + 16 * (g0 + k)};"),
    ("stage[k].type == kSphere", "__ldg(s.gtype + g0 + k) == kSphere")]
# the slab distances by two IEEE divisions, not one reciprocal
IEEE_DIV_2 = [("      div_pair(axis(r->lo, a), axis(r->hi, a), d, r->nums_ok, t1, t2);",
               "      *t1 = axis(r->lo, a) / d;\n      *t2 = axis(r->hi, a) / d;")]
# (c) the four camera draws whatever the flags
FOUR_DRAWS_2 = [("raygen<kPinhole>(", "raygen<false>(")]
# (d) the winner's normal from a second test, as path_common.cuh's
# `intersect` takes it
SECOND_TEST_2 = [
    ("sphere_hit<true>(gm, nullptr, org, dir, true, &v, &out)",
     "sphere_hit<true>(gm, nullptr, org, dir, false, &v, &out)"),
    ("box_hit<true>(gm, org, dir, true, &v, &out)",
     "box_hit<true>(gm, org, dir, false, &v, &out)"),
    ("""    // the world normal as box_test and sphere_test compute it
    if (__ldg(s.gtype + best_g) == kSphere) {
      h.n = normalize(xform_dir(s.invt + 16 * best_g, best_v)) * (best_out ? 1.0f : -1.0f);
    } else {
      h.n = normalize(xform_dir(s.xf + 16 * best_g, best_v));
    }
    h.outside = best_out;
""", "    geom_test(s, best_g, org, dir, true, &h.n, &h.outside);\n")]


# A's loop over its listed lanes (replaced whole by the group variants)
A_LOOP = None  # read from csrc/sorted.cu by `build`
# name -> (kernel, [(line in its source, its replacement)]), or a function
# of the source's text giving them
VARIANTS = {
    "committed_2": ("2", []),
    # raygen and the stores alone (wrong on purpose)
    "floor_stores_2": ("2", [(SWEEP_2 + SHADE_2, "  if (on) {\n    const bool alive = true;\n")]),
    # raygen and the sweep with the winner's normal, no shading and no
    # stores (wrong on purpose; the impossible store keeps the sweep)
    "floor_sweep_2": ("2", [(SHADE_2 + STORES_2,
                             "  if (on && h.t == -2.0f && h.n.x == 3.0f) "
                             "out.alive[pix] = h.mat + (h.outside ? 1 : 0);\n")]),
    # each element of the design left out
    "no_hoist_2": ("2", NO_HOIST_2),
    "no_stage_2": ("2", NO_STAGE_2),
    "four_draws_2": ("2", FOUR_DRAWS_2),
    "ieee_div_2": ("2", IEEE_DIV_2),
    "second_test_2": ("2", SECOND_TEST_2),
    # each element alone: the parent's sweep with two draws; (a), (b), (d)
    # with the other two elements and the four draws left out
    "draws_alone_2": ("2", [(SWEEP_2,
                             "  const Hit h = on ? intersect(s, p.org, p.dir) : Hit{};\n")]),
    "hoist_alone_2": ("2", NO_STAGE_2 + FOUR_DRAWS_2 + SECOND_TEST_2 + IEEE_DIV_2),
    "stage_alone_2": ("2", NO_HOIST_2 + FOUR_DRAWS_2 + SECOND_TEST_2),
    "sweep_normal_alone_2": ("2", NO_HOIST_2 + NO_STAGE_2 + FOUR_DRAWS_2),
    # 64 geoms staged at a time (many_materials' 38 in one chunk)
    "stage64_2": ("2", [("constexpr int kStage = 32;", "constexpr int kStage = 64;")]),
    "tile8x4_2": ("2", TILE_2),
    # the resident blocks (SMs x occupancy), each striding over the pool's
    # runs of 128 pixels
    "resident_2": ("2", [
        (PIX_2, "  for (int base = blockIdx.x * blockDim.x; base < resx * resy;\n"
                "       base += gridDim.x * blockDim.x) {\n"
                "  __syncthreads();  // the last run's stage is read\n" + PIX_2.replace(
                    "blockIdx.x * blockDim.x + threadIdx.x", "base + threadIdx.x")),
        (STORES_2, STORES_2 + "  }\n"),
        (GRID_2, """    static int cache[2][64] = {};
    int resident = 0;
    err = resident_blocks(kernel, device, cache[(flags & kDof) ? 1 : 0], &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<resident < n_blocks(n) ? resident : n_blocks(n), kThreads, 0,""")]),
    # registers capped for 8 or 12 resident blocks an SM
    "min8blocks_2": ("2", [(BOUNDS_2, BOUNDS_2.replace("(kThreads)", "(kThreads, 8)"))]),
    "min12blocks_2": ("2", [(BOUNDS_2, BOUNDS_2.replace("(kThreads)", "(kThreads, 12)"))]),
    "committed_3": ("3", []),
    # blocks of 256 or 512 threads, a lane a thread (committed: 128)
    "threads256_3": ("3", [("constexpr int kBounceThreads = kThreads;",
                            "constexpr int kBounceThreads = 256;")]),
    "threads512_3": ("3", [("constexpr int kBounceThreads = kThreads;",
                            "constexpr int kBounceThreads = 512;")]),
    # every block packs, even when all its lanes are live
    "always_pack_3": ("3", [("if (__syncthreads_count(live) < kBounceThreads) {",
                             "if (__syncthreads_count(live) <= kBounceThreads) {")]),
    # registers capped for 10 resident blocks an SM
    "min10blocks_3": ("3", [(
        "__global__ void __launch_bounds__(kBounceThreads)\n    bounce_step_kernel",
        "__global__ void __launch_bounds__(kBounceThreads, 10)\n    bounce_step_kernel")]),
    # 128 threads own 256 lanes, packed in two rounds and bounced in a loop
    "lanes2_3": ("3", [
        (HEAD_3, """  __shared__ int s_lanes[2 * kBounceThreads];
  __shared__ int s_warp[kBounceWarps];
  const int first = blockIdx.x * 2 * kBounceThreads;
  const int end = num_alive == nullptr ? n : min(n, __ldg(num_alive));
  if (first >= end) return;
  int n_live = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int l = first + k * kBounceThreads + threadIdx.x;
    const bool lv = l < end && pool.alive[l] != 0;
    int kept;
    const int at = n_live + block_prefix<kBounceWarps>(lv, s_warp, &kept);
    if (lv) s_lanes[at] = l;
    n_live += kept;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < n_live; q += kBounceThreads) {
    const int i = s_lanes[q];
"""),
        (TAIL_3, "  pool.alive[i] = alive ? 1 : 0;\n  }\n}\n"),
        (GRID_3, "bounce_step_kernel<<<(n + 2 * kBounceThreads - 1) / (2 * kBounceThreads), "
                 "kBounceThreads, 0,")]),
    # #5's warp queue on a persistent grid: each warp takes the pool's
    # 32-lane chunks w, w + warps, ... and queues their live lanes in two
    # registers a lane, bouncing them 32 at a time
    "warp_queue_3": ("3", [
        (HEAD_3, """  const int lane = threadIdx.x & 31;
  const int end = num_alive == nullptr ? n : min(n, __ldg(num_alive));
  const int step = gridDim.x * kBounceWarps * 32;
  int b = (blockIdx.x * kBounceWarps + (threadIdx.x >> 5)) * 32;
  int queued = 0, q = 0, o = 0;
  for (;;) {
    while (queued < 32 && b < end) {
      const int l = b + lane;
      const unsigned live = __ballot_sync(0xffffffffu, l < end && pool.alive[l] != 0);
      const int c = __popc(live);
      const int r = lane - queued;
      if (r >= 0 && r < c) q = b + static_cast<int>(__fns(live, 0, r + 1));
      if (r + 32 < c) o = b + static_cast<int>(__fns(live, 0, r + 33));
      queued += c;
      b += step;
    }
    if (queued == 0) break;
    const int i = q;
    q = o;
    const bool mine = lane < queued;
    queued = max(queued - 32, 0);
    if (!mine) continue;
"""),
        (TAIL_3, "  pool.alive[i] = alive ? 1 : 0;\n  }\n}\n"),
        (GRID_3, """static int cache[64] = {};
    int resident = 0;
    err = resident_blocks(bounce_step_kernel, device, cache, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    bounce_step_kernel<<<resident < n_blocks(n) ? resident : n_blocks(n), kBounceThreads, 0,""")]),
    "committed_a": ("a", []),
    # the boxes read through the read-only cache, not staged
    "no_stage_a": ("a", [
        ("          s_box[b] = __ldg(boxes + 2 * c0 + b);", "          (void)0;"),
        ("keys_enter(s_box[2 * s], s_box[2 * s + 1], r, bt)",
         "keys_enter(__ldg(boxes + 2 * (c0 + s)), __ldg(boxes + 2 * (c0 + s) + 1), r, bt)")]),
    # 32 supers staged at a time: two or three stages a ray here (the path
    # of a geom above kKeysStage supers; bit for bit the committed)
    "stage32_a": ("a", [("constexpr int kKeysStage = 256;", "constexpr int kKeysStage = 32;")]),
    # each run of 8 supers first tested as one cull box, their min / max
    # (exact for a finite inv_d); skipped when the ray misses it
    "cull8_a": ("a", [
        ("  __shared__ float4 s_box[2 * kKeysStage];  // the staged supers' rows",
         "  __shared__ float4 s_box[2 * kKeysStage];  // the staged supers' rows\n"
         "  __shared__ float4 s_cull[2 * kKeysStage / 8];"),
        ("          s_box[b] = __ldg(boxes + 2 * c0 + b);\n        }\n        __syncthreads();\n",
         "          s_box[b] = __ldg(boxes + 2 * c0 + b);\n        }\n        __syncthreads();\n"
         "        for (int c = threadIdx.x; 8 * c < in_stage; c += kKeysThreads) {\n"
         "          float4 a = s_box[16 * c], b = s_box[16 * c + 1];\n"
         "          for (int t = 8 * c + 1; t < min(in_stage, 8 * c + 8); ++t) {\n"
         "            const float4 u = s_box[2 * t], v = s_box[2 * t + 1];\n"
         "            a = make_float4(fminf(a.x, u.x), fminf(a.y, u.y), fminf(a.z, u.z), "
         "fmaxf(a.w, u.w));\n"
         "            b = make_float4(fmaxf(b.x, v.x), fmaxf(b.y, v.y), 0.0f, 0.0f);\n"
         "          }\n"
         "          s_cull[2 * c] = a;\n          s_cull[2 * c + 1] = b;\n        }\n"
         "        __syncthreads();\n"),
        ("        for (int g = 0; g < in_word; g += 8) {\n",
         "        for (int g = 0; g < in_word; g += 8) {\n"
         "          const int c = (w0 + g) / 8;\n"
         "          if (isfinite(r.inv_d.x) && isfinite(r.inv_d.y) && isfinite(r.inv_d.z) &&\n"
         "              !keys_enter(s_cull[2 * c], s_cull[2 * c + 1], r, bt)) continue;\n")]),
    # a group of 8 or 32 lanes per ray (committed: 1)
    "group8_a": ("a", lambda: group_a(8)),
    "group32_a": ("a", lambda: group_a(32)),
    "threads256_a": ("a", [("constexpr int kKeysThreads = 128;",
                            "constexpr int kKeysThreads = 256;")]),
    # a grid sized by the pool, as the parent's (committed: the resident blocks)
    "pool_grid_a": ("a", [("std::min(blocks, blocks_of(n, kKeysThreads))",
                           "blocks_of(n, kKeysThreads)")]),
    # no histogram adds at all (wrong on purpose: their cost)
    "no_hist_a": ("a", [("      if (v != dead) atomicAdd(s_hist + v, 1);",
                         "      if (v < 0) atomicAdd(s_hist + v, 1);")]),
    # only super 0 tested, or none (wrong on purpose: the cost of all but
    # the supers' loop)
    "one_super_a": ("a", [("      for (int w0 = 0; has && w0 < in_stage && cnt <= E; w0 += 32) {",
                           "      for (int w0 = 0; has && w0 < 1 && cnt <= E; w0 += 32) {"),
                          ("        const int in_word = min(32, in_stage - w0);",
                           "        const int in_word = 1;")]),
    "no_loop_a": ("a", [("      for (int w0 = 0; has && w0 < in_stage && cnt <= E; w0 += 32) {",
                         "      for (int w0 = 0; has && w0 < 0 && cnt <= E; w0 += 32) {")]),
    "committed_7": ("7", []),
    # a thread per lane in place: no packing of the live lanes
    "unpacked_7": ("7", [
        ("    const bool sweep = i < end && (live || all_lanes);",
         "    const bool sweep = i < end;"),
        ("    const bool live = (packed & kLiveBit) != 0;\n",
         "    const bool live = (packed & kLiveBit) != 0;\n"
         "    if (!live && !all_lanes) continue;\n")]),
    "pack1_7": ("7", [("constexpr int kCandPer = 2;", "constexpr int kCandPer = 1;")]),
    "pack4_7": ("7", [("constexpr int kCandPer = 2;", "constexpr int kCandPer = 4;")]),
    "pack8_7": ("7", [("constexpr int kCandPer = 2;", "constexpr int kCandPer = 8;")]),
    "no_append_7": ("7", [("s_base = atomicAdd(count, n_cands);", "s_base = 0;")]),
    # the analytic geoms' ids listed once per block in shared memory, so
    # that the sweep loop meets no mesh geom
    "geom_list_7": ("7", [
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
    "threads64_7": ("7", [("constexpr int kCandThreads = 128;",
                           "constexpr int kCandThreads = 64;")]),
    "threads64_pack4_7": ("7", [
        ("constexpr int kCandThreads = 128;", "constexpr int kCandThreads = 64;"),
        ("constexpr int kCandPer = 2;", "constexpr int kCandPer = 4;")]),
    "threads256_pack1_7": ("7", [
        ("constexpr int kCandThreads = 128;", "constexpr int kCandThreads = 256;"),
        ("constexpr int kCandPer = 2;", "constexpr int kCandPer = 1;")]),
    "committed_b": ("b", []),
    "committed_9": ("9", []),
    # blocks of 256 or 512 threads, a lane a thread (committed: 128)
    "threads256_9": ("9", sized_9(256)),
    "threads512_9": ("9", sized_9(512)),
    # #3's packing, in a block with at most half its lanes live, with a
    # dead lane (#3's rule), or always
    "pack_half_9": ("9", packed_9(64)),
    "pack_unless_full_9": ("9", packed_9(127)),
    "always_pack_9": ("9", packed_9(128)),
    # 128 threads own 256 lanes, packed in two rounds and shaded in a loop
    # (#7's scheme)
    "lanes2_9": ("9", [
        (HEAD_9, HEAD_9.split("\n")[0] + """
  __shared__ int s_lanes[256];
  __shared__ int s_warp[4];
  const int first = blockIdx.x * 256;
  const int end = num_alive == nullptr ? n : min(n, __ldg(num_alive));
  if (first >= end) return;
  int n_live = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int l = first + k * 128 + threadIdx.x;
    const bool lv = l < end && pool.alive[l] != 0;
    int kept;
    const int at = n_live + block_prefix<4>(lv, s_warp, &kept);
    if (lv) s_lanes[at] = l;
    n_live += kept;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < n_live; q += 128) {
    const int i = s_lanes[q];
"""),
        (TAIL_3, "  pool.alive[i] = alive ? 1 : 0;\n  }\n}\n"),
        (GRID_9, "bounce_step_mesh_kernel<<<(n + 255) / 256, kThreads, 0,")]),
    "committed_d": ("d", []),
    # the resident blocks striding over the count (committed: the grid
    # sized by the pool)
    "resident_d": ("d", lanes_d(
        "  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n; "
        "j += gridDim.x * blockDim.x)") + [(GRID_D, """int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    kernel<<<std::min(n_blocks(n), per_sm * sms), kThreads, 0,""")]),
    "threads256_d": ("d", [(BOUNDS_D, BOUNDS_D.replace("kThreads", "256")),
                           (GRID_D, "kernel<<<(n + 255) / 256, 256, 0,")]),
    # two listed lanes a thread, a block's threads apart
    "lanes2_d": ("d", lanes_d(
        "#pragma unroll\n  for (int k = 0, j = 2 * blockIdx.x * blockDim.x + threadIdx.x; "
        "k < 2; ++k, j += blockDim.x)") + [
            (GRID_D, "kernel<<<(n + 255) / 256, kThreads, 0,")]),
    # the lane's list entry, bound and object ray loaded before its slots
    "early_d": ("d", [(HEAD_D, HEAD_D + EARLY_D), (LANE_D, ""),
                      (SLOTS_D, SLOTS_D.replace("bt0[j]", "b0"))]),
    # the same early loads with the parent's slot loop (a dead slot
    # skipped before its t is read, the winner's fields read in the loop)
    "early_parent_loop_d": ("d", [(HEAD_D, HEAD_D + EARLY_D), (LANE_D, ""),
                                  (SLOTS_D, """  TriHit th = {kFltMax, 0, 0.0f, 0.0f};
#pragma unroll 1
  for (int e = 0; e < E; ++e) {
    const int idx = e * n + j;
    if (keys[idx] >= dead) continue;
    const float t = sw_t[idx];
    if (t < th.t) th = TriHit{t, sw_tri[idx], sw_u[idx], sw_v[idx]};
  }
  if (!(th.t < kFltMax && th.t < b0)) return;
""")]),
    # every slot's triangle, u and v loaded with its key and t, the winner's
    # taken in registers (no load after the merge but the hit's own)
    "all_rows_d": ("d", [(SLOTS_D, """  int key[E], tri_e[E];
  float ts[E], us[E], vs[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    key[e] = __ldg(keys + e * n + j);
    ts[e] = __ldg(sw_t + e * n + j);
    tri_e[e] = __ldg(sw_tri + e * n + j);
    us[e] = __ldg(sw_u + e * n + j);
    vs[e] = __ldg(sw_v + e * n + j);
  }
  float bt = kFltMax, wu = 0.0f, wv = 0.0f;
  int wt = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (key[e] < dead && ts[e] < bt) {
      bt = ts[e];
      wt = tri_e[e];
      wu = us[e];
      wv = vs[e];
    }
  }
  if (!(bt < kFltMax && bt < bt0[j])) return;
  const TriHit th = {bt, wt, wu, wv};
""")]),
    # every load of the committed D but the epilogue's, no epilogue (wrong
    # on purpose: the floor of the slot merge)
    "loads_only_d": ("d", [(EPILOGUE_D, """  const float prev_t = out.t[i];
  const V3 o = ray_o(rays, i), d = ray_d(rays, i);
  out.t[i] = prev_t + th.t + th.u + th.v + __int_as_float(th.tri) + o.x + o.y + o.z + d.x +
             d.y + d.z + r.o.x + r.o.y + r.o.z + r.d.x + r.d.y + r.d.z;
}
""")]),
    "per6_b": ("b", [("constexpr int kPlacePer = 8;", "constexpr int kPlacePer = 6;")]),
    "per16_b": ("b", [("constexpr int kPlacePer = 8;", "constexpr int kPlacePer = 16;")]),
    "threads128_b": ("b", [("constexpr int kPlaceThreads = 256;",
                            "constexpr int kPlaceThreads = 128;")]),
    # registers capped for 4 resident blocks of 256 threads an SM
    "min4blocks_b": ("b", [(
        "__global__ void __launch_bounds__(kPlaceThreads)\n    place_entries_kernel",
        "__global__ void __launch_bounds__(kPlaceThreads, 4)\n    place_entries_kernel")]),
    # each entry stored at its place from its thread, not staged in runs
    "scatter_b": ("b", [
        ("""          s_key[p] = key[i];
          s_id[p] = slot * n + j0 + k * kPlaceThreads;""",
         """          out_key[s_base[key[i]] + p] = key[i];
          out_entry[s_base[key[i]] + p] = slot * n + j0 + k * kPlaceThreads;"""),
        ("    for (int p = threadIdx.x; p < in_tile; p += kPlaceThreads) {",
         "    for (int p = threadIdx.x; p < 0 * in_tile; p += kPlaceThreads) {")]),
}
WRONG = ("no_append_7", "no_hist_a", "one_super_a", "no_loop_a", "loads_only_d",
         "floor_stores_2", "floor_sweep_2")
# kernel -> (source, C entry point, kernel symbol, path)
KERNEL = {"2": ("bounce.cu", "pt_first_bounce", "first_bounce_kernel",
                "(a), (h) cornell.txt, many_materials.txt"),
          "3": ("bounce.cu", "pt_bounce_step", "bounce_step_kernel", "(a), (b) cornell.txt"),
          "a": ("sorted.cu", "pt_super_keys", "super_keys_kernel", "(n), (p) mesh_big, bunny"),
          "7": ("mesh.cu", "pt_mesh_candidates", "mesh_candidates_kernel", "(j) mesh.txt"),
          "b": ("sorted.cu", "pt_place_entries", "place_entries_kernel", "(n) mesh_big.txt"),
          "9": ("mesh.cu", "pt_bounce_step_mesh", "bounce_step_mesh_kernel",
                "(j), (n) mesh.txt, mesh_big"),
          "d": ("sorted.cu", "pt_merge_entries", "merge_entries_kernel",
                "(n), (p) mesh_big, bunny")}
# kernel -> the paths whose inputs it is timed on; path -> its scene
# (#2's "a0" and "h0" are the camera of (a) and (h), "2x" its untimed
# configs)
PATHS = {"2": ("a0", "h0", "2x"), "3": ("a", "b"), "a": ("n", "p"), "7": ("j",), "b": ("n",),
         "9": ("j", "n"),
         "d": ("n", "p")}
SCENES = {"j": "mesh.txt", "n": "mesh_big.txt", "p": "bunny.txt"}
UNTIMED = ("2x",)


def first_bounce_configs() -> list:
    """#2's untimed configs, (scene, settings, resolution): chip_smoke's
    FULL_PARITY at 64x64 and 37x23, its BOUNCE_PARITY at 64x64, Cornell AA
    and depth of field at 1x1, and "many_boxes" (Cornell with 300 boxes
    added, chip_smoke.many_boxes_scene) AA at 64x64 and 37x23."""
    import chip_smoke

    return ([(name, kw, res) for res in ((64, 64), (37, 23))
             for name, kw in chip_smoke.FULL_PARITY]
            + [(name, kw, (64, 64)) for name, kw in chip_smoke.BOUNCE_PARITY]
            + [("cornell.txt", {"antialias": True}, (1, 1)),
               ("cornell_dof.txt", {"antialias": True, "depth_of_field": True}, (1, 1)),
               ("many_boxes", {"antialias": True}, (64, 64)),
               ("many_boxes", {"antialias": True}, (37, 23))])


# --parent's variants: its own sources
PARENT = {"2": "parent_2", "3": "parent_3", "a": "parent_a", "9": "parent_9", "d": "parent_d"}
RESOLVED = {}  # variant -> the replacements `build` made


def build(out_dir: str, names, parent=None) -> dict:
    """{variant: library path} of `names`, all built in parallel."""
    global A_LOOP
    from project3_cuda_path_tracer_tpu_torch.ops import _native

    os.makedirs(out_dir, exist_ok=True)
    procs, libs = [], {}
    for name in names:
        if name in PARENT.values():
            src_dir = os.path.join(parent, "project3_cuda_path_tracer_tpu_torch", "csrc")
            k = name[-1]
            subs = []
        else:
            src_dir = str(_native.CSRC)
            k, subs = VARIANTS[name]
        src = KERNEL[k][0]
        with open(os.path.join(src_dir, src)) as f:
            text = f.read()
        if callable(subs):
            A_LOOP = a_loop(text)
            subs = subs()
        RESOLVED[name] = subs
        # each variant in its own directory, beside the other csrc/ files it
        # replaces lines of: a quoted #include looks there first
        var_dir = os.path.join(out_dir, name)
        os.makedirs(var_dir, exist_ok=True)
        texts = {src: text}
        for sub in subs:
            f, old, new = sub if len(sub) == 3 else (src, *sub)
            if f not in texts:
                with open(os.path.join(src_dir, f)) as fh:
                    texts[f] = fh.read()
            if old not in texts[f]:
                raise RuntimeError(f"variant {name}: {old!r} not in csrc/{f}")
            texts[f] = texts[f].replace(old, new)
        for f, t in texts.items():
            with open(os.path.join(var_dir, f), "w") as fh:
                fh.write(t)
        libs[name] = os.path.join(out_dir, f"{name}.so")
        procs.append(subprocess.Popen(
            [_native.find_nvcc(), *_native.NVCC_FLAGS, "-I", src_dir, "-o", libs[name],
             os.path.join(var_dir, src)],
            stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {err[-2000:]}")
    return libs


def registers(lib: str, symbol: str) -> dict:
    """{kernel function whose name holds `symbol`: its registers} of a
    built library (cuobjdump's resource usage)."""
    from project3_cuda_path_tracer_tpu_torch.ops import _native

    cuobjdump = os.path.join(os.path.dirname(_native.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "--dump-resource-usage", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    regs, name = {}, None
    for line in out.splitlines():
        if "Function" in line:
            name = line.split("Function", 1)[1].strip().rstrip(":")
        elif name and symbol in name and "REG:" in line:
            regs[name] = int(line.split("REG:", 1)[1].split()[0])
    return regs


def a_loop(text: str) -> str:
    """A's loop over its listed lanes in csrc/sorted.cu, from the bound's
    norm to the end of the loop (the group variants replace it whole)."""
    start = text.index("  const float fro = frobenius3(inv);\n  for (int j0 = first;")
    end = text.index("    bt0[j] = bt;\n  }\n", start) + len("    bt0[j] = bt;\n  }\n")
    return text[start:end]


def clone_pool(pool):
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3

    lanes = [a.clone() for a in mk.pool_lanes(pool)]
    return (Vec3(*lanes[0:3]), Vec3(*lanes[3:6]), Vec3(*lanes[6:9]), Vec3(*lanes[9:12]),
            lanes[12], lanes[13])


def inputs(dev, kernels):
    """Per depth of iteration 2 (800x800): {path label: (scene, tables,
    settings, [per depth inputs])}: for #3 (a) Cornell AA's pools entering
    depths 1-7 and (b) the same compacted, with their live count; for the
    mesh kernels a dict a depth, made by the kernels themselves (#7 -> #8
    [-> A -> B -> C -> D] -> #9) on (j) mesh.txt, (n) mesh_big.txt and (p)
    bunny.txt AA: the rays and alive lanes ("o", "dirs", "alive": #7's),
    #7's list and #8's hits ("cands", "hits": A's, with the big geom "g"),
    A's keys ("sk": B's), C's results ("eh": D's, on a copy of "hits"), the
    pool entering the depth and the merged hits ("pool", "merged": #9's)."""
    import torch

    from project3_cuda_path_tracer_tpu_torch.models.scene import load_scene
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl
    from project3_cuda_path_tracer_tpu_torch.ops.vec import Vec3
    from project3_cuda_path_tracer_tpu_torch.render import (
        Renderer,
        RenderSettings,
        _camera_pool,
        _count_alive,
        _maybe_compact,
    )
    import chip_smoke
    from chip_smoke import clone_hits
    from project3_cuda_path_tracer_tpu_torch.ops import _native

    out = {}
    if "2" in kernels:
        for label, name, kw in (("a0", "cornell.txt", {"antialias": True}),
                                ("h0", "many_materials.txt", {"russian_roulette": True})):
            settings = RenderSettings(trace_depth=DEPTH, **kw)
            r = Renderer(load_scene(os.path.join(ROOT, "scenes", name)), settings, device=dev)
            out[label] = (r.dev_scene, r.tables, settings,
                          [{"ds": r.dev_scene, "cam": r.dev_camera, "tables": r.tables,
                            "settings": settings, "config": name}])
        rows = []
        boxes = chip_smoke.many_boxes_scene(
            os.path.join(str(_native.BUILD_DIR), "variants", "many_boxes.txt"))
        for name, kw, res in first_bounce_configs():
            ds, cam, settings = chip_smoke.on_card(
                dev, name, kw, res, path=boxes if name == "many_boxes" else None)
            rows.append({"ds": ds, "cam": cam, "tables": None, "settings": settings,
                         "config": f"{name} {kw} {res[0]}x{res[1]}"})
        out["2x"] = (None, None, None, rows)
    if "3" in kernels:
        for label, kw in (("a", {}), ("b", {"compact": True})):
            settings = RenderSettings(trace_depth=DEPTH, antialias=True, **kw)
            r = Renderer(load_scene(os.path.join(ROOT, "scenes", "cornell.txt")), settings,
                         device=dev)
            pool = mk.first_bounce(r.dev_scene, r.dev_camera, 2, settings, tables=r.tables)
            rows = []
            for d in range(1, DEPTH):
                pool = _maybe_compact(pool, settings)
                n_alive = _count_alive(pool) if settings.compact else None
                rows.append((clone_pool(pool), n_alive, d))
                mk.bounce_step(pool, r.dev_scene, 2, d, settings, num_alive=n_alive,
                               tables=r.tables)
            out[label] = (r.dev_scene, r.tables, settings, rows)
    settings = RenderSettings(trace_depth=DEPTH, antialias=True)
    labels = {label for k in kernels if k not in ("2", "3") for label in PATHS[k]}
    for label in sorted(labels):
        r = Renderer(load_scene(os.path.join(ROOT, "scenes", SCENES[label])), settings,
                     device=dev)
        ds, tables = r.dev_scene, r.tables
        big = pl.sorted_geoms(ds)
        pool = _camera_pool(r.dev_camera, 2, settings)
        rows = []
        for d in range(DEPTH):
            # the pool is bounced in place: keep this depth's lanes
            row = {"o": Vec3(*(c.clone() for c in pool[0])),
                   "dirs": Vec3(*(c.clone() for c in pool[1])),
                   "alive": pool[4].clone(), "pool": clone_pool(pool), "depth": d}
            cands = pl.mesh_candidates(pool[0], pool[1], pool[4], ds, tables=tables)
            hits = pl.mesh_sweep(pool[0], pool[1], cands, ds, tables=tables)
            row.update(cands=cands, hits=clone_hits(hits))
            if big:
                (g,) = big
                sk = pl.super_keys(pool[0], pool[1], cands, hits, ds, g, tables=tables)
                st = pl.place_entries(sk, cands.count)
                eh = pl.window_sweep(st, sk, ds, g, tables=tables)
                pl.merge_entries(pool[0], pool[1], cands, hits, sk, eh, ds, g, tables=tables)
                row.update(g=g, sk=sk, eh=eh)
            row["merged"] = hits
            rows.append(row)
            pl.bounce_step_mesh(pool, cands, hits, ds, 2, d, settings, tables=tables)
        out[label] = (ds, tables, settings, rows)
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="2,3,a,7,b,9,d",
                    help="the kernels whose variants to time (of 2, 3, a, 7, b, 9, d)")
    ap.add_argument("--parent", help="another checkout: its #2, #3, A, #9 and D as variants")
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    if not set(kernels) <= set(KERNEL):
        ap.error(f"--kernels: of {sorted(KERNEL)}")

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from chip_smoke import clone_hits, hit_lanes
    from project3_cuda_path_tracer_tpu_torch.ops import _native
    from project3_cuda_path_tracer_tpu_torch.ops import megakernel as mk
    from project3_cuda_path_tracer_tpu_torch.ops import pipeline as pl

    if not torch.cuda.is_available():
        print("torch_mesh_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi_line()
    # per kernel: (parent,) committed, the others, committed again (, parent)
    order = []
    for k in kernels:
        mine = [n for n, (kk, _) in VARIANTS.items() if kk == k]
        turns = [PARENT[k]] if args.parent and k in PARENT else []
        order += turns + mine + [f"committed_{k}"] + turns
    libs = build(os.path.join(str(_native.BUILD_DIR), "variants"), sorted(set(order)),
                 os.path.abspath(args.parent) if args.parent else None)
    data = inputs(dev, kernels)
    bits = chip_smoke.bitwise

    def run(k, label, row):
        ds, tables, settings, _ = data[label]
        if k == "2":  # a fresh pool each call
            return lambda: mk.first_bounce(row["ds"], row["cam"], 2, row["settings"],
                                           tables=row["tables"])
        if k == "3":
            pool, n_alive, d = row
            work = clone_pool(pool)

            def bounce():  # on a fresh copy of the pool: #3 bounces in place
                for a, b in zip(mk.pool_lanes(work), mk.pool_lanes(pool)):
                    a.copy_(b)
                return mk.bounce_step(work, ds, 2, d, settings, num_alive=n_alive,
                                      tables=tables)
            return bounce
        if k == "a":
            return lambda: pl.super_keys(row["o"], row["dirs"], row["cands"], row["hits"],
                                         ds, row["g"], tables=tables)
        if k == "7":
            return lambda: pl.mesh_candidates(row["o"], row["dirs"], row["alive"], ds,
                                              tables=tables)
        if k == "9":
            pool, work, d = row["pool"], clone_pool(row["pool"]), row["depth"]

            def shade():  # on a fresh copy of the pool: #9 bounces in place
                for a, b in zip(mk.pool_lanes(work), mk.pool_lanes(pool)):
                    a.copy_(b)
                return pl.bounce_step_mesh(work, row["cands"], row["merged"], ds, 2, d,
                                           settings, tables=tables)
            return shade
        if k == "d":
            work = clone_hits(row["hits"])

            def merge():  # on a fresh copy of #8's hits: D merges in place
                for a, b in zip(hit_lanes(work), hit_lanes(row["hits"])):
                    a.copy_(b)
                return pl.merge_entries(row["o"], row["dirs"], row["cands"], work, row["sk"],
                                        row["eh"], ds, row["g"], tables=tables)
            return merge
        return lambda: pl.place_entries(row["sk"], row["cands"].count)

    def same(k, got, want, row):
        if k in ("2", "3", "9"):
            return all(torch.equal(bits(a), bits(b))
                       for a, b in zip(mk.pool_lanes(got), mk.pool_lanes(want)))
        if k == "d":
            return all(torch.equal(bits(a), bits(b))
                       for a, b in zip(hit_lanes(got), hit_lanes(want)))
        if k == "a":
            n = int(row["cands"].count[0])
            return (torch.equal(got.keys[:, :n], want.keys[:, :n])
                    and torch.equal(bits(got.rays[:, :n]), bits(want.rays[:, :n]))
                    and torch.equal(bits(got.bt0[:n]), bits(want.bt0[:n]))
                    and torch.equal(got.hist, want.hist)
                    and (got.cursor is None or torch.equal(got.cursor, want.cursor)))
        if k == "7":
            live = row["alive"] != 0
            lanes = lambda c: set(c.lanes[:int(c.count[0])].tolist())  # noqa: E731
            return (all(torch.equal(bits(a[live]), bits(b[live]))
                        for a, b in zip((got.t, *got.normal, got.material_id, got.cand),
                                        (want.t, *want.normal, want.material_id, want.cand)))
                    and lanes(got) == lanes(want))
        m = int(want.total[0])
        pairs = lambda s: torch.sort(  # noqa: E731
            s.key[:m].long() * (1 << 32) + s.entry[:m].long()).values
        return int(got.total[0]) == m and torch.equal(pairs(got), pairs(want))

    def snapshot(k, out):
        if k in ("3", "9"):
            return clone_pool(out)
        return clone_hits(out) if k == "d" else out

    want = {(k, label): [snapshot(k, run(k, label, row)()) for row in data[label][3]]
            for k in kernels for label in PATHS[k]}
    torch.cuda.synchronize()
    held = lambda x, w: int(torch.nn.functional.pad(  # noqa: E731
        x, (0, -x.shape[0] % w)).view(-1, w).any(1).sum())
    work = {}
    for k in kernels:
        for label in PATHS[k]:
            rows = data[label][3]
            if k == "2":
                work[(k, label)] = {"lanes": [int(row["cam"].resolution[0])
                                              * int(row["cam"].resolution[1]) for row in rows]}
            elif k == "3":
                ends = [row[0][5].shape[0] if row[1] is None else int(row[1]) for row in rows]
                live = [(row[0][4][:e] != 0) for row, e in zip(rows, ends)]
                work[(k, label)] = {
                    "lanes_in": [int(x.sum()) for x in live],
                    "warps_with_live": [held(x, 32) for x in live],
                    # the 32-byte sectors of a float lane that hold a live lane
                    "sectors_with_live": [held(x, 8) for x in live]}
            elif k == "9":
                live = [row["alive"] != 0 for row in rows]
                work[(k, label)] = {
                    "lanes_in": [int(x.sum()) for x in live],
                    "warps_with_live": [held(x, 32) for x in live],
                    "sectors_with_live": [held(x, 8) for x in live],
                    "candidates": [int(row["cands"].count[0]) for row in rows]}
            elif k == "7":
                work[(k, label)] = {
                    "lanes_in": [int((row["alive"] != 0).sum()) for row in rows],
                    "warps_with_live": [held(row["alive"] != 0, 32) for row in rows]}
            elif k == "a":
                work[(k, label)] = {"listed": [int(row["cands"].count[0]) for row in rows]}
            elif k == "d":
                work[(k, label)] = {
                    "listed": [int(row["cands"].count[0]) for row in rows],
                    "entries": [int(row["sk"].hist.sum()) for row in rows],
                    # the listed lanes whose mesh hit D replaced
                    "hits": [int((w.t[lanes] != row["hits"].t[lanes]).sum())
                             for w, row in zip(want[(k, label)], rows)
                             for lanes in [row["cands"].lanes[:int(row["cands"].count[0])].long()]]}
            else:
                work[(k, label)] = {"listed": [int(row["cands"].count[0]) for row in rows],
                                    "entries": [int(w.total[0]) for w in want[(k, label)]]}
    committed = pl._launch
    results = []
    for turn, name in enumerate(order):
        k = name[-1]
        src, entry, symbol, what = KERNEL[k]
        lib = ctypes.CDLL(libs[name])
        getattr(lib, entry).argtypes = _native.SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int

        def launch(fn, what, *a, lib=lib, entry=entry):
            if fn != entry:
                return committed(fn, what, *a)
            if getattr(lib, fn)(*a) != 0:
                raise RuntimeError(f"{what}: launch failed")

        pl._launch = mk._launch = launch
        try:
            exact, per_path = True, {}
            for label in PATHS[k]:
                rows = data[label][3]
                differs = [row.get("config", d) if isinstance(row, dict) else d
                           for d, (row, w) in enumerate(zip(rows, want[(k, label)]))
                           if not same(k, run(k, label, row)(), w, row)]
                exact &= not differs
                if label in UNTIMED:
                    per_path[label] = {"configs": len(rows), "differs": differs}
                    continue
                per_depth = []
                for d, row in enumerate(rows):
                    fn = run(k, label, row)
                    for _ in range(3):  # a profile that recorded no launch is taken again
                        with profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
                            for _ in range(10):
                                fn()
                            torch.cuda.synchronize()
                        seen = [e for e in prof.events()
                                if e.device_type == torch.autograd.DeviceType.CUDA]
                        ms = [e.time_range.elapsed_us() / 1e3 for e in seen if symbol in e.name]
                        if ms:
                            break
                    else:  # left out of the mean, and said so
                        print(f"{name}: path ({label}) depth {d}: the profiler saw no "
                              f"launch, three times ({len(seen)} device events: "
                              f"{sorted({e.name[:60] for e in seen})[:4]})", file=sys.stderr)
                    per_depth.append(sum(ms) / len(ms) if ms else None)
                done = [x for x in per_depth if x is not None]
                per_path[label] = {"ms_per_depth": per_depth,
                                   "ms_mean": sum(done) / len(done) if done else None,
                                   "work_per_depth": work[(k, label)]}
        finally:
            pl._launch = mk._launch = committed
        row = {"variant": name, "turn": turn, "kernel": k, "source": f"csrc/{src}",
               "replaced": ("the --parent checkout's source" if name in PARENT.values()
                            else RESOLVED[name]),
               "paths": per_path, "bit_for_bit": None if name in WRONG else exact,
               "registers": registers(libs[name], symbol), "device": smi}
        results.append(row)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if all(r["bit_for_bit"] for r in results
                    if r["variant"].startswith(("committed", "parent"))) else 1


if __name__ == "__main__":
    sys.exit(main())
