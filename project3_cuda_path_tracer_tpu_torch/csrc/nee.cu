// NEE + MIS path-tracing kernels for Hopper (sm_90a):
//
//   #5 bounce_step_nee_kernel replaces ops/megakernel.py::bounce_step_pallas_nee:
//      one NEE + MIS bounce over the pool, in place, the MIS aux
//      (prev_pdf, prev_nondelta) riding as two more float lanes.
//   #6 full_iteration_nee_kernel replaces ops/megakernel.py::full_iteration_nee_pallas:
//      raygen and every bounce of the estimator for a run of iterations
//      in one launch, each pixel's radiance added into the caller's
//      accumulator iteration after iteration.
//
// The estimator is render._nee_mis_bounce (csrc/path_common.cuh
// `shade_nee`): at each vertex with a non-delta lobe, one point sampled on
// a uniformly chosen emissive geom (RNG stream 128 + depth), one shadow
// ray, and the power heuristic between that light sample and the BSDF
// sample that continues the path; the last depth (is_last) takes the light
// sample at full weight and ends every lane. The light list is an int32
// array of emissive geom indices; the MIS light pdf model (mean light area
// x count) arrives as one float.
//
// What bounds them on the H100: arithmetic and warp divergence, not bytes.
// Per live lane and bounce they do about twice #1's work: the nearest-hit
// sweep, the light sample, and a second sweep for the shadow ray (it
// stops at the first occluder, and only lanes that can take the light
// sample cast it). #6 moves 24 B per pixel per iteration (the
// accumulator); #5 reads 16 lanes and writes 15 per live lane (124 B).
// With one thread per path, a lane whose path has ended idles until its
// warp's longest path ends (#6), and a lane whose slot is dead idles
// while its warp's live lanes bounce (#5).
//
// Design: persistent warps (as many blocks as stay resident, computed once
// per device), each warp keeping all 32 lanes on live paths.
// - #6 is kernel #1's design (csrc/full_iteration.cu) with the MIS aux:
//   each lane holds one path (pixel, iteration, depth, path, aux) and the
//   pixel's running sum in registers; when its path ends it adds the
//   radiance to the sum, as the plain version adds one iteration after
//   another, and starts the pixel's next iteration with the aux reset to
//   (0, 0); after the pixel's last iteration it stores the sum and takes
//   the next pixel from a device-side counter (a ballot of the lanes that
//   need one, one atomicAdd per warp, a shuffle of the base). A lane's
//   step is ONE sweep over the geoms: its path's nearest-hit sweep, or its
//   vertex's shadow ray (`shade_nee` split at the shadow test: the arrival
//   and the light sample in one step, the light term and the continuation
//   in the next), both in one loop, so the lanes casting shadow rays and
//   the lanes tracing their paths sweep together instead of the shadow
//   rays running after every bounce while the other lanes wait. The light
//   term is kept as (term, scale) and added as `shade_nee` adds it.
// - #5 packs the pool's live slots into full warps: a warp takes chunks of
//   kChunk slots from a device-side counter, reads each 32 of their alive
//   words coalesced, and queues the live slots in two registers a lane
//   (lane j holds the queue's j-th slot, and its (32 + j)-th while the
//   queue holds more than 32: a ballot, then each lane pulls its slot with
//   `__fns`); it runs the bounce when all 32 lanes have a slot, and once
//   more for the rest when the pool is exhausted. A slot dead on entry is
//   read only for its alive word and never written.
// The RNG is keyed on (iteration, pixelIndex, depth), never on the lane,
// and each slot's or pixel's arithmetic is the thread-per-path kernels'
// (path_common.cuh's NEE pieces, the pdf's dot products with their
// rounding named), so which lane runs it, and in which step, changes no
// bit: both were held bit for bit against the thread-per-path kernels
// they replace (tools/torch_nee_ab.py), and chip_smoke.py holds #6 bit
// for bit against #5's route on every pixel whose camera ray the plain
// raygen reproduces (`nee_route_bits`).
// The NEE code is reached only from these two kernels, so #1-#4 compile
// as they did. Each kernel is a template on its tables: a scene with file
// textures, bump maps, a lat-long env map or SSS runs its instantiation on
// TexTables, which compiles path_common.cuh's surface stage (the albedo,
// the shading normal and the environment are the stage's at every term,
// and a subsurface vertex takes no light sample); the one on Tables
// compiles none of it. No matrix product here, so no wgmma or TMA.
//
// A scene with mesh geoms runs the instantiations on MeshOf<Tables> or
// MeshOf<TexTables>: the same tables, the mesh tables of
// ops/megakernel.py (the triangles) and every mesh geom's 8-wide BVH
// (models/wide_bvh.py, packed by megakernel.py::pack_nee_wide_tables: the
// big-mesh route's geoms included). The analytic sweep skips the mesh
// geoms; then each mesh geom's wide BVH is walked for the same ray, in
// object space, by the lane itself (the thread-per-path design stays):
// past the geom's box (its binary root's, the one slab test a ray that
// misses the mesh pays, as in a binary walk), the lane expands inner
// nodes until it holds a leaf, so that a warp's lanes test their leaves
// together: at an inner node it slab-tests the children (each of the
// node's six box rows and its count row is 32 B, two 16-byte loads; the
// ray's near and far rows picked once by its direction's signs), a child
// entering when its box is entered ahead of the origin at tmin <= t
// (#8's rule); the nearest entered child (the lower on equal tmin) is
// next, the others go on the stack in child order, the lowest on top. At
// a leaf it runs Moller-Trumbore on the leaf's triangles (`tri_test`, #8's
// rounding); then it pops, skipping an entry whose tmin lies past the
// best t. Nearest hit: the walk's object-space bound starts at the best
// world t so far times the Frobenius norm of inv's 3x3 (a bound on the
// object-space distance, as #7's candidacy), the least (t, triangle) the
// walk tests wins the geom (the binary walk's winner, ops/bvh_traverse.py
// ::mesh_intersect_bvh, but on lanes whose t lies an ulp inside a box's
// slab entry, as in #8; ops/bvh_traverse.py::mesh_intersect_wide(nee=True)
// walks in this order), its world distance is taken as mesh_common.cuh's
// `epilogue` takes it, and it wins the lane only when strictly nearer (an
// exact tie goes to the analytic geom, as in the mesh pipeline);
// `epilogue` then runs once, on the winner, for the normal, the side and
// the UVs. Shadow ray: a triangle occludes when its world distance, taken
// the same way, lies in (0, r - 1e-2): the plain version's rule on the
// nearest hit's world t, tested per triangle; the walk prunes by the
// bound's object-space image and stops at the first occluder
// (mesh_occluded_wide). The 80k triangle cap of the TPU kernels (a VMEM
// budget) has no counterpart. The stack lives in dynamic shared memory,
// sized at launch from the scene's deepest tree: (kWide - 1) x its wide
// depth 4-byte entries per thread (the nearest child stays in registers,
// so an inner node adds at most seven), word i of thread x at i *
// kThreads + x (a warp at one depth reads 32 consecutive words: no bank
// conflict); mesh.txt's depth 4 takes 14 KB a block, mesh_critter's 7
// takes 25 KB. An entry is a child's parent node and slot, (node << 3) |
// slot: its reference and count are read again when it is popped, and its
// tmin recomputed from its box's near rows (the same arithmetic, so the
// same bits) once the walk has a hit; 8-byte entries holding tmin would
// halve the depth a block's shared memory holds. A tree deeper than the
// H100's 227 KB a block holds (wide depth 64) is refused when the tables
// are packed (ops/megakernel.py::NEE_STACK_MAX).
// What bounds the walk on the H100 is issued instructions, not the chain
// of dependent loads: a wide node costs its eight children's slab tests
// where the binary walk, with ~9 times the nodes, tested one box each,
// so the work is alike and the latency the wide tree saves was hidden
// before. Measured in turns (PERF.md): ranking the entered children
// cost 20%, the octant rows and leaves tested together saved 3-8%; a
// smaller stack (more L1) changed nothing, a stack in local memory saved
// 3-6%. The walk is slower than the binary walk it replaced.

#include <algorithm>

#include "mesh_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 256;  // #5: pool slots per fetch from the counter
constexpr int kMeshGeom = 2;  // models/scene.py::GeomType.MESH
constexpr int kWide = 8;      // models/wide_bvh.py::WIDTH

// ---- the mesh instantiations' tables and walks ----

// The tables of a mesh scene: T's, the mesh tables and every mesh geom's
// wide BVH.
template <class T>
struct MeshOf : T {
  MeshTables m;
  const float* wbox;  // (N, 6, kWide): child min x, y, z, max x, y, z
  const int* wref;    // (N, 2, kWide): child reference, count (0 inner, -1 none)
  const int* wroot;   // (M,): each mesh geom's root node
};

template <class T>
struct IsMesh : std::false_type {};
template <class T>
struct IsMesh<MeshOf<T>> : std::true_type {};

// mesh[] = {tri, attr, box, geoms, chunk, super, wbox, wref, wroot}:
// the mesh tables of ops/megakernel.py::pack_mesh_tables and the wide BVH
// of pack_nee_wide_tables
template <class T>
inline MeshOf<T> with_mesh(const T& base, void* const* mesh, int n_mesh) {
  MeshOf<T> s;
  static_cast<T&>(s) = base;
  s.m = make_mesh_tables(mesh, n_mesh);
  s.wbox = static_cast<const float*>(mesh[6]);
  s.wref = static_cast<const int*>(mesh[7]);
  s.wroot = static_cast<const int*>(mesh[8]);
  return s;
}

// The world distance of the object-space hit at t on ray r from world
// origin o, as `epilogue` computes it.
__device__ __forceinline__ float world_distance(const Tables& s, int g, const ObjRay& r,
                                                float t, V3 o) {
  const V3 p_obj = r.o + r.d * (t - kRayEps);
  const V3 diff = o - xform_point(s.xf + 16 * g, p_obj);
  return sqrtf(dot(diff, diff));
}

// A ray's mesh winner: its world t (FLT_MAX for none), its mesh (-1 for
// none) and the walk's object-space winner there.
struct MeshWin {
  float t;
  int k;
  TriHit th;
};

// This thread's walk stack in its block's dynamic shared memory (the
// launch sizes it): entry i at [i * kThreads].
__device__ __forceinline__ unsigned* walk_stack() {
  extern __shared__ unsigned nee_stack[];
  return nee_stack + threadIdx.x;
}

// The box rows at which ray r enters each axis's slab: the min row (0,
// 1, 2) where its direction is positive, the max row (3, 4, 5) where it
// is negative; it leaves at the other one (3 - x, 5 - y, 7 - z). With
// them a box's entry and exit are a max and a min of three products, the
// bits of slab_span's on every ray not parallel to an axis (on one that
// is, a box whose plane holds the origin is entered here, missed there).
__device__ __forceinline__ int3 near_rows(const ObjRay& r) {
  return {r.inv_d.x < 0.0f ? 3 : 0, r.inv_d.y < 0.0f ? 4 : 1, r.inv_d.z < 0.0f ? 5 : 2};
}

// The children of wide node `node`: the mask of those entered (an
// existing child whose box the ray enters ahead of its origin at tmin <=
// t) and, in *nearest, the entered one of least tmin (the lowest on equal
// tmin; -1 for none). Each row is two 16-byte loads; a node's children
// fill its first slots, so a node of at most four skips its other half.
__device__ __forceinline__ unsigned wide_children(const float* wbox, const int* wref, int node,
                                                  const ObjRay& r, int3 nr, float t,
                                                  int* nearest) {
  const float4* b = reinterpret_cast<const float4*>(wbox) + static_cast<size_t>(node) * 12;
  const int4* c = reinterpret_cast<const int4*>(wref) + static_cast<size_t>(node) * 4 + 2;
  unsigned entered = 0;
  float near_t = 0.0f;
  *nearest = -1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int4 n = __ldg(c + h);
    if (h == 1 && n.x < 0) break;
    const float4 xn = __ldg(b + 2 * nr.x + h), yn = __ldg(b + 2 * nr.y + h);
    const float4 zn = __ldg(b + 2 * nr.z + h), xf = __ldg(b + 2 * (3 - nr.x) + h);
    const float4 yf = __ldg(b + 2 * (5 - nr.y) + h), zf = __ldg(b + 2 * (7 - nr.z) + h);
    const float nx[4] = {xn.x, xn.y, xn.z, xn.w}, ny[4] = {yn.x, yn.y, yn.z, yn.w};
    const float nz[4] = {zn.x, zn.y, zn.z, zn.w}, fx[4] = {xf.x, xf.y, xf.z, xf.w};
    const float fy[4] = {yf.x, yf.y, yf.z, yf.w}, fz[4] = {zf.x, zf.y, zf.z, zf.w};
    const int cnt[4] = {n.x, n.y, n.z, n.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float tn = fmaxf(fmaxf((nx[j] - r.o.x) * r.inv_d.x, (ny[j] - r.o.y) * r.inv_d.y),
                             (nz[j] - r.o.z) * r.inv_d.z);
      const float tf = fminf(fminf((fx[j] - r.o.x) * r.inv_d.x, (fy[j] - r.o.y) * r.inv_d.y),
                             (fz[j] - r.o.z) * r.inv_d.z);
      if (cnt[j] >= 0 && tf >= tn && tf > 0.0f && tn <= t) {
        entered |= 1u << (4 * h + j);
        if (*nearest < 0 || tn < near_t) {
          *nearest = 4 * h + j;
          near_t = tn;
        }
      }
    }
  }
  return entered;
}

// The slab entry of child k of wide node `node`, as wide_children takes it.
__device__ __forceinline__ float child_tmin(const float* wbox, int node, int k, const ObjRay& r,
                                            int3 nr) {
  const float* b = wbox + static_cast<size_t>(node) * 6 * kWide + k;
  return fmaxf(fmaxf((__ldg(b + nr.x * kWide) - r.o.x) * r.inv_d.x,
                     (__ldg(b + nr.y * kWide) - r.o.y) * r.inv_d.y),
               (__ldg(b + nr.z * kWide) - r.o.z) * r.inv_d.z);
}

// The walks of every mesh geom's wide BVH for the world ray (o, d), in
// mesh order. Nearest hit (!shadow): w->t enters as the analytic winner's
// world t (FLT_MAX on a miss); each geom's walk keeps the least (t,
// triangle) below the object-space image of w->t, and its world distance
// replaces w's when strictly less. Shadow ray: returns true at the first
// triangle whose world distance lies in (0, bound); w is not read. One
// loop for both, so #6's lanes of either kind walk together.
template <class T>
__device__ __forceinline__ bool mesh_walks(const MeshOf<T>& s, V3 o, V3 d, bool shadow,
                                           float bound, MeshWin* w) {
  unsigned* stack = walk_stack();
  for (int k = 0; k < s.m.n_mesh; ++k) {
    const int4 mg = __ldg(s.m.geoms + k);
    const int g = mg.x;
    const float* inv = s.inv + 16 * g;
    const ObjRay r = object_ray(inv, o, d);
    const float lim = shadow ? bound : w->t;
    TriHit th = {lim < kFltMax ? lim * frobenius3(inv) : kFltMax, -1, 0.0f, 0.0f};
    // the geom's box first (its binary root's, as #7 tests it): most rays
    // miss it, and one slab test is all they pay
    if (!slab_enter(__ldg(s.m.box + 2 * mg.y), __ldg(s.m.box + 2 * mg.y + 1), r, th.t)) continue;
    // the entry to visit next: an inner node (count 0), a leaf's first
    // triangle and count, or none (count -1)
    int ref = __ldg(s.wroot + k), count = 0;
    int sp = 0;
    const int3 nr = near_rows(r);
    // the next entry that the bound does not cut: its tmin, recomputed,
    // can lie past t only once the walk has a hit (t shrank since the push)
    const auto pop = [&]() {
      count = -1;
      while (sp > 0) {
        const unsigned e = stack[--sp * kThreads];
        const int node = static_cast<int>(e >> 3), c = static_cast<int>(e & 7u);
        if (th.tri >= 0 && !(child_tmin(s.wbox, node, c, r, nr) <= th.t)) continue;
        ref = __ldg(s.wref + node * 2 * kWide + c);
        count = __ldg(s.wref + (node * 2 + 1) * kWide + c);
        break;
      }
    };
    for (;;) {
      // inner nodes until the lane holds a leaf (so a warp's lanes test
      // their leaves together) or has nothing left
      while (count == 0) {
        const int node = ref;
        // the nearest entered child (the lower on equal tmin) is next; the
        // others go on the stack, the lowest on top
        int nearest;
        const unsigned entered = wide_children(s.wbox, s.wref, node, r, nr, th.t, &nearest);
#pragma unroll
        for (int c = kWide - 1; c >= 0; --c) {
          if (((entered >> c) & 1u) && c != nearest) {
            stack[sp++ * kThreads] = (static_cast<unsigned>(node) << 3) | c;
          }
        }
        if (nearest >= 0) {
          ref = __ldg(s.wref + node * 2 * kWide + nearest);
          count = __ldg(s.wref + (node * 2 + 1) * kWide + nearest);
        } else {
          pop();
        }
      }
      if (count < 0) break;
      for (int j = 0; j < count; ++j) {
        float t, u, v;
        if (tri_test(s.m, ref + j, r, &t, &u, &v)) {
          if (!shadow) {
            if (t < th.t || (t == th.t && ref + j < th.tri)) th = {t, ref + j, u, v};
          } else if (t < th.t) {
            const float dist = world_distance(s, g, r, t, o);
            if (dist > 0.0f && dist < bound) return true;
          }
        }
      }
      pop();
      if (count < 0) break;
    }
    if (!shadow && th.tri >= 0) {
      const float t = world_distance(s, g, r, th.t, o);
      if (t > 0.0f && t < w->t) *w = {t, k, th};
    }
  }
  return false;
}

// The lane's hit from the analytic winner (best_t, best_g) and the mesh
// winner w: `epilogue` on w's triangle when it has one (the world t, the
// oriented normal, the UVs), else the analytic winner's normal.
template <class T>
__device__ __forceinline__ HitOf<T> mesh_hit(const MeshOf<T>& s, V3 o, V3 d, float best_t,
                                             int best_g, const MeshWin& w) {
  HitOf<T> h;
  h.t = best_t;
  h.n = {0.0f, 0.0f, 0.0f};
  h.mat = -1;
  h.outside = true;
  if constexpr (T::kTex) {
    h.u = 0.0f;
    h.v = 0.0f;
    h.has_uv = false;
  }
  if (w.k >= 0) {
    const int4 mg = __ldg(s.m.geoms + w.k);
    const MeshHit mh =
        epilogue(s, s.m, mg.x, mg.w != 0, object_ray(s.inv + 16 * mg.x, o, d), w.th, o, d);
    h.t = mh.t;
    h.n = mh.n;
    h.outside = mh.outside;
    h.mat = __ldg(s.gmat + mg.x);
    if constexpr (T::kTex) {
      h.u = mh.u;
      h.v = mh.v;
      h.has_uv = mg.w != 0;
    }
  } else if (best_g >= 0) {
    geom_test(s, best_g, o, d, true, &h.n, &h.outside);
    h.mat = __ldg(s.gmat + best_g);
  }
  return h;
}

// A ray's MeshWin before the walks: the analytic winner's world t.
__device__ __forceinline__ MeshWin no_mesh_win(float best_t) {
  return {best_t > 0.0f ? best_t : kFltMax, -1, {kFltMax, -1, 0.0f, 0.0f}};
}

// path_common.cuh's `intersect` on a mesh scene (#5): the analytic sweep
// over the other geoms (the same order and strict-< rule), then the mesh
// walks.
template <class T>
__device__ __forceinline__ HitOf<T> intersect(const MeshOf<T>& s, V3 org, V3 dir) {
  float best_t = -1.0f;
  int best_g = -1;
  for (int g = 0; g < s.n_geoms; ++g) {
    if (__ldg(s.gtype + g) == kMeshGeom) continue;
    const float t = geom_test(s, g, org, dir, false, nullptr, nullptr);
    const float prev = best_t > 0.0f ? best_t : kFltMax;
    if (t > 0.0f && prev > t) {
      best_t = t;
      best_g = g;
    }
  }
  MeshWin w = no_mesh_win(best_t);
  mesh_walks(s, org, dir, false, 0.0f, &w);
  return mesh_hit(s, org, dir, best_t, best_g, w);
}

// path_common.cuh's `unoccluded` on a mesh scene (#5's `shade_nee` finds
// it by argument-dependent lookup): the analytic any-hit loop over the
// other geoms, then the mesh walks.
template <class T>
__device__ __forceinline__ bool unoccluded(const MeshOf<T>& s, V3 o, V3 d, float r) {
  const float bound = r - 1e-2f;
  for (int g = 0; g < s.n_geoms; ++g) {
    if (__ldg(s.gtype + g) == kMeshGeom) continue;
    const float t = geom_test(s, g, o, d, false, nullptr, nullptr);
    if (t > 0.0f && t < bound) return false;
  }
  MeshWin w = no_mesh_win(-1.0f);
  return !mesh_walks(s, o, d, true, bound, &w);
}

// #6. A lane's step is one sweep: its path's nearest-hit sweep, or its
// vertex's shadow ray. The bounce is `shade_nee` (path_common.cuh) split
// at the shadow test, each expression as there: the arrival, the vertex
// and the light sample in the nearest-hit step; the light term and the
// continuation (`scatter`, the next aux) in the shadow step, or in the
// same step when the vertex casts no shadow ray. (The same split written
// as shared pieces that `shade_nee` also calls compiled to other roundings
// here, an ulp off on 2-7% of the accumulator's values: so it stays
// written out once more, and chip_smoke.py's `nee_route_bits` holds it
// bit for bit against `shade_nee` as #5 runs it.) 6 blocks of kThreads
// stay resident on an SM at its 80 registers; naming that minimum (ptxas
// spills a few bytes) was faster on the H100 than 90 registers at 5
// blocks. On a mesh scene (MeshOf) the step's sweep skips the mesh geoms
// and then walks them (`mesh_walks`, for the path's nearest hit or the
// shadow ray, as #5's `intersect` and `unoccluded` do); the hit keeps a
// mesh winner's UVs over the vertex's shadow step (HitOf<T>). The mesh
// instantiations name 5 blocks (96 registers, 304-344 B of spills): with
// the wide walk, on the H100 at 800x800 AA, 5 ran 1% and 6% faster than 6
// (80 registers, about 550 B) on mesh.txt and mesh_textured and 2% slower
// on mesh_big, and 4% and 7% faster than 4 (128, none) on mesh.txt and
// mesh_big, 3% slower on mesh_textured.
template <class T>
__global__ void __launch_bounds__(kThreads, IsMesh<T>::value ? 5 : 6)
    full_iteration_nee_kernel(const T s, const Lights L, const float* __restrict__ cam,
                              float* acc_r, float* acc_g, float* acc_b, int iteration0,
                              int n_iters, int resx, int resy, int depth,
                              int* __restrict__ counter) {
  const int n_pixels = resx * resy;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  bool need = true;    // this lane has no pixel
  bool done = false;   // the pixels ran out for this lane
  bool fresh = false;  // the lane's next step starts a path
  bool shadow = false;  // the lane's next step sweeps its vertex's shadow ray
  int pix = 0, k = 0, d = 0;  // pixel, its iteration (from iteration0), depth
  V3 sum = {0.0f, 0.0f, 0.0f};  // acc[pix] plus the pixel's paths so far
  Path p;
  NeeAux a;
  // the vertex, kept over its shadow step (with a mesh winner's UVs on a
  // mesh scene's TexTables)
  typename std::conditional<IsMesh<T>::value, HitOf<T>, Hit>::type h;
  V3 p_hit, wi, contrib;  // its point, the shadow ray's direction, and
  float scale = 0.0f;     // the light term contrib * scale
  float bound = 0.0f;     // the shadow ray's length less 1e-2
  for (;;) {
    // each lane without a pixel takes the next one: one atomicAdd per warp
    const unsigned want = __ballot_sync(kFull, need);
    if (want) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(counter, __popc(want));
      base = __shfl_sync(kFull, base, leader);
      if (need) {
        pix = base + __popc(want & below);
        need = false;
        done = pix >= n_pixels;
        if (!done) {
          sum = {acc_r[pix], acc_g[pix], acc_b[pix]};
          k = 0;
          fresh = true;
        }
      }
    }
    if (!__any_sync(kFull, !done)) break;
    if (done) continue;
    const int iteration = iteration0 + k;
    const uint32_t it = static_cast<uint32_t>(iteration);
    if (fresh) {
      raygen(cam, pix, resx, resy, iteration, s.flags, &p.org, &p.dir);
      p.thr = {1.0f, 1.0f, 1.0f};
      p.rad = {0.0f, 0.0f, 0.0f};
      a = NeeAux{0.0f, 0.0f};
      d = 0;
      fresh = false;
      shadow = false;
    }
    bool ends = d >= depth;
    if (!ends) {
      // the step's sweep: the nearest hit of the path's ray, or any hit of
      // the shadow ray below its bound (path_common.cuh `intersect` and
      // `unoccluded`, one loop)
      const V3 ro = shadow ? p_hit : p.org;
      const V3 rd = shadow ? wi : p.dir;
      float best_t = -1.0f;
      int best_g = -1;
      bool blocked = false;
      for (int g = 0; g < s.n_geoms; ++g) {
        if constexpr (IsMesh<T>::value) {
          if (__ldg(s.gtype + g) == kMeshGeom) continue;
        }
        const float t = geom_test(s, g, ro, rd, false, nullptr, nullptr);
        if (shadow) {
          if (t > 0.0f && t < bound) {
            blocked = true;
            break;
          }
        } else {
          const float prev = best_t > 0.0f ? best_t : kFltMax;
          if (t > 0.0f && prev > t) {
            best_t = t;
            best_g = g;
          }
        }
      }
      if constexpr (IsMesh<T>::value) {
        // the mesh walks of the step's ray: the shadow lanes' and the
        // path lanes' in one loop
        MeshWin w = no_mesh_win(best_t);
        if (!blocked && mesh_walks(s, ro, rd, shadow, bound, &w)) blocked = true;
        if (!shadow) h = mesh_hit(s, p.org, p.dir, best_t, best_g, w);
      }
      const bool is_last = d == depth - 1;
      bool vertex = true;  // a non-emissive hit to shade in this step
      if (!shadow) {
        if constexpr (!IsMesh<T>::value) {
          h.t = best_t;
          h.n = {0.0f, 0.0f, 0.0f};
          h.mat = -1;
          h.outside = true;
          if (best_g >= 0) {
            geom_test(s, best_g, p.org, p.dir, true, &h.n, &h.outside);
            h.mat = __ldg(s.gmat + best_g);
          }
        }
        const NeeAux prev = a;
        a = NeeAux{0.0f, 0.0f};
        if (!(h.t > 0.0f)) {
          escape(s, p);
          ends = true;
          vertex = false;
        } else {
          p_hit = p.org + p.dir * (h.t - kRayEps);
          HitOf<T> he = h;  // the hit as shaded
          const Material me = surface(s, he, p_hit);
          if (me.emit > 0.0f) {
            float w_bsdf = 1.0f;
            if (prev.nondelta > 0.5f) {
              const float cos_l = fabsf(dot(he.n, p.dir));
              const float pdf_light = (h.t * h.t) / fmaxf(cos_l * L.aw, 1e-8f);
              const float pp = prev.pdf * prev.pdf;
              w_bsdf = pp / fmaxf(pp + pdf_light * pdf_light, 1e-20f);
            }
            p.rad = p.rad + p.thr * (me.color * me.emit) * w_bsdf;
            ends = true;
            vertex = false;
          }
        }
      }
      if (vertex) {
        // the vertex as shaded (the surface stage again in its shadow step:
        // h keeps the hit's own normal)
        HitOf<T> hs = h;
        const Material mt = surface(s, hs, p_hit);
        const V3 n = hs.n;
        const float p_mix = clamp01(mt.refl);
        const bool glossy_lobe = (s.flags & kGlossy) && p_mix > 0.0f && mt.sexp > 0.0f;
        bool nee_able = mt.refr <= 0.0f && (p_mix < 1.0f || glossy_lobe);
        if constexpr (T::kTex) nee_able = nee_able && !subsurface(s, mt);
        const V3 mirror = p.dir - n * (2.0f * dot(p.dir, n));
        bool go_on = true;  // the vertex continues in this step
        if (shadow) {
          if (!blocked) p.rad = p.rad + contrib * scale;
          shadow = false;
        } else if (nee_able) {
          float ul[5];
          draw(it, kNeeDepthBase + static_cast<uint32_t>(d), static_cast<uint32_t>(pix), 3, ul);
          LightSample ls;
          if (sample_light(s, L, ul[0], ul[1], ul[2], &ls)) {
            const V3 to_l = ls.p - p_hit;
            const float r2 = fmaxf(dot(to_l, to_l), 1e-8f);
            const float r = sqrtf(r2);
            wi = to_l * (1.0f / r);
            const float cos_s = fmaxf(dot(n, wi), 0.0f);
            const float cos_l = fmaxf(-dot(ls.n, wi), 0.0f);
            if (cos_s > 0.0f && cos_l > 0.0f) {
              float pdf_lobe = 0.0f;
              if (glossy_lobe) {
                const float cos_a = fmaxf(dot(mirror, wi), 0.0f);
                pdf_lobe = (mt.sexp + 1.0f) * kHalfInvPi * powf(cos_a, mt.sexp);
              }
              float w_light = 1.0f;
              if (!is_last) {
                const float pl = r2 / fmaxf(cos_l * L.aw, 1e-8f);
                const float pb = (1.0f - p_mix) * cos_s * kInvPi + p_mix * pdf_lobe;
                w_light = (pl * pl) / fmaxf(pl * pl + pb * pb, 1e-20f);
              }
              const float g_geo = cos_s * cos_l / r2 * ls.weight;
              const V3 f_diff = mt.color * ((1.0f - p_mix) * kInvPi);
              const float f_spec = p_mix * pdf_lobe / fmaxf(cos_s, 1e-6f);
              const V3 f_mix = f_diff + mt.spec * f_spec;
              contrib = p.thr * f_mix * ls.le;
              scale = g_geo * w_light;
              bound = r - 1e-2f;
              shadow = true;
              go_on = false;
            }
          }
        }
        if (go_on) {
          if (is_last || !scatter(s, p, hs, mt, p_hit, it, d, static_cast<uint32_t>(pix))) {
            ends = true;
          } else {
            const float m_dot = dot_fma(mirror, p.dir);
            float next_pdf = (1.0f - p_mix) * fmaxf(dot_fma(n, p.dir), 0.0f) * kInvPi;
            if (s.flags & kGlossy) {
              const float lobe = glossy_lobe
                                     ? (mt.sexp + 1.0f) * kHalfInvPi *
                                           powf(fmaxf(m_dot, 0.0f), mt.sexp)
                                     : 0.0f;
              next_pdf = next_pdf + p_mix * lobe;
            }
            const bool mirror_pick = p_mix > 0.0f && !glossy_lobe && m_dot > kMirrorCos;
            a.pdf = next_pdf;
            a.nondelta = (nee_able && !mirror_pick) ? 1.0f : 0.0f;
            ++d;
          }
        }
      }
    }
    if (ends) {
      sum = sum + p.rad;
      if (++k < n_iters) {
        fresh = true;
      } else {
        acc_r[pix] = sum.x;
        acc_g[pix] = sum.y;
        acc_b[pix] = sum.z;
        need = true;
      }
    }
  }
}

// One NEE + MIS bounce of live slot i of the pool, in place: the
// thread-per-slot kernel's body.
template <class T>
__device__ __forceinline__ void nee_bounce_slot(const T& s, const Lights& L,
                                                const Lanes& pool, float* prev_pdf,
                                                float* prev_nondelta, int i, uint32_t it,
                                                int depth, bool is_last) {
  Path p = load_path(pool, i);
  NeeAux a = {prev_pdf[i], prev_nondelta[i]};
  // a Hit; on a mesh scene's tables the mesh-aware `intersect` above
  const auto h = intersect(s, p.org, p.dir);
  const bool alive =
      shade_nee(s, L, p, a, h, it, depth, static_cast<uint32_t>(pool.pix[i]), is_last);
  store_path(pool, i, p);
  pool.alive[i] = alive ? 1 : 0;
  prev_pdf[i] = a.pdf;
  prev_nondelta[i] = a.nondelta;
}

// #5. 6 blocks per SM at 80 registers (95 without the bound): 3% faster
// on many_materials 1080p RR, 7% slower on Cornell 800x800 AA, on the H100.
// On a mesh scene (MeshOf) its slots intersect and cast their shadow rays
// through the mesh-aware `intersect` and `unoccluded` above; those
// instantiations name 4 blocks (128 registers, no spill): with the wide
// walk, on the H100 at 800x800 AA, 4 ran 5% and 11% faster than 5 on
// mesh.txt and mesh_textured, and 5 3% and 10% faster than 6.
template <class T>
__global__ void __launch_bounds__(kThreads, IsMesh<T>::value ? 4 : 6)
    bounce_step_nee_kernel(const T s, const Lights L, const Lanes pool,
                           float* __restrict__ prev_pdf, float* __restrict__ prev_nondelta,
                           int n, int iteration, int depth, int is_last,
                           int* __restrict__ counter) {
  const int lane = threadIdx.x & 31;
  const uint32_t it = static_cast<uint32_t>(iteration);
  const bool last = is_last != 0;
  int queued = 0;      // live slots in the queue (the same in every lane)
  int q = 0;           // the queue's lane-th slot
  int o = 0;           // its (32 + lane)-th, while the queue holds more than 32
  int b = 0, end = 0;  // the next 32 slots of the warp's chunk, its end
  bool more = true;    // the counter may hand out more chunks
  for (;;) {
    while (more && queued < 32) {
      if (b >= end) {
        int base = 0;
        if (lane == 0) base = atomicAdd(counter, kChunk);
        base = __shfl_sync(kFull, base, 0);
        more = base < n;
        if (!more) break;
        b = base;
        end = min(base + kChunk, n);
      }
      const int i = b + lane;
      const unsigned live = __ballot_sync(kFull, i < end && pool.alive[i] != 0);
      const int c = __popc(live);
      // lane j takes the (j - queued)-th live slot of these 32, and the
      // (j + 32 - queued)-th into its overflow
      const int r = lane - queued;
      if (r >= 0 && r < c) q = b + static_cast<int>(__fns(live, 0, r + 1));
      if (r + 32 < c) o = b + static_cast<int>(__fns(live, 0, r + 33));
      queued += c;
      b += 32;
    }
    if (queued == 0) break;
    // all 32 lanes, or the last slots once the pool is exhausted
    if (lane < queued) nee_bounce_slot(s, L, pool, prev_pdf, prev_nondelta, q, it, depth, last);
    q = o;
    queued = max(queued - 32, 0);
  }
}

inline Lights make_lights(void* const* tables, int n_lights, float aw) {
  Lights L;
  L.idx = static_cast<const int*>(tables[7]);
  L.n = n_lights;
  L.aw = aw;
  return L;
}

// A kernel's resident blocks on a device at `smem` bytes of dynamic
// shared memory a block, 0 until queried.
struct Resident {
  int blocks;
  int smem;
};

// Each kernel's resident blocks per device, for the smem of its last
// launch there: its instantiations on Tables, TexTables, MeshOf<Tables>,
// MeshOf<TexTables>.
Resident g_resident_nee[4][64];
Resident g_resident_bounce[4][64];

// The dynamic shared memory of a launch on tables s: the mesh walk's
// stack of `stack` entries a thread on MeshOf, none on the others.
template <class S>
int stack_bytes(int stack) {
  return IsMesh<S>::value ? stack * kThreads * static_cast<int>(sizeof(unsigned)) : 0;
}

// The resident blocks of `kernel` on `device` (every SM's) at `smem`
// bytes of dynamic shared memory a block, into *out; past the default 48
// KB the kernel is first allowed that much (the opt-in limit refuses a
// deeper stack with cudaErrorInvalidValue).
template <class Kernel>
cudaError_t resident_at(Kernel kernel, int device, int smem, Resident* cache, int* out) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  Resident& r = cache[device];
  if (r.blocks == 0 || r.smem != smem) {
    cudaError_t err;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
    r = {sms * per_sm, smem};
  }
  *out = r.blocks;
  return cudaSuccess;
}

// #5 on tables s: one warp per chunk at most.
template <class S>
cudaError_t launch_bounce_nee(const S& s, int stack, Resident* resident_cache, const Lights& L,
                              void* const* pool, int n, int iteration, int depth, int is_last,
                              int* counter, int device, cudaStream_t st) {
  const int smem = stack_bytes<S>(stack);
  int resident = 0;
  const cudaError_t err =
      resident_at(bounce_step_nee_kernel<S>, device, smem, resident_cache, &resident);
  if (err != cudaSuccess) return err;
  const int wanted = n_blocks(((n + kChunk - 1) / kChunk) * 32);
  bounce_step_nee_kernel<<<std::min(resident, wanted), kThreads, smem, st>>>(
      s, L, make_lanes(pool), static_cast<float*>(pool[14]), static_cast<float*>(pool[15]), n,
      iteration, depth, is_last, counter);
  return cudaSuccess;
}

// #6 on tables s.
template <class S>
cudaError_t launch_full_nee(const S& s, int stack, Resident* resident_cache, const Lights& L,
                            const float* cam, float* const* acc, int iteration0, int n_iters,
                            int resx, int resy, int depth, int* counter, int device,
                            cudaStream_t st) {
  const int smem = stack_bytes<S>(stack);
  int resident = 0;
  const cudaError_t err =
      resident_at(full_iteration_nee_kernel<S>, device, smem, resident_cache, &resident);
  if (err != cudaSuccess) return err;
  full_iteration_nee_kernel<<<std::min(resident, n_blocks(resx * resy)), kThreads, smem, st>>>(
      s, L, cam, acc[0], acc[1], acc[2], iteration0, n_iters, resx, resy, depth, counter);
  return cudaSuccess;
}

// Run f on the tables of this launch: Tables or TexTables (the surface
// stage's flags), wrapped in MeshOf when the scene has mesh geoms; f gets
// the tables and the index of their instantiation (0-3).
template <class F>
cudaError_t with_tables(void* const* tables, int n_geoms, int flags, int rr_start,
                        void* const* mesh, int n_mesh, F f) {
  if (flags & kSurfaceStage) {
    const TexTables t = make_tex_tables(tables, n_geoms, flags, rr_start);
    return n_mesh > 0 ? f(with_mesh(t, mesh, n_mesh), 3) : f(t, 1);
  }
  const Tables t = make_tables(tables, n_geoms, flags, rr_start);
  return n_mesh > 0 ? f(with_mesh(t, mesh, n_mesh), 2) : f(t, 0);
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t,
// PyTorch's current stream) of CUDA device `device` and returns
// cudaGetLastError() of the launch, or the occupancy query's (or the
// shared memory opt-in's) error: the
// kernel's instantiation on TexTables when flags has a kSurfaceStage bit,
// on MeshOf<...> when n_mesh > 0.
// tables = {xf, inv, invt, gtype, gmat, mat, env, lights, surf, tex, bump,
// envmap}; aw = the MIS light pdf model (mean light area x n_lights);
// mesh = {tri, attr, box, geoms, chunk, super, wbox, wref, wroot} for the
// n_mesh mesh geoms (null when n_mesh is 0), and stack the mesh walk's
// stack entries a thread ((kWide - 1) x the deepest wide tree; 0 without
// meshes); counter: one int32 on the device, zero before the launch and
// used by no other launch.

// pool = 16 pointers: the 12 float lanes, alive, pix, prev_pdf, prev_nondelta.
extern "C" int pt_bounce_step_nee(void* const* tables, int n_geoms, int n_lights, float aw,
                                  void* const* mesh, int n_mesh, int stack, void* const* pool,
                                  int n,
                                  int iteration, int depth, int is_last, int rr_start,
                                  int flags, int* counter, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Lights L = make_lights(tables, n_lights, aw);
    err = with_tables(tables, n_geoms, flags, rr_start, mesh, n_mesh, [&](const auto& s, int v) {
      return launch_bounce_nee(s, stack, g_resident_bounce[v], L, pool, n, iteration, depth,
                               is_last, counter, device, st);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Iterations iteration0 .. iteration0 + n_iters - 1; acc = {r, g, b}.
extern "C" int pt_full_iteration_nee(void* const* tables, int n_geoms, int n_lights, float aw,
                                     void* const* mesh, int n_mesh, int stack,
                                     const float* cam,
                                     float* const* acc, int iteration0, int n_iters, int resx,
                                     int resy, int depth, int rr_start, int flags, int* counter,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resx * resy > 0 && n_iters > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Lights L = make_lights(tables, n_lights, aw);
    err = with_tables(tables, n_geoms, flags, rr_start, mesh, n_mesh, [&](const auto& s, int v) {
      return launch_full_nee(s, stack, g_resident_nee[v], L, cam, acc, iteration0, n_iters,
                             resx, resy, depth, counter, device, st);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
