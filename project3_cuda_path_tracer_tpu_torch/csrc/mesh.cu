// The mesh pipeline for Hopper (sm_90a): four kernels that replace the
// dense route of the JAX package's ops/pipeline.py.
//
//   #7  mesh_candidates_kernel replaces _intersect_phase's K1: for each lane
//       it sweeps the analytic geoms (the path_common.cuh box and sphere
//       tests, in geom order, min-t rule), writes the analytic winner, and
//       decides mesh candidacy: the ray enters a mesh geom's object-space
//       root box before the analytic t times the Frobenius norm of inv's
//       3x3 (a bound on the object-space distance), or before FLT_MAX on a
//       miss. A block owns kCandLanes consecutive lanes (kCandPer a
//       thread): it packs the ones to sweep (the live lanes below the live
//       count; every lane under all_lanes) into its first threads, in lane
//       order, so a thin pool's sweeps run in full warps and a block with
//       no live lane does no sweep; the sweeps run with no barrier between
//       a thread's lanes. Candidate lane ids go to the list through one
//       atomicAdd per block (warp ballots, a prefix over the block's
//       warps, one reservation): the list holds the candidates of a
//       block's lanes in ascending order, the blocks' runs in the order
//       they reserve (an ascending list would need each block to wait on
//       the runs before its own). The count stays on the device. This
//       takes the place of the TPU's in-tile compaction network, per-tile
//       counts and cumsum glue.
//   #8  mesh_sweep_kernel replaces K2: a group of kWide lanes per list
//       entry, over a persistent grid (as many blocks as stay resident)
//       whose groups take entries from an atomic counter until they reach
//       the device-side count, so the launch does not depend on the pool
//       and a group whose walks end early takes more. For each mesh geom the
//       lane is a candidate of, the group walks the geom's wide BVH
//       (models/wide_bvh.py, packed by ops/pipeline.py::pack_wide_tables)
//       in object space: it pops an entry of its stack in shared memory,
//       skips it when its tmin is past the best t, and at an inner node
//       lane k slab-tests child k (tmin <= t enters; the node's children
//       are structure-of-arrays, so a row is one load for the group), a
//       group ballot lists the entered ones and each lane pushes its own
//       child at its rank (nearer tmin first, the lower child on equal
//       tmin, so the nearest is on top); at a leaf lane k runs
//       Moller-Trumbore on triangle k, the group takes the least t bits
//       (the lowest lane, so the lowest triangle, on equal t) and that
//       (t, triangle) replaces the best when it is less. The winner is
//       the least (t, triangle) the walk tested: the plain binary walk's
//       (ops/bvh_traverse.py::mesh_intersect_bvh, which meets leaves in
//       ascending triangle order with the strict-< rule), but on lanes
//       whose winning t lies an ulp inside a box's slab entry. Then the
//       world-space tail (distance, oriented normal, UVs); the group's
//       first lane writes the mesh winner at the lane's own index, so the
//       output does not depend on the order the atomics gave the list. A
//       geom of the big-mesh route has no wide root (-1): sorted.cu sweeps
//       it after #8. When no geom has a root, mesh_sweep_kernel_no_walk
//       writes each listed lane's "no hit", one thread per entry.
//   #9  bounce_step_mesh_kernel replaces bounce_step_pipeline's K3: one
//       thread per lane, in place on the pool. The mesh hit wins iff the
//       lane is a candidate, t_mesh > 0 and (t_a > 0 ? t_a : FLT_MAX) >
//       t_mesh, decided from those three reads; the winner's other fields
//       are then read from its lanes alone (merged_hit). Then the shared
//       `shade` body exactly as kernel #3 runs it (the same RNG slots keyed
//       on pix, Russian roulette, the live-count skip). The BVH walk stays
//       in #8, so #9's body is #3's less the sweep. It is a template on its
//       tables: a scene with file textures, bump maps, a lat-long env map
//       or SSS runs its instantiation on TexTables, which compiles
//       path_common.cuh's surface stage and reads a mesh winner's UVs and
//       has_uv with its other fields (#8's, or D's on the big-mesh route). #3's packing of a
//       block's live lanes was measured here and gains nothing (PERF.md
//       §6): #9 is held by the 32-byte sectors of its pool, not its warps.
//   #10 intersect_mesh_kernel replaces intersect_pipeline's K3: the same
//       merge without shading, written as Intersections lanes (t, normal,
//       material, outside, tex_u, tex_v, has_uv). Dead lanes keep their
//       analytic hit, as the JAX package returns them.
//
// What bounds them on the H100: #8 is each walk's chain of dependent
// loads (a wide node's boxes, a leaf's triangles, both through the
// read-only cache) and the group's reductions, #7 and #9 the same
// arithmetic as kernel #3's sweep and shading (its IEEE divisions
// included; on a thin pool #7 the latency of a block's sweeps), #10 its
// bytes. What the designs do about it: #7 sweeps only live lanes, in
// full warps, and compacts the candidates so that #8 works on rays that
// enter a mesh; #8 puts kWide lanes on each ray, so a walk of
// mesh.txt takes about 4.6 inner nodes and 1.5 leaves where the binary
// walk took 35.7 nodes and 7.3 triangles one after another, keeps every
// resident warp on list entries and visits children nearest first, so the
// running t shrinks early.

#include <algorithm>

#include "mesh_common.cuh"

namespace {

constexpr int kMesh = 2;  // models/scene.py::GeomType.MESH
constexpr int kWide = 8;  // models/wide_bvh.py::WIDTH: #8's lanes per ray
constexpr int kGroups = kThreads / kWide;  // #8's rays per block
constexpr int kCandThreads = 128;  // #7: threads a block
constexpr int kCandWarps = kCandThreads / 32;
constexpr int kCandPer = 2;  // #7: lanes a thread owns
constexpr int kCandLanes = kCandThreads * kCandPer;  // #7: lanes a block owns
constexpr int kLiveBit = 1 << 30;  // #7: a packed lane's flags, above its index
constexpr int kCandBit = 1 << 29;
constexpr int kLaneMask = kCandBit - 1;

// intersect() of path_common.cuh over the analytic geoms alone: the same
// geom order and strict-< rule, mesh geoms skipped.
__device__ __forceinline__ Hit intersect_analytic(const Tables& s, V3 org, V3 dir) {
  float best_t = -1.0f;
  int best_g = -1;
  for (int g = 0; g < s.n_geoms; ++g) {
    if (__ldg(s.gtype + g) == kMesh) continue;
    const float t = geom_test(s, g, org, dir, false, nullptr, nullptr);
    const float prev = best_t > 0.0f ? best_t : kFltMax;
    if (t > 0.0f && prev > t) {
      best_t = t;
      best_g = g;
    }
  }
  Hit h;
  h.t = best_t;
  h.n = {0.0f, 0.0f, 0.0f};
  h.mat = -1;
  h.outside = true;
  if (best_g >= 0) {
    geom_test(s, best_g, org, dir, true, &h.n, &h.outside);
    h.mat = __ldg(s.gmat + best_g);
  }
  return h;
}

// Mesh candidacy of one lane for mesh k (ops/pipeline.py::
// mesh_candidacy): the object-space ray, and whether it enters the geom's
// root box before the analytic hit's object-space bound. #7 and #8 both
// call this, so #8's per-geom test is exactly #7's.
__device__ __forceinline__ bool mesh_candidate(const Tables& s, const MeshTables& m, int k, V3 o,
                                               V3 d, float t_a, ObjRay* r) {
  const int4 mg = __ldg(m.geoms + k);
  const float* inv = s.inv + 16 * mg.x;
  *r = object_ray(inv, o, d);
  const float bound = t_a > 0.0f ? t_a * frobenius3(inv) : kFltMax;
  return slab_enter(__ldg(m.box + 2 * mg.y), __ldg(m.box + 2 * mg.y + 1), *r, bound);
}

// #8's wide BVH (ops/pipeline.py::pack_wide_tables).
struct WideTables {
  const float* box;  // (N, 6, kWide): child min xyz, max xyz
  const int* ref;    // (N, 2, kWide): child reference, triangle count
  const int* root;   // (M,): per mesh geom its root, -1 if not walked
};

// wide[] = {box, ref, root}
inline WideTables make_wide(void* const* t) {
  WideTables w;
  w.box = static_cast<const float*>(t[0]);
  w.ref = static_cast<const int*>(t[1]);
  w.root = static_cast<const int*>(t[2]);
  return w;
}

// Lane i's mesh winner, as #8 writes it.
__device__ __forceinline__ void store_mesh_hit(const HitLanes& out, int i, float t, V3 n, int mat,
                                               bool outside, bool has_uv, float u, float v) {
  out.t[i] = t;
  out.n[0][i] = n.x;
  out.n[1][i] = n.y;
  out.n[2][i] = n.z;
  out.mat[i] = mat;
  out.outside[i] = outside ? 1 : 0;
  out.flag[i] = has_uv ? 1 : 0;
  out.u[i] = u;
  out.v[i] = v;
}

// An entry of a walk's stack: a wide node (count 0) or a leaf's first
// triangle and count, and the tmin its box was entered at.
struct StackEntry {
  int ref;
  int count;
  float tmin;
};

// One mesh instance's winner in object space, walked by the kWide lanes
// of `gmask` (lane k of the group, the group's first lane `g0` of the
// warp) over its wide BVH from `root`, with `stack` in shared memory.
// Every value that steers the loop (sp, best, the popped entry) is the
// same in all the group's lanes.
__device__ __forceinline__ TriHit wide_walk(const MeshTables& m, const WideTables& w, int root,
                                            const ObjRay& r, StackEntry* stack, unsigned gmask,
                                            int k, int g0) {
  TriHit best = {kFltMax, 0x7fffffff, 0.0f, 0.0f};
  if (k == 0) stack[0] = StackEntry{root, 0, -kFltMax};
  int sp = 1;
  __syncwarp(gmask);
  while (sp > 0) {
    --sp;
    const StackEntry e = stack[sp];
    __syncwarp(gmask);  // every lane has read it before any push over it
    if (!(e.tmin <= best.t)) continue;
    if (e.count == 0) {
      const float* b = w.box + static_cast<size_t>(e.ref) * 6 * kWide + k;
      const int* rf = w.ref + static_cast<size_t>(e.ref) * 2 * kWide + k;
      const int cref = __ldg(rf);
      const int ccount = __ldg(rf + kWide);
      const float4 lo = {__ldg(b), __ldg(b + kWide), __ldg(b + 2 * kWide), 0.0f};
      const float4 hi = {__ldg(b + 3 * kWide), __ldg(b + 4 * kWide), __ldg(b + 5 * kWide), 0.0f};
      float tmin, tmax;
      slab_span(lo, hi, r, &tmin, &tmax);
      const bool enter = ccount >= 0 && tmax >= tmin && tmax > 0.0f && tmin <= best.t;
      const unsigned entered = __ballot_sync(gmask, enter);
      int rank = 0;  // entered children before this one: nearer, or as near and lower
#pragma unroll
      for (int j = 0; j < kWide; ++j) {
        const float tj = __shfl_sync(gmask, tmin, g0 + j);
        rank += ((entered >> (g0 + j)) & 1u) && (tj < tmin || (tj == tmin && j < k));
      }
      const int n_entered = __popc(entered);
      if (enter) stack[sp + n_entered - 1 - rank] = StackEntry{cref, ccount, tmin};
      sp += n_entered;
      __syncwarp(gmask);
    } else {
      float t = 0.0f, u = 0.0f, v = 0.0f;
      const bool hit = k < e.count && tri_test(m, e.ref + k, r, &t, &u, &v);
      // t > RAY_EPS > 0, so the order of its bits is the order of t
      const unsigned bits = hit ? __float_as_uint(t) : 0xffffffffu;
      const unsigned least = __reduce_min_sync(gmask, bits);
      if (least != 0xffffffffu) {
        const int at = __ffs(__ballot_sync(gmask, bits == least)) - 1;
        const float wu = __shfl_sync(gmask, u, at);
        const float wv = __shfl_sync(gmask, v, at);
        const float wt = __uint_as_float(least);
        const int wtri = e.ref + (at - g0);
        if (wt < best.t || (wt == best.t && wtri < best.tri)) best = TriHit{wt, wtri, wu, wv};
      }
    }
  }
  return best;
}

__global__ void __launch_bounds__(kCandThreads)
    mesh_candidates_kernel(const Tables s, const MeshTables m, const RayLanes rays,
                           const int* __restrict__ num_alive, int n, int all_lanes,
                           const HitLanes out, int* __restrict__ list, int* __restrict__ count) {
  __shared__ int s_lanes[kCandLanes];  // the block's lanes to sweep, packed
  __shared__ int s_warp[kCandWarps];
  __shared__ int s_base;
  const int first = blockIdx.x * kCandLanes;
  const int end = min(n, num_alive == nullptr ? n : __ldg(num_alive));
  if (first >= end) return;  // the whole block
  // pack the lanes to sweep, in lane order, each with its live flag
  int n_lanes = 0;
#pragma unroll
  for (int k = 0; k < kCandPer; ++k) {
    const int i = first + k * kCandThreads + threadIdx.x;
    const bool live = i < end && (rays.alive == nullptr || rays.alive[i] != 0);
    const bool sweep = i < end && (live || all_lanes);
    int kept;
    const int at = n_lanes + block_prefix<kCandWarps>(sweep, s_warp, &kept);
    if (sweep) s_lanes[at] = i | (live ? kLiveBit : 0);
    n_lanes += kept;
  }
  __syncthreads();
  // sweep them, no barrier between rounds; a candidate's flag joins its
  // packed entry
  for (int q = threadIdx.x; q < n_lanes; q += kCandThreads) {
    const int packed = s_lanes[q];
    const bool live = (packed & kLiveBit) != 0;
    const int i = packed & kLaneMask;
    const V3 o = ray_o(rays, i);
    const V3 d = ray_d(rays, i);
    const Hit h = intersect_analytic(s, o, d);
    out.t[i] = h.t;
    out.n[0][i] = h.n.x;
    out.n[1][i] = h.n.y;
    out.n[2][i] = h.n.z;
    out.mat[i] = h.mat;
    out.outside[i] = h.outside ? 1 : 0;
    bool cand = false;
    for (int k = 0; live && !cand && k < m.n_mesh; ++k) {
      ObjRay r;
      cand = mesh_candidate(s, m, k, o, d, h.t, &r);
    }
    out.flag[i] = cand ? 1 : 0;
    if (cand) s_lanes[q] = packed | kCandBit;
  }
  __syncthreads();
  // the block's candidates in lane order: one atomicAdd reserves their run
  int n_cands = 0, at[kCandPer];
#pragma unroll
  for (int k = 0; k < kCandPer; ++k) {
    const int q = k * kCandThreads + threadIdx.x;
    int kept;
    at[k] = n_cands + block_prefix<kCandWarps>(q < n_lanes && (s_lanes[q] & kCandBit) != 0,
                                               s_warp, &kept);
    n_cands += kept;
  }
  if (n_cands == 0) return;  // the whole block
  if (threadIdx.x == 0) s_base = atomicAdd(count, n_cands);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCandPer; ++k) {
    const int q = k * kCandThreads + threadIdx.x;
    if (q < n_lanes && (s_lanes[q] & kCandBit) != 0) {
      list[s_base + at[k]] = s_lanes[q] & kLaneMask;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    mesh_sweep_kernel(const Tables s, const MeshTables m, const WideTables w, int stack_len,
                      const RayLanes rays, const float* __restrict__ t_a,
                      const int* __restrict__ list, const int* __restrict__ count, int n,
                      const HitLanes out, int* __restrict__ next) {
  extern __shared__ StackEntry stacks[];
  const int group = threadIdx.x / kWide;
  const int k = threadIdx.x % kWide;
  const int g0 = (threadIdx.x & 31) & ~(kWide - 1);
  const unsigned gmask = ((1u << kWide) - 1u) << g0;
  StackEntry* stack = stacks + group * stack_len;
  const int total = min(n, __ldg(count));
  for (;;) {
    // the next list entry, for the group: walks differ in length, so a
    // group that ends early takes more
    int j = 0;
    if (k == 0) j = atomicAdd(next, 1);
    j = __shfl_sync(gmask, j, g0);
    if (j >= total) break;
    const int i = __ldg(list + j);
    const V3 o = ray_o(rays, i);
    const V3 d = ray_d(rays, i);
    const float ta = t_a[i];
    // the winner over the mesh geoms, in geom order with the min-t rule
    float best_t = -1.0f;
    V3 best_n = {0.0f, 0.0f, 0.0f};
    int best_mat = -1;
    bool best_out = true, best_huv = false;
    float best_u = 0.0f, best_v = 0.0f;
    for (int g = 0; g < m.n_mesh; ++g) {
      const int root = __ldg(w.root + g);
      ObjRay r;
      if (root < 0 || !mesh_candidate(s, m, g, o, d, ta, &r)) continue;
      const TriHit th = wide_walk(m, w, root, r, stack, gmask, k, g0);
      if (!(th.t < kFltMax)) continue;
      const int4 mg = __ldg(m.geoms + g);
      const MeshHit h = epilogue(s, m, mg.x, mg.w != 0, r, th, o, d);
      const float prev = best_t > 0.0f ? best_t : kFltMax;
      if (h.t > 0.0f && prev > h.t) {
        best_t = h.t;
        best_n = h.n;
        best_mat = __ldg(s.gmat + mg.x);
        best_out = h.outside;
        best_huv = mg.w != 0;
        if (best_huv) {
          best_u = h.u;
          best_v = h.v;
        }
      }
    }
    if (k == 0) {
      store_mesh_hit(out, i, best_t, best_n, best_mat, best_out, best_huv, best_u, best_v);
    }
  }
}

// #8 when no mesh geom has a wide BVH to walk (every mesh of the scene
// takes the big-mesh route): each listed lane's mesh winner is no hit, the
// values the walk starts from, one thread per entry over the same grid.
__global__ void __launch_bounds__(kThreads)
    mesh_sweep_kernel_no_walk(const int* __restrict__ list, const int* __restrict__ count, int n,
                              const HitLanes out) {
  const int total = min(n, __ldg(count));
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < total; j += gridDim.x * blockDim.x) {
    store_mesh_hit(out, __ldg(list + j), -1.0f, V3{0.0f, 0.0f, 0.0f}, -1, true, false, 0.0f,
                   0.0f);
  }
}

// The blocks of #8 that stay resident on `device` with `smem` bytes of
// stack per block; the last query is kept.
cudaError_t sweep_blocks(int device, int smem, int* out) {
  static int last_device = -1, last_smem = -1, last_blocks = 0;
  if (device != last_device || smem != last_smem) {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(mesh_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mesh_sweep_kernel, kThreads,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
    last_device = device;
    last_smem = smem;
    last_blocks = sms * per_sm;
  }
  *out = last_blocks;
  return cudaSuccess;
}

// The merged hit of lane i: the mesh winner iff the lane is a candidate,
// t_mesh > 0 and the analytic t (FLT_MAX on a miss) is greater.
__device__ __forceinline__ bool mesh_wins(const HitLanes& a, const HitLanes& mh, int i) {
  if (!a.flag[i]) return false;
  const float tm = mh.t[i];
  const float ta = a.t[i];
  return tm > 0.0f && (ta > 0.0f ? ta : kFltMax) > tm;
}

__device__ __forceinline__ Hit load_hit(const HitLanes& l, int i) {
  Hit h;
  h.t = l.t[i];
  h.n = {l.n[0][i], l.n[1][i], l.n[2][i]};
  h.mat = l.mat[i];
  h.outside = l.outside[i] != 0;
  return h;
}

// Lane i's merged hit for #9, field by field: the winner decided from the
// candidacy flag and the two t alone (mesh_wins's rule), then the normal,
// material and side each read once, from the winner's lanes, so a lane
// that the mesh wins reads none of the analytic ones. The lane arrays'
// pointers are selected, never a struct: a pointer to either kernel
// parameter would put both in local memory. #10 keeps mesh_wins and
// load_hit. On TexTables also the mesh winner's UVs and has_uv (none for
// an analytic winner), which the surface stage reads.
template <class T>
__device__ __forceinline__ HitOf<T> merged_hit(const HitLanes& a, const HitLanes& mh, int i) {
  const float ta = a.t[i];
  const float tm = a.flag[i] ? mh.t[i] : 0.0f;
  const bool mesh = tm > 0.0f && (ta > 0.0f ? ta : kFltMax) > tm;
  const float* nx = mesh ? mh.n[0] : a.n[0];
  const float* ny = mesh ? mh.n[1] : a.n[1];
  const float* nz = mesh ? mh.n[2] : a.n[2];
  HitOf<T> h;
  h.t = mesh ? tm : ta;
  h.n = {nx[i], ny[i], nz[i]};
  h.mat = (mesh ? mh.mat : a.mat)[i];
  h.outside = (mesh ? mh.outside : a.outside)[i] != 0;
  if constexpr (T::kTex) {
    h.has_uv = mesh && mh.flag[i];
    h.u = h.has_uv ? mh.u[i] : 0.0f;
    h.v = h.has_uv ? mh.v[i] : 0.0f;
  }
  return h;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    bounce_step_mesh_kernel(const T s, const Lanes pool, const int* __restrict__ num_alive,
                            int n, const HitLanes a, const HitLanes mh, int iteration, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (num_alive != nullptr && i >= __ldg(num_alive)) return;
  if (pool.alive[i] == 0) return;
  Path p = load_path(pool, i);
  const HitOf<T> h = merged_hit<T>(a, mh, i);
  const bool alive = shade(s, p, h, static_cast<uint32_t>(iteration), depth,
                           static_cast<uint32_t>(pool.pix[i]));
  store_path(pool, i, p);
  pool.alive[i] = alive ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    intersect_mesh_kernel(const HitLanes a, const HitLanes mh, int n, const HitLanes out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool mesh = mesh_wins(a, mh, i);
  Hit h = load_hit(a, i);
  if (mesh) h = load_hit(mh, i);
  out.t[i] = h.t;
  out.n[0][i] = h.n.x;
  out.n[1][i] = h.n.y;
  out.n[2][i] = h.n.z;
  out.mat[i] = h.mat;
  out.outside[i] = h.outside ? 1 : 0;
  out.flag[i] = mesh ? mh.flag[i] : 0;
  out.u[i] = mesh ? mh.u[i] : 0.0f;
  out.v[i] = mesh ? mh.v[i] : 0.0f;
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t,
// PyTorch's current stream) of CUDA device `device` and returns
// cudaGetLastError() of the launch. tables = {xf, inv, invt, gtype, gmat,
// mat, env}; mesh = {tri, attr, box, geoms, chunk, super}; rays = {ox, oy, oz,
// dx, dy, dz, alive (int32, or null: all alive)}; hit lanes = {t, nx, ny,
// nz, mat (int32), outside (uint8), flag (uint8)[, u, v]}.

// all_lanes: also give dead lanes their analytic hit (the intersect
// route); num_alive: a device int32 (live lanes first), or null. count is
// zeroed on the stream before the launch. n below 2^29.
extern "C" int pt_mesh_candidates(void* const* tables, int n_geoms, void* const* mesh, int n_mesh,
                                  void* const* rays, const int* num_alive, int n, int all_lanes,
                                  void* const* analytic, int* list, int* count, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > kLaneMask) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    mesh_candidates_kernel<<<(n + kCandLanes - 1) / kCandLanes, kCandThreads, 0, st>>>(
        make_tables(tables, n_geoms, 0, 0), make_mesh_tables(mesh, n_mesh), make_rays(rays),
        num_alive, n, all_lanes, make_hits(analytic, false), list, count);
  }
  return static_cast<int>(cudaGetLastError());
}

// wide: {box, ref, root} of pack_wide_tables; stack: the entries a walk's
// stack may need; walked: how many mesh geoms have a root (0: the
// no-walk kernel); t_a: #7's analytic t; list/count: #7's candidate list;
// hits: 9 lanes; next: one int32 of scratch, zeroed on the stream here
// (the groups take list entries from it).
extern "C" int pt_mesh_sweep(void* const* tables, int n_geoms, void* const* mesh, int n_mesh,
                             void* const* wide, int stack, int walked, void* const* rays,
                             const float* t_a, const int* list, const int* count, int n,
                             void* const* hits, int* next, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int smem = kGroups * stack * static_cast<int>(sizeof(StackEntry));
    int blocks = 0;
    err = sweep_blocks(device, smem, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (walked == 0) {
      mesh_sweep_kernel_no_walk<<<std::min(blocks, n_blocks(n)), kThreads, 0, st>>>(
          list, count, n, make_hits(hits, true));
    } else {
      err = cudaMemsetAsync(next, 0, sizeof(int), st);
      if (err != cudaSuccess) return static_cast<int>(err);
      mesh_sweep_kernel<<<std::min(blocks, (n + kGroups - 1) / kGroups), kThreads, smem, st>>>(
          make_tables(tables, n_geoms, 0, 0), make_mesh_tables(mesh, n_mesh), make_wide(wide),
          stack, make_rays(rays), t_a, list, count, n, make_hits(hits, true), next);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// pool: 14 pointers (12 float lanes, alive, pix), updated in place; the
// instantiation on TexTables when flags has a kSurfaceStage bit (tables
// then {xf, inv, invt, gtype, gmat, mat, env, lights, surf, tex, bump,
// envmap}).
extern "C" int pt_bounce_step_mesh(void* const* tables, int n_geoms, void* const* pool,
                                   const int* num_alive, int n, void* const* analytic,
                                   void* const* hits, int iteration, int depth, int rr_start,
                                   int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (flags & kSurfaceStage) {
      bounce_step_mesh_kernel<<<n_blocks(n), kThreads, 0, st>>>(
          make_tex_tables(tables, n_geoms, flags, rr_start), make_lanes(pool), num_alive, n,
          make_hits(analytic, false), make_hits(hits, true), iteration, depth);
    } else {
      bounce_step_mesh_kernel<<<n_blocks(n), kThreads, 0, st>>>(
          make_tables(tables, n_geoms, flags, rr_start), make_lanes(pool), num_alive, n,
          make_hits(analytic, false), make_hits(hits, true), iteration, depth);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out: 9 Intersections lanes (flag = has_uv).
extern "C" int pt_intersect_mesh(void* const* analytic, void* const* hits, int n,
                                 void* const* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    intersect_mesh_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_hits(analytic, false), make_hits(hits, true), n, make_hits(out, true));
  }
  return static_cast<int>(cudaGetLastError());
}
