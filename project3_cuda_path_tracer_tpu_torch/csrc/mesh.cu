// The mesh pipeline for Hopper (sm_90a): four kernels that replace the
// dense route of the JAX package's ops/pipeline.py.
//
//   #7  mesh_candidates_kernel replaces _intersect_phase's K1: one thread
//       per lane sweeps the analytic geoms (the path_common.cuh box and
//       sphere tests, in geom order, min-t rule), writes the analytic
//       winner, and decides mesh candidacy: the ray enters a mesh geom's
//       object-space root box before the analytic t times the Frobenius
//       norm of inv's 3x3 (a bound on the object-space distance), or
//       before FLT_MAX on a miss. Candidate lane ids go to a list through
//       one atomic counter per warp (a ballot, then one atomicAdd); the
//       count stays on the device. This takes the place of the TPU's
//       in-tile compaction network, per-tile counts and cumsum glue.
//   #8  mesh_sweep_kernel replaces K2: one thread per list entry (the grid
//       is sized by the pool; a thread at or past the device-side count
//       returns). For each mesh geom the lane is a candidate of, it walks
//       the geom's BVH in object space, stackless over the preorder +
//       escape-pointer layout of models/bvh.py (the same nodes in the same
//       order as the plain ops/bvh_traverse.py::mesh_intersect_bvh), runs
//       Moller-Trumbore on each leaf's triangles with the strict-< rule,
//       then the world-space tail (distance, oriented normal, UVs). It
//       writes the mesh winner at the lane's own index, so the output does
//       not depend on the order the atomics gave the list. A geom of the
//       big-mesh route has no nodes to walk in the geoms table: sorted.cu
//       sweeps it after #8.
//   #9  bounce_step_mesh_kernel replaces bounce_step_pipeline's K3: one
//       thread per lane, in place on the pool. The mesh hit wins iff the
//       lane is a candidate, t_mesh > 0 and (t_a > 0 ? t_a : FLT_MAX) >
//       t_mesh; then the shared `shade` body exactly as kernel #3 runs it
//       (the same RNG slots keyed on pix, Russian roulette, the live-count
//       skip). The BVH walk stays in #8, so #9's body is #3's less the sweep.
//   #10 intersect_mesh_kernel replaces intersect_pipeline's K3: the same
//       merge without shading, written as Intersections lanes (t, normal,
//       material, outside, tex_u, tex_v, has_uv). Dead lanes keep their
//       analytic hit, as the JAX package returns them.
//
// What bounds them on the H100: #8 is per-thread control flow over the
// BVH (node boxes and triangles read through the read-only cache, warp
// divergence between rays that walk different subtrees), #7 and #9 the
// same arithmetic as kernel #3's sweep and shading, #10 its bytes. What
// the design does about it: nothing yet beyond compacting the candidates
// so that #8's warps hold only rays that enter a mesh, and 16-byte loads
// of nodes and triangles; shared-memory node caches, near-child-first
// order and ray reordering are later work.

#include "mesh_common.cuh"

namespace {

constexpr int kMesh = 2;  // models/scene.py::GeomType.MESH
constexpr int kLeafSize = 4;  // models/bvh.py::LEAF_SIZE

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

// The stackless walk of one mesh instance's BVH: its winner in object
// space.
__device__ __forceinline__ TriHit walk(const MeshTables& m, int node_start, int node_end,
                                       const ObjRay& r) {
  TriHit best = {kFltMax, 0, 0.0f, 0.0f};
  int cur = node_start;
  while (cur < node_end) {
    const int4 nd = __ldg(m.node + cur);  // first, count, skip, is_leaf
    const bool hit = slab_enter(__ldg(m.box + 2 * cur), __ldg(m.box + 2 * cur + 1), r, best.t);
    if (hit && nd.w) {
      for (int k = 0; k < kLeafSize && k < nd.y; ++k) {
        float t, u, v;
        if (tri_test(m, nd.x + k, r, &t, &u, &v) && t < best.t) {
          best = TriHit{t, nd.x + k, u, v};
        }
      }
    }
    cur = (hit && !nd.w) ? cur + 1 : nd.z;
  }
  return best;
}

// Append lane i to the candidate list when `cand`: one atomicAdd per warp.
// Every thread of the warp must call this (it holds a full-warp ballot).
__device__ __forceinline__ void append(bool cand, int i, int* list, int* count) {
  const unsigned ballot = __ballot_sync(0xffffffffu, cand);
  if (ballot == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (cand) list[base + __popc(ballot & ((1u << lane) - 1u))] = i;
}

__global__ void __launch_bounds__(kThreads)
    mesh_candidates_kernel(const Tables s, const MeshTables m, const RayLanes rays,
                           const int* __restrict__ num_alive, int n, int all_lanes,
                           const HitLanes out, int* __restrict__ list, int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool cand = false;
  if (i < n && (num_alive == nullptr || i < __ldg(num_alive))) {
    const bool live = rays.alive == nullptr || rays.alive[i] != 0;
    if (live || all_lanes) {
      const V3 o = ray_o(rays, i);
      const V3 d = ray_d(rays, i);
      const Hit h = intersect_analytic(s, o, d);
      out.t[i] = h.t;
      out.n[0][i] = h.n.x;
      out.n[1][i] = h.n.y;
      out.n[2][i] = h.n.z;
      out.mat[i] = h.mat;
      out.outside[i] = h.outside ? 1 : 0;
      for (int k = 0; live && !cand && k < m.n_mesh; ++k) {
        ObjRay r;
        cand = mesh_candidate(s, m, k, o, d, h.t, &r);
      }
      out.flag[i] = cand ? 1 : 0;
    }
  }
  append(cand, i, list, count);
}

__global__ void __launch_bounds__(kThreads)
    mesh_sweep_kernel(const Tables s, const MeshTables m, const RayLanes rays,
                      const float* __restrict__ t_a, const int* __restrict__ list,
                      const int* __restrict__ count, int n, const HitLanes out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || j >= __ldg(count)) return;
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
  for (int k = 0; k < m.n_mesh; ++k) {
    ObjRay r;
    if (!mesh_candidate(s, m, k, o, d, ta, &r)) continue;
    const int4 mg = __ldg(m.geoms + k);
    const TriHit th = walk(m, mg.y, mg.y + mg.z, r);
    if (!(th.t < kFltMax)) continue;
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
  out.t[i] = best_t;
  out.n[0][i] = best_n.x;
  out.n[1][i] = best_n.y;
  out.n[2][i] = best_n.z;
  out.mat[i] = best_mat;
  out.outside[i] = best_out ? 1 : 0;
  out.flag[i] = best_huv ? 1 : 0;
  out.u[i] = best_u;
  out.v[i] = best_v;
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

__global__ void __launch_bounds__(kThreads)
    bounce_step_mesh_kernel(const Tables s, const Lanes pool, const int* __restrict__ num_alive,
                            int n, const HitLanes a, const HitLanes mh, int iteration, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (num_alive != nullptr && i >= __ldg(num_alive)) return;
  if (pool.alive[i] == 0) return;
  Path p = load_path(pool, i);
  // two loads, not one through a selected struct: a pointer to either
  // kernel parameter would put both in local memory
  Hit h = load_hit(a, i);
  if (mesh_wins(a, mh, i)) h = load_hit(mh, i);
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
// mat, env}; mesh = {tri, attr, box, node, geoms, chunk, super}; rays = {ox, oy, oz,
// dx, dy, dz, alive (int32, or null: all alive)}; hit lanes = {t, nx, ny,
// nz, mat (int32), outside (uint8), flag (uint8)[, u, v]}.

// all_lanes: also give dead lanes their analytic hit (the intersect
// route); num_alive: a device int32 (live lanes first), or null. count is
// zeroed on the stream before the launch.
extern "C" int pt_mesh_candidates(void* const* tables, int n_geoms, void* const* mesh, int n_mesh,
                                  void* const* rays, const int* num_alive, int n, int all_lanes,
                                  void* const* analytic, int* list, int* count, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    mesh_candidates_kernel<<<n_blocks(n), kThreads, 0, st>>>(
        make_tables(tables, n_geoms, 0, 0), make_mesh_tables(mesh, n_mesh), make_rays(rays),
        num_alive, n, all_lanes, make_hits(analytic, false), list, count);
  }
  return static_cast<int>(cudaGetLastError());
}

// t_a: #7's analytic t; list/count: #7's candidate list; hits: 9 lanes.
extern "C" int pt_mesh_sweep(void* const* tables, int n_geoms, void* const* mesh, int n_mesh,
                             void* const* rays, const float* t_a, const int* list,
                             const int* count, int n, void* const* hits, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    mesh_sweep_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_tables(tables, n_geoms, 0, 0), make_mesh_tables(mesh, n_mesh), make_rays(rays), t_a,
        list, count, n, make_hits(hits, true));
  }
  return static_cast<int>(cudaGetLastError());
}

// pool: 14 pointers (12 float lanes, alive, pix), updated in place.
extern "C" int pt_bounce_step_mesh(void* const* tables, int n_geoms, void* const* pool,
                                   const int* num_alive, int n, void* const* analytic,
                                   void* const* hits, int iteration, int depth, int rr_start,
                                   int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    bounce_step_mesh_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_tables(tables, n_geoms, flags, rr_start), make_lanes(pool), num_alive, n,
        make_hits(analytic, false), make_hits(hits, true), iteration, depth);
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
