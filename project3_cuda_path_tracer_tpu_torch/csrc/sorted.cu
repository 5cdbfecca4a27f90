// The big-mesh route for Hopper (sm_90a): four kernels that replace the
// sorted-stream route of the JAX package's ops/pipeline.py
// (_sorted_mesh_merge), which every mesh geom above SORT_SUPER_MIN_TRIS
// triangles takes. Per such geom and bounce they run A -> (exclusive
// scan, torch.cumsum) -> B -> C -> D over #7's candidate list, after #8
// has swept the small geoms:
//
//   A  super_keys_kernel replaces _super_rank_xla (XLA) and the counting
//      half of #12 _kc_compact. One thread per listed lane: the ray in the
//      geom's object space, its pruning bound bt0 (the smaller of the
//      analytic and the mesh hit so far, times the Frobenius norm of inv's
//      3x3), and the slab test of the geom's supernodes in ascending index
//      (the expression of _super_rank_xla). The first E-1 entered supers
//      are the lane's window keys; the last slot is the E-th entered super,
//      or, for a lane that enters more, the overflow tail: key
//      n_supers + (slot E-2) + 1 (n_supers + slot 0 at E == 1), which
//      sweeps every super from that start on. Keys are written slot-major
//      at [slot, j], 2 * n_supers where no super is left; each real key
//      adds one to a shared-memory histogram, flushed with one global
//      atomic per bin.
//      Bound: operations (per lane the transform and ~25 per super box).
//   B  place_entries_kernel replaces #12's packing, #13 _ks_stitch and the
//      global lax.sort by key. The histogram's exclusive scan gives each
//      key its window; each real (slot, j) entry goes to offset[key] +
//      atomicAdd(cursor[key], 1), one atomic per run of equal keys in a
//      warp (__match_any_sync). A counting sort: dead entries are never
//      written, so compaction and sort are one pass. The order within a
//      key is what the atomics give; no result depends on it (see C).
//      Bound: bytes (each key read once, each real entry's key and id
//      written once).
//   C  window_sweep_kernel replaces #11 _window_sweep. One block per 256
//      consecutive sorted entries. The block walks the supers its entries
//      need, in ascending order; for each, it stages the super's <= 1024
//      triangles (v0, e1 = v1-v0, e2 = v2-v0: 36 KB) and its 32 chunk boxes
//      in shared memory, and each thread that needs the super sweeps it:
//      a window entry its own super, a tail entry every super from its
//      start on. The carry starts at FLT_MAX; per chunk the thread
//      slab-tests the chunk box against its running best t and skips a
//      chunk it cannot win (exact: a triangle in the box hits at t >= the
//      slab's entry, and updates are strict-<; SWEEP_CULL's argument, made
//      per lane); Moller-Trumbore is _mt_chunk's expression in ascending
//      triangle order with strict t < bt. Each entry's (t, triangle, u, v)
//      goes to [slot, j]: no entry's result depends on the stream's order
//      or length. The stream-order instantiation (kStream, the radix
//      route's C: ops/pipeline.py's SORT_RADIX) reads each entry's ray from
//      the sorted stream's payload at its place e and writes its result at
//      e, which is what the JAX package's windows_sweep does on its radix
//      branch; the per-entry arithmetic is the same code.
//      Bound: operations (entries x triangles tested x ~64).
//   D  merge_entries_kernel replaces #14 _kx_expand, the E-slot strict-<
//      merge and _mesh_epilogue. One thread per listed lane: the min over
//      its real slots in slot order (ascending super order, the dense
//      sweep's tie order), the hit rule bt < FLT_MAX and bt < bt0, the
//      winner's normal (and UVs) interpolated w*n0 + u*n1 + v*n2, the
//      world-space tail (mesh_common.cuh's epilogue, #8's), and the strict
//      merge into #8's hit lanes at the lane's own index.
//      Bound: bytes (E slots of 16 B and the lane's 9 hit lanes).
//
// Every grid is sized by its upper bound (the pool, or E x the pool);
// threads at or past the count that stays on the device return, so no
// host sync sits between the kernels. What the design does about the
// bounds: C's sorted stream gives a block entries of one super, so its
// triangles come from shared memory and a warp's rays are a coherent beam;
// the per-lane chunk cull skips most of a super a ray only grazes. A, B
// and D are one pass over their lanes.

#include <climits>

#include "mesh_common.cuh"

namespace {

constexpr int kChunk = 32;  // models/device.py::MESH_CHUNK
constexpr int kSuper = 32;  // models/device.py::MESH_SUPER
constexpr int kSuperTris = kChunk * kSuper;
constexpr int kSweepThreads = 256;

inline int blocks_of(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

__global__ void __launch_bounds__(kThreads)
    super_keys_kernel(const float* __restrict__ inv, const float* __restrict__ boxes,
                      int n_supers, int E, const RayLanes rays, const float* __restrict__ t_a,
                      const float* __restrict__ t_m, const int* __restrict__ list,
                      const int* __restrict__ count, int n, int* __restrict__ keys,
                      float* __restrict__ q, float* __restrict__ bt0,
                      int* __restrict__ hist) {
  extern __shared__ int s_hist[];  // 2 * n_supers bins
  const int n_listed = __ldg(count);
  if (static_cast<int>(blockIdx.x * blockDim.x) >= n_listed) return;  // the whole block
  const int dead = 2 * n_supers;
  for (int b = threadIdx.x; b < dead; b += blockDim.x) s_hist[b] = 0;
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n && j < n_listed) {
    const int i = __ldg(list + j);
    const ObjRay r = object_ray(inv, ray_o(rays, i), ray_d(rays, i));
    const float ta = t_a[i];
    const float tm = t_m[i];
    const float eff = tm > 0.0f ? (ta > 0.0f ? fminf(tm, ta) : tm) : ta;
    const float bt = eff > 0.0f ? eff * frobenius3(inv) : kFltMax;
    int cnt = 0;
    int s_first = dead, s_em2 = dead, s_last = dead;
    for (int s = 0; s < n_supers; ++s) {
      const float* b = boxes + 8 * s;  // min xyz, max xyz, 0, 0
      const float3 lo = make_float3(__ldg(b), __ldg(b + 1), __ldg(b + 2));
      const float3 hi = make_float3(__ldg(b + 3), __ldg(b + 4), __ldg(b + 5));
      const float t1x = (lo.x - r.o.x) * r.inv_d.x;
      const float t2x = (hi.x - r.o.x) * r.inv_d.x;
      const float t1y = (lo.y - r.o.y) * r.inv_d.y;
      const float t2y = (hi.y - r.o.y) * r.inv_d.y;
      const float t1z = (lo.z - r.o.z) * r.inv_d.z;
      const float t2z = (hi.z - r.o.z) * r.inv_d.z;
      const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
      const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
      const float te = fmaxf(tmin, 0.0f);
      if (!(tmax >= tmin && tmax > 0.0f && te < bt)) continue;
      if (cnt < E - 1) {  // a window slot, final as soon as it is found
        keys[cnt * n + j] = s;
        atomicAdd(s_hist + s, 1);
      } else if (cnt == E - 1) {
        s_last = s;
      }
      if (cnt == 0) s_first = s;
      if (cnt == E - 2) s_em2 = s;
      ++cnt;
    }
    for (int k = cnt; k < E - 1; ++k) keys[k * n + j] = dead;
    // the last slot: the E-th entered super, or the overflow tail
    int last = s_last;
    if (cnt > E) last = E == 1 ? n_supers + s_first : n_supers + s_em2 + 1;
    keys[(E - 1) * n + j] = last;
    if (last != dead) atomicAdd(s_hist + last, 1);
    q[j] = r.o.x;
    q[n + j] = r.o.y;
    q[2 * n + j] = r.o.z;
    q[3 * n + j] = r.d.x;
    q[4 * n + j] = r.d.y;
    q[5 * n + j] = r.d.z;
    bt0[j] = bt;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < dead; b += blockDim.x) {
    if (s_hist[b] != 0) atomicAdd(hist + b, s_hist[b]);
  }
}

__global__ void __launch_bounds__(kThreads)
    place_entries_kernel(const int* __restrict__ keys, const int* __restrict__ count, int n,
                         int E, int dead, const int* __restrict__ offsets,
                         int* __restrict__ cursor, int* __restrict__ out_key,
                         int* __restrict__ out_entry) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int j = static_cast<int>(e % n);
  int key = dead;
  if (e < static_cast<long long>(E) * n && j < __ldg(count)) key = keys[e];
  const bool real = key < dead;
  // every thread of the warp takes part in the ballot
  const unsigned active = __ballot_sync(0xffffffffu, real);
  if (!real) return;
  const unsigned peers = __match_any_sync(active, key);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cursor + key, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  const int pos = __ldg(offsets + key) + base + __popc(peers & ((1u << lane) - 1u));
  out_key[pos] = key;
  out_entry[pos] = static_cast<int>(e);
}

template <bool kStream>
__global__ void __launch_bounds__(kSweepThreads)
    window_sweep_kernel(const float4* __restrict__ tri, const float* __restrict__ chunks,
                        const int* __restrict__ key, const int* __restrict__ entry,
                        const int* __restrict__ total, const float* __restrict__ q, int n,
                        int n_supers, int n_chunks, int tri_start, int tri_count,
                        float* __restrict__ out_t, int* __restrict__ out_tri,
                        float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ float s_tri[9][kSuperTris];  // v0, e1, e2 of the staged super
  __shared__ float4 s_box[kSuper][2];     // its chunk boxes: min, max
  __shared__ int s_range[2];
  const int m = __ldg(total);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (static_cast<int>(blockIdx.x * blockDim.x) >= m) return;  // the whole block
  const bool valid = e < m;
  const int k = valid ? __ldg(key + e) : 0;
  const bool tail = k >= n_supers;
  const int first = tail ? k - n_supers : k;  // the first super the entry sweeps
  if (threadIdx.x == 0) {
    s_range[0] = INT_MAX;
    s_range[1] = -1;
  }
  __syncthreads();
  if (valid) {
    atomicMin(s_range, first);
    atomicMax(s_range + 1, tail ? n_supers - 1 : k);
  }
  __syncthreads();
  const int s_lo = s_range[0];
  const int s_hi = s_range[1];
  int slot_j = 0;
  ObjRay r;
  if (valid) {
    int j;
    if constexpr (kStream) {  // the entry's ray and result at its stream place
      slot_j = e;
      j = e;
    } else {
      slot_j = __ldg(entry + e);
      j = slot_j % n;
    }
    r.o = {__ldg(q + j), __ldg(q + n + j), __ldg(q + 2 * n + j)};
    r.d = {__ldg(q + 3 * n + j), __ldg(q + 4 * n + j), __ldg(q + 5 * n + j)};
    r.inv_d = {1.0f / r.d.x, 1.0f / r.d.y, 1.0f / r.d.z};
  }
  float bt = kFltMax;
  int best = -1;
  float bu = 0.0f, bv = 0.0f;
  for (int s2 = s_lo; s2 <= s_hi; ++s2) {
    const bool need = valid && (tail ? s2 >= first : s2 == k);
    if (!__syncthreads_or(need)) continue;
    const int t0 = s2 * kSuperTris;
    const int nt = min(kSuperTris, tri_count - t0);
    for (int x = threadIdx.x; x < nt; x += blockDim.x) {
      const float4 a = __ldg(tri + 3 * (tri_start + t0 + x));
      const float4 b = __ldg(tri + 3 * (tri_start + t0 + x) + 1);
      const float4 c = __ldg(tri + 3 * (tri_start + t0 + x) + 2);
      s_tri[0][x] = a.x;
      s_tri[1][x] = a.y;
      s_tri[2][x] = a.z;
      s_tri[3][x] = a.w - a.x;
      s_tri[4][x] = b.x - a.y;
      s_tri[5][x] = b.y - a.z;
      s_tri[6][x] = b.z - a.x;
      s_tri[7][x] = b.w - a.y;
      s_tri[8][x] = c.x - a.z;
    }
    const int nc = min(kSuper, n_chunks - s2 * kSuper);
    for (int x = threadIdx.x; x < nc; x += blockDim.x) {
      const float* row = chunks + 8 * (s2 * kSuper + x);
      s_box[x][0] = make_float4(__ldg(row), __ldg(row + 1), __ldg(row + 2), 0.0f);
      s_box[x][1] = make_float4(__ldg(row + 3), __ldg(row + 4), __ldg(row + 5), 0.0f);
    }
    __syncthreads();
    if (need) {
      for (int c = 0; c < nc; ++c) {
        if (!slab_enter(s_box[c][0], s_box[c][1], r, bt)) continue;
        const int hi = min(c * kChunk + kChunk, nt);
        for (int x = c * kChunk; x < hi; ++x) {
          float t, u, v;
          if (mt_test(V3{s_tri[0][x], s_tri[1][x], s_tri[2][x]},
                      V3{s_tri[3][x], s_tri[4][x], s_tri[5][x]},
                      V3{s_tri[6][x], s_tri[7][x], s_tri[8][x]}, r, &t, &u, &v) &&
              t < bt) {
            bt = t;
            best = tri_start + t0 + x;
            bu = u;
            bv = v;
          }
        }
      }
    }
    __syncthreads();  // before the next super overwrites the stage
  }
  if (valid) {
    out_t[slot_j] = bt;
    out_tri[slot_j] = best;
    out_u[slot_j] = bu;
    out_v[slot_j] = bv;
  }
}

__global__ void __launch_bounds__(kThreads)
    merge_entries_kernel(const Tables s, const MeshTables m, const RayLanes rays,
                         const int* __restrict__ list, const int* __restrict__ count, int n,
                         int E, int dead, int g, int has_uv, const int* __restrict__ keys,
                         const float* __restrict__ sw_t, const int* __restrict__ sw_tri,
                         const float* __restrict__ sw_u, const float* __restrict__ sw_v,
                         const float* __restrict__ q, const float* __restrict__ bt0,
                         const HitLanes out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || j >= __ldg(count)) return;
  TriHit th = {kFltMax, 0, 0.0f, 0.0f};
  for (int e = 0; e < E; ++e) {
    const int idx = e * n + j;
    if (keys[idx] >= dead) continue;
    const float t = sw_t[idx];
    if (t < th.t) th = TriHit{t, sw_tri[idx], sw_u[idx], sw_v[idx]};
  }
  if (!(th.t < kFltMax && th.t < bt0[j])) return;
  const int i = __ldg(list + j);
  ObjRay r;
  r.o = {q[j], q[n + j], q[2 * n + j]};
  r.d = {q[3 * n + j], q[4 * n + j], q[5 * n + j]};
  const MeshHit h = epilogue(s, m, g, has_uv != 0, r, th, ray_o(rays, i), ray_d(rays, i));
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

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t,
// PyTorch's current stream) of CUDA device `device` and returns
// cudaGetLastError() of the launch. tables = {xf, inv, invt, gtype, gmat,
// mat, env}; mesh = {tri, attr, box, node, geoms, chunk, super}; rays =
// {ox, oy, oz, dx, dy, dz, alive}; list/count: #7's candidate list; n: the
// pool size, the stride of every [slot, j] array; the big geom `geom` owns
// supers [super_start, +n_supers), chunks [chunk_start, +n_chunks) and soup
// triangles [tri_start, +tri_count).

// t_a: #7's analytic t; t_m: the mesh hit lanes' t so far. Out: keys
// (E, n) int32, q (6, n) f32 object-space rays, bt0 (n,) f32, hist
// (2 * n_supers,) int32 (zeroed on the stream here).
extern "C" int pt_super_keys(void* const* tables, int n_geoms, void* const* mesh,
                             void* const* rays, const float* t_a, const float* t_m,
                             const int* list, const int* count, int n, int geom, int super_start,
                             int n_supers, int E, int* keys, float* q, float* bt0, int* hist,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t hist_bytes = sizeof(int) * 2 * static_cast<size_t>(n_supers);
  err = cudaMemsetAsync(hist, 0, hist_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const Tables s = make_tables(tables, n_geoms, 0, 0);
    const float* boxes = static_cast<const float*>(mesh[6]) + 8 * super_start;
    super_keys_kernel<<<n_blocks(n), kThreads, hist_bytes, st>>>(
        s.inv + 16 * geom, boxes, n_supers, E, make_rays(rays), t_a, t_m, list, count, n, keys,
        q, bt0, hist);
  }
  return static_cast<int>(cudaGetLastError());
}

// offsets: the exclusive scan of A's histogram; cursor (2 * n_supers,)
// int32 scratch, zeroed on the stream here. Out: the real entries' keys
// in ascending order and their ids slot * n + j, at [0, total).
extern "C" int pt_place_entries(const int* keys, const int* count, int n, int E, int n_supers,
                                const int* offsets, int* cursor, int* out_key, int* out_entry,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(cursor, 0, sizeof(int) * 2 * static_cast<size_t>(n_supers), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    place_entries_kernel<<<blocks_of(static_cast<long long>(E) * n, kThreads), kThreads, 0,
                           st>>>(keys, count, n, E, 2 * n_supers, offsets, cursor, out_key,
                                 out_entry);
  }
  return static_cast<int>(cudaGetLastError());
}

// total: the count of real entries (device). Out: per entry id, the
// object-space t (FLT_MAX: no triangle), triangle, u and v.
extern "C" int pt_window_sweep(void* const* mesh, const int* key, const int* entry,
                               const int* total, const float* q, int n, int E, int n_supers,
                               int chunk_start, int n_chunks, int tri_start, int tri_count,
                               float* out_t, int* out_tri, float* out_u, float* out_v,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const float* chunks = static_cast<const float*>(mesh[5]) + 8 * chunk_start;
    window_sweep_kernel<false><<<blocks_of(static_cast<long long>(E) * n, kSweepThreads),
                                 kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(mesh[0]), chunks, key, entry, total, q, n, n_supers,
        n_chunks, tri_start, tri_count, out_t, out_tri, out_u, out_v);
  }
  return static_cast<int>(cudaGetLastError());
}

// C in stream order (the radix route): key, q (6, n) and total are the
// sorted stream of the radix passes (n its capacity); each entry's ray is
// q[:, e] and its (t, triangle, u, v) goes to [e].
extern "C" int pt_window_sweep_stream(void* const* mesh, const int* key, const int* total,
                                      const float* q, int n, int n_supers, int chunk_start,
                                      int n_chunks, int tri_start, int tri_count, float* out_t,
                                      int* out_tri, float* out_u, float* out_v, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const float* chunks = static_cast<const float*>(mesh[5]) + 8 * chunk_start;
    window_sweep_kernel<true><<<blocks_of(n, kSweepThreads), kSweepThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(mesh[0]), chunks, key, nullptr, total, q, n, n_supers,
        n_chunks, tri_start, tri_count, out_t, out_tri, out_u, out_v);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys, q, bt0: A's; t/tri/u/v: C's; hits: #8's 9 lanes, merged in place.
extern "C" int pt_merge_entries(void* const* tables, int n_geoms, void* const* mesh,
                                void* const* rays, const int* list, const int* count, int n,
                                int E, int n_supers, int geom, int has_uv, const int* keys,
                                const float* t, const int* tri, const float* u, const float* v,
                                const float* q, const float* bt0, void* const* hits, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    merge_entries_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_tables(tables, n_geoms, 0, 0), make_mesh_tables(mesh, 0), make_rays(rays), list,
        count, n, E, 2 * n_supers, geom, has_uv, keys, t, tri, u, v, q, bt0,
        make_hits(hits, true));
  }
  return static_cast<int>(cudaGetLastError());
}
