// The big-mesh route for Hopper (sm_90a): four kernels that replace the
// sorted-stream route of the JAX package's ops/pipeline.py
// (_sorted_mesh_merge), which every mesh geom above SORT_SUPER_MIN_TRIS
// triangles takes. Per such geom and bounce they run A -> B -> C -> D
// over #7's candidate list, after #8 has swept the small geoms, with one
// memset (A's histogram and B's cursors) and no other launch between:
//
//   A  super_keys_kernel replaces _super_rank_xla (XLA) and the counting
//      half of #12 _kc_compact. For each listed lane: the ray in the geom's
//      object space, its pruning bound bt0 (the smaller of the analytic
//      and the mesh hit so far, times the Frobenius norm of inv's 3x3),
//      and the slab test of the geom's supernodes in ascending index (the
//      expression of _super_rank_xla, (lo - o) * inv_d, strict te < bt).
//      The first E-1 entered supers are the lane's window keys; the last
//      slot is the E-th entered super, or, for a lane that enters more,
//      the overflow tail: key n_supers + (slot E-2) + 1 (n_supers + slot 0
//      at E == 1), which sweeps every super from that start on. Keys are
//      written slot-major at [slot, j], 2 * n_supers where no super is
//      left. The grid is the blocks that stay resident (no more than the
//      pool needs); each block takes kKeysThreads of the `count` listed
//      lanes a round, read on the device, a lane a thread. The supers'
//      rows are staged in shared memory, kKeysStage at a time (once a
//      block when they fit), and tested a word of 32 at a time with no
//      store or atomic in the loop (bit b: the ray enters super w0 + b);
//      the word's entered supers fill the free slots in ascending order
//      (__fns) in registers, and a ray stops once it has entered more than
//      E. Then each slot is one coalesced row, and each real key adds one
//      to a shared-memory histogram, flushed with one global atomic per
//      bin and block. E <= kPlacePer (B's limit).
//      Bound: bytes (per listed lane its ray and hits in, E keys, the
//      object ray and bt0 out); what holds A above it is each thread's
//      run of slab tests, one per super, about three quarters of its time
//      (PERF.md §6): boxes culled by a box over eight supers, or a group of
//      lanes per ray, measured slower.
//   B  place_entries_kernel replaces #12's packing, #13 _ks_stitch and the
//      global lax.sort by key: a counting sort of the real entries into
//      one stream, in one launch with no glue. A persistent grid (the
//      blocks that stay resident, no more than the pool's tiles) strides
//      over tiles of the `count` listed lanes, which it reads on the
//      device: a tile is kPlaceThreads x (kPlacePer / E) lanes, its E keys
//      read slot-major, one coalesced row per slot. Each block first scans
//      A's histogram in shared memory (each key's window start; block 0
//      writes the total), so no cumsum runs between A and B. Per tile:
//      each real entry's rank within its key from a shared-memory
//      histogram of the tile (one shared atomic per run of equal keys in a
//      warp, __match_any_sync); per key present, one global atomicAdd on
//      the key's cursor reserves the tile's run inside the key's window;
//      the entries are staged in shared memory in key order and each
//      key's run is written with contiguous stores. The cursor lives
//      right after A's histogram and is zeroed by A's memset; a launch
//      adds exactly hist[key] to cursor[key], so the place within the
//      window is the cursor's old value modulo hist[key], and B may run
//      any number of times on one A output without a memset. The order
//      within a key is the order in which tiles reserve; no result depends
//      on it (see C). Stable tile bases would need a look-back over the
//      tiles before each one, which the radix pass (radix.cu) pays for in waits.
//      Bound: bytes (the listed lanes' E keys read once, each real
//      entry's key and id written once).
//   C  window_sweep_kernel replaces #11 _window_sweep: for each real entry
//      of B's stream, the least (t, triangle, u, v) over the triangles of
//      its supers, a window entry its own super, a tail entry every super
//      from key - n_supers on; the carry starts at FLT_MAX and ties go to
//      the lowest soup index (an ascending strict-< scan). One warp per
//      entry, its ray uniform across the warp: lane c slab-tests chunk box
//      c of a super against the running best t, a ballot lists the chunks
//      entered, and each of them, in ascending order and culled again
//      whenever the best t falls, is one Moller-Trumbore step with lane x
//      on triangle x and a warp-wide min of the t bits, the lowest lane on
//      ties (exact: a triangle in a box hits at t >= the slab's entry,
//      SWEEP_CULL's argument). A tail entry first culls each super by its
//      supernode box, lanes over supers (exact: a super box is the min/max
//      of its chunk boxes). Triangles and chunk boxes come from C's
//      lane-major tables (ops/pipeline.py::pack_sweep_tables; v0, e1 and
//      e2 rounded as the kernel itself would round them), one
//      128-byte access per word of a warp's 32 triangles or boxes; a mesh
//      of 1e5 triangles is a few MB and stays in L2, so nothing is staged
//      in shared memory. The grid is the blocks that stay resident; each
//      warp strides over the stream from its end, so the tail entries (the
//      longest sweeps) start first and spread over every SM. Each entry's
//      result goes to [slot, j]; the stream-order instantiation (kStream,
//      the radix route's C: ops/pipeline.py's SORT_RADIX) reads the ray
//      from the sorted stream's payload at the entry's place e and writes
//      its result at e, as the JAX package's windows_sweep does on its
//      radix branch. No result depends on the stream's order. Tensor cores
//      do not apply: Moller-Trumbore is no matrix product.
//      Bound: operations (entries x triangles tested x 64 plus chunk and
//      super boxes tested x 27: chip_smoke.py's OPS_MT and OPS_CHUNK_TEST).
//   D  merge_entries_kernel replaces #14 _kx_expand, the E-slot strict-<
//      merge and _mesh_epilogue. One thread per listed lane: the min over
//      its real slots in slot order (ascending super order, the dense
//      sweep's tie order), the hit rule bt < FLT_MAX and bt < bt0, the
//      winner's normal (and UVs) interpolated w*n0 + u*n1 + v*n2, the
//      world-space tail (mesh_common.cuh's epilogue, #8's), and the strict
//      merge into #8's hit lanes at the lane's own index. E is a template
//      argument (one instantiation per E up to kPlacePer), so every
//      slot's key and t load is issued at once with no branch between
//      them, and only the winner's triangle, u and v are read.
//      Bound: bytes (per listed lane its E keys and bound, per real entry
//      its t; per lane under its bound its list entry, object ray,
//      winner's row, world ray and hit t; per merged hit the triangle's
//      attributes and the 9 hit lanes); what holds D above it is the hit
//      lanes' chain of dependent loads (slots -> list entry -> world ray
//      -> attributes -> merge).
//
// D's grid is sized by its upper bound (the pool), and threads at or past
// the count that stays on the device return; A's, B's and C's resident
// blocks read that count too, so no host sync sits between the kernels. What the design does about the bounds: C spends a
// warp's lanes on one ray's boxes and triangles, never on a chunk that ray
// does not enter (a thread per entry runs the union of its warp's 32
// culls), and no block walks every super from a tail's start (blocks that
// stage each super for their entries spend most of a launch on its few
// tail entries, PERF.md §5); what holds C above its bound is each warp's
// chain of dependent loads and reductions. A, B and D are one pass over
// their lanes; A launches no block past the resident ones and keeps the
// supers' loop free of stores and atomics, its boxes in shared memory; B
// reads no lane past the count and moves each key's run with contiguous
// stores; D issues its slots' loads together.

#include <algorithm>

#include "mesh_common.cuh"

namespace {

constexpr int kChunk = 32;  // models/device.py::MESH_CHUNK: one triangle per lane
constexpr int kSuper = 32;  // models/device.py::MESH_SUPER: one chunk box per lane
constexpr int kSweepWarps = 8;  // C: warps per block, one entry per warp at a time
constexpr int kSweepThreads = 32 * kSweepWarps;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf: above every hit's t bits
constexpr int kPlaceThreads = 256;  // B: threads per block
constexpr int kPlaceWarps = kPlaceThreads / 32;
constexpr int kPlacePer = 8;  // B: entries a thread holds per tile, E <= kPlacePer
constexpr int kPlaceStage = kPlaceThreads * kPlacePer;  // B: a tile's entries at most

inline int blocks_of(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

constexpr int kKeysThreads = 128;  // A: threads per block
constexpr int kKeysStage = 256;  // A: supers staged in shared memory at a time

// A's slab test of a box row (a: min xyz, max x; b: max y, max z, -), the
// expression of _super_rank_xla: entered, ahead of the origin, and its
// entry max(tmin, 0) strictly before the bound.
__device__ __forceinline__ bool keys_enter(float4 a, float4 b, const ObjRay& r, float bt) {
  float tmin, tmax;
  slab_span(a, make_float4(a.w, b.x, b.y, 0.0f), r, &tmin, &tmax);
  return tmax >= tmin && tmax > 0.0f && fmaxf(tmin, 0.0f) < bt;
}

// A. A block takes kKeysThreads listed lanes a round, a lane a thread, up
// to the count on the device. The supers are staged kKeysStage at a time
// in shared memory (once a block when they fit, as on every scene of the
// repo) and tested a word of 32 at a time with no store or atomic, bit b
// the ray enters super w0 + b; the word's entered supers fill the free
// slots in ascending order (__fns), in registers; a ray stops once it has
// entered more than E.
__global__ void __launch_bounds__(kKeysThreads)
    super_keys_kernel(const float* __restrict__ inv, const float4* __restrict__ boxes,
                      int n_supers, int E, const RayLanes rays, const float* __restrict__ t_a,
                      const float* __restrict__ t_m, const int* __restrict__ list,
                      const int* __restrict__ count, int n, int* __restrict__ keys,
                      float* __restrict__ q, float* __restrict__ bt0,
                      int* __restrict__ hist) {
  extern __shared__ int s_hist[];  // 2 * n_supers bins
  __shared__ float4 s_box[2 * kKeysStage];  // the staged supers' rows
  const int n_listed = min(__ldg(count), n);
  const int first = blockIdx.x * kKeysThreads;
  if (first >= n_listed) return;  // the whole block
  const int dead = 2 * n_supers;
  for (int b = threadIdx.x; b < dead; b += kKeysThreads) s_hist[b] = 0;
  const float fro = frobenius3(inv);
  for (int j0 = first; j0 < n_listed; j0 += gridDim.x * kKeysThreads) {  // the block's rounds
    const int j = j0 + threadIdx.x;
    const bool has = j < n_listed;
    ObjRay r = {};
    float bt = 0.0f;
    if (has) {
      const int i = __ldg(list + j);
      r = object_ray(inv, ray_o(rays, i), ray_d(rays, i));
      const float ta = t_a[i];
      const float tm = t_m[i];
      const float eff = tm > 0.0f ? (ta > 0.0f ? fminf(tm, ta) : tm) : ta;
      bt = eff > 0.0f ? eff * fro : kFltMax;
    }
    int key[kPlacePer];  // slot e: the e-th entered super
#pragma unroll
    for (int e = 0; e < kPlacePer; ++e) key[e] = dead;
    int cnt = 0;  // supers entered so far; past E only cnt > E matters
    for (int c0 = 0; c0 < n_supers; c0 += kKeysStage) {
      const int in_stage = min(kKeysStage, n_supers - c0);
      if (j0 == first || n_supers > kKeysStage) {
        __syncthreads();  // the last stage's readers are done
        for (int b = threadIdx.x; b < 2 * in_stage; b += kKeysThreads) {
          s_box[b] = __ldg(boxes + 2 * c0 + b);
        }
        __syncthreads();
      }
      for (int w0 = 0; has && w0 < in_stage && cnt <= E; w0 += 32) {
        const int in_word = min(32, in_stage - w0);
        unsigned m = 0;
        for (int g = 0; g < in_word; g += 8) {
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int s = w0 + g + x;
            if (g + x < in_word) {
              m |= static_cast<unsigned>(keys_enter(s_box[2 * s], s_box[2 * s + 1], r, bt))
                   << (g + x);
            }
          }
        }
        const int c = __popc(m);
        if (c != 0 && cnt < E) {
#pragma unroll
          for (int e = 0; e < kPlacePer; ++e) {
            const int rank = e - cnt;  // slot e takes the word's rank-th entered super
            if (e < E && rank >= 0 && rank < c) key[e] = c0 + w0 + __fns(m, 0, rank + 1);
          }
        }
        cnt += c;
      }
    }
    if (!has) continue;
    // the last slot: the E-th entered super, or the overflow tail
    int last = dead, em2 = dead;
#pragma unroll
    for (int e = 0; e < kPlacePer; ++e) {
      if (e == E - 1) last = key[e];
      if (e == E - 2) em2 = key[e];
    }
    if (cnt > E) last = E == 1 ? n_supers + key[0] : n_supers + em2 + 1;
    // the keys slot-major, one coalesced row a slot, and the histogram
#pragma unroll
    for (int e = 0; e < kPlacePer; ++e) {
      if (e >= E) break;
      const int v = e == E - 1 ? last : key[e];
      keys[e * n + j] = v;
      if (v != dead) atomicAdd(s_hist + v, 1);
    }
    q[j] = r.o.x;
    q[n + j] = r.o.y;
    q[2 * n + j] = r.o.z;
    q[3 * n + j] = r.d.x;
    q[4 * n + j] = r.d.y;
    q[5 * n + j] = r.d.z;
    bt0[j] = bt;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < dead; b += kKeysThreads) {
    if (s_hist[b] != 0) atomicAdd(hist + b, s_hist[b]);
  }
}

// The exclusive scan of s[0, bins) in place, by B's block: each thread
// scans a run of consecutive bins and calls at(b, start, count) for each
// (s[b] is then start). Returns the sum to every thread; s_warp holds
// kPlaceWarps + 1 ints of scratch. Every thread of the block calls it.
template <typename At>
__device__ __forceinline__ int block_scan(int* s, int bins, int* s_warp, At at) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (bins + kPlaceThreads - 1) / kPlaceThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, bins);
  const int hi = min(lo + per, bins);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += s[b];
  int x = sum;  // inclusive scan of the threads' sums within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kPlaceWarps ? s_warp[lane] : 0;
    int v = w;
#pragma unroll
    for (int d = 1; d < kPlaceWarps; d <<= 1) {
      const int y = __shfl_up_sync(kFullMask, v, d);
      if (lane >= d) v += y;
    }
    if (lane < kPlaceWarps) s_warp[lane] = v - w;
    if (lane == kPlaceWarps - 1) s_warp[kPlaceWarps] = v;
  }
  __syncthreads();
  int run = s_warp[warp] + x - sum;
  for (int b = lo; b < hi; ++b) {
    const int c = s[b];
    s[b] = run;
    at(b, run, c);
    run += c;
  }
  const int total = s_warp[kPlaceWarps];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kPlaceThreads)
    place_entries_kernel(const int* __restrict__ keys, const int* __restrict__ count, int n,
                         int E, int bins, const int* __restrict__ hist, int* __restrict__ cursor,
                         int* __restrict__ out_key, int* __restrict__ out_entry,
                         int* __restrict__ total) {
  extern __shared__ int smem[];
  int* s_start = smem;           // per key: its window's start in the stream
  int* s_tile = s_start + bins;  // per key: the tile's entries, then their start in the tile
  int* s_base = s_tile + bins;   // per key: its run's place in the stream less its tile start
  int* s_key = s_base + bins;    // the tile's entries in key order
  int* s_id = s_key + kPlaceStage;
  __shared__ int s_warp[kPlaceWarps + 1];
  const int n_listed = min(__ldg(count), n);
  const int lanes = kPlacePer / E;  // lanes per thread and tile
  const int tile_lanes = kPlaceThreads * lanes;
  // a block with no tile leaves at once, but block 0, which writes the total
  if (blockIdx.x > 0 && static_cast<int>(blockIdx.x) * tile_lanes >= n_listed) return;
  for (int b = threadIdx.x; b < bins; b += kPlaceThreads) {
    s_start[b] = __ldg(hist + b);
    s_tile[b] = 0;
  }
  __syncthreads();
  const int m = block_scan(s_start, bins, s_warp, [](int, int, int) {});
  if (blockIdx.x == 0 && threadIdx.x == 0) *total = m;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int tile = blockIdx.x; tile * tile_lanes < n_listed; tile += gridDim.x) {
    const int j0 = tile * tile_lanes + threadIdx.x;
    // entry i of the thread: slot i / lanes, lane j0 + (i % lanes) * kPlaceThreads
    int key[kPlacePer];
    int rank[kPlacePer];
    {
      int slot = 0, k = 0;
#pragma unroll
      for (int i = 0; i < kPlacePer; ++i) {
        const int j = j0 + k * kPlaceThreads;
        key[i] = slot < E && j < n_listed ? __ldg(keys + slot * n + j) : bins;
        if (++k == lanes) {
          k = 0;
          ++slot;
        }
      }
    }
    // each entry's rank within its key in the tile: one shared atomic per
    // run of equal keys in the warp
#pragma unroll
    for (int i = 0; i < kPlacePer; ++i) {
      const bool real = key[i] < bins;
      const unsigned active = __ballot_sync(kFullMask, real);
      rank[i] = 0;
      if (real) {
        const unsigned peers = __match_any_sync(active, key[i]);
        const int leader = __ffs(peers) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(s_tile + key[i], __popc(peers));
        rank[i] = __shfl_sync(peers, base, leader) + __popc(peers & lower);
      }
    }
    __syncthreads();
    // per key: its start in the tile, and one global atomic that reserves
    // the tile's run in the key's window
    const int in_tile = block_scan(s_tile, bins, s_warp, [&](int b, int start, int c) {
      if (c != 0) {
        s_base[b] = s_start[b] + atomicAdd(cursor + b, c) % __ldg(hist + b) - start;
      }
    });
    // stage the tile in key order
    {
      int slot = 0, k = 0;
#pragma unroll
      for (int i = 0; i < kPlacePer; ++i) {
        if (key[i] < bins) {
          const int p = s_tile[key[i]] + rank[i];
          s_key[p] = key[i];
          s_id[p] = slot * n + j0 + k * kPlaceThreads;
        }
        if (++k == lanes) {
          k = 0;
          ++slot;
        }
      }
    }
    __syncthreads();
    // each key's run with contiguous stores
    for (int p = threadIdx.x; p < in_tile; p += kPlaceThreads) {
      const int k = s_key[p];
      const int at = s_base[k] + p;
      out_key[at] = k;
      out_entry[at] = s_id[p];
    }
    for (int b = threadIdx.x; b < bins; b += kPlaceThreads) s_tile[b] = 0;
    __syncthreads();
  }
}

// The slab interval of row i of a (rows, 8) box table [min xyz, max xyz,
// 0, 0] (the supernode boxes).
__device__ __forceinline__ void row_span(const float* __restrict__ rows, int i, const ObjRay& r,
                                         float* tmin, float* tmax) {
  const float* b = rows + 8 * i;
  slab_span(make_float4(__ldg(b), __ldg(b + 1), __ldg(b + 2), 0.0f),
            make_float4(__ldg(b + 3), __ldg(b + 4), __ldg(b + 5), 0.0f), r, tmin, tmax);
}

// One entry's sweep of super s (geom-relative) by its warp, the ray `r`
// uniform across the warp, from C's lane-major tables (pack_sweep_tables:
// word k of every lane's box or triangle is one 128-byte access). Lane c
// slab-tests chunk box c, a ballot gives the chunks entered before the
// running best t, and each of them in ascending order (re-culled whenever
// bt falls) is one Moller-Trumbore step with lane x on its triangle x; the
// chunk's first least t is a min-reduction of the t bits (positive floats
// order as their bits) and a ballot for the lowest lane that holds it; it
// wins if strictly below bt. So a chunk is tested iff the ascending
// per-thread scan tested it, and bt, best, u and v follow that scan's
// strict-< updates exactly.
__device__ __forceinline__ void sweep_super(const float* __restrict__ tris,
                                            const float* __restrict__ boxes, int s,
                                            int n_chunks, int tri_start, int tri_count,
                                            const ObjRay& r, int lane, float& bt, int& best,
                                            float& bu, float& bv) {
  const int c0 = s * kSuper;
  float c_tmin = 0.0f;
  bool c_in = false;  // the line crosses the box ahead of the origin
  if (lane < n_chunks - c0) {
    const float* b = boxes + s * 8 * kSuper + lane;
    float c_tmax;
    slab_span(make_float4(__ldg(b), __ldg(b + kSuper), __ldg(b + 2 * kSuper), 0.0f),
              make_float4(__ldg(b + 3 * kSuper), __ldg(b + 4 * kSuper), __ldg(b + 5 * kSuper),
                          0.0f),
              r, &c_tmin, &c_tmax);
    c_in = c_tmax >= c_tmin && c_tmax > 0.0f;
  }
  unsigned todo = __ballot_sync(kFullMask, c_in && c_tmin < bt);
  while (todo != 0u) {
    const int c = __ffs(todo) - 1;
    todo &= todo - 1u;
    unsigned t_bits = kInfBits;  // no hit
    float u = 0.0f, v = 0.0f;
    if ((c0 + c) * kChunk + lane < tri_count) {  // this lane's triangle is real
      const float* w = tris + (c0 + c) * 9 * kChunk + lane;
      float t;
      if (mt_test<URound::kFuseY>(
              V3{__ldg(w), __ldg(w + kChunk), __ldg(w + 2 * kChunk)},
              V3{__ldg(w + 3 * kChunk), __ldg(w + 4 * kChunk), __ldg(w + 5 * kChunk)},
              V3{__ldg(w + 6 * kChunk), __ldg(w + 7 * kChunk), __ldg(w + 8 * kChunk)}, r, &t,
              &u, &v)) {
        t_bits = __float_as_uint(t);  // t > RAY_EPS > 0
      }
    }
    const unsigned least = __reduce_min_sync(kFullMask, t_bits);
    if (least < __float_as_uint(bt)) {  // warp-uniform
      const int win = __ffs(__ballot_sync(kFullMask, t_bits == least)) - 1;
      bt = __uint_as_float(least);
      best = tri_start + (c0 + c) * kChunk + win;
      bu = __shfl_sync(kFullMask, u, win);
      bv = __shfl_sync(kFullMask, v, win);
      todo &= __ballot_sync(kFullMask, c_in && c_tmin < bt);
    }
  }
}

template <bool kStream>
__global__ void __launch_bounds__(kSweepThreads)
    window_sweep_kernel(const float* __restrict__ tris, const float* __restrict__ boxes,
                        const float* __restrict__ supers, const int* __restrict__ key,
                        const int* __restrict__ entry, const int* __restrict__ total,
                        const float* __restrict__ q, int n, int n_supers, int n_chunks,
                        int tri_start, int tri_count, float* __restrict__ out_t,
                        int* __restrict__ out_tri, float* __restrict__ out_u,
                        float* __restrict__ out_v) {
  const int m = __ldg(total);
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kSweepWarps;
  // persistent warps, strided over the stream from its end: the tail
  // entries (the largest keys, the longest sweeps) go first and to every SM
  for (int w = blockIdx.x * kSweepWarps + (threadIdx.x >> 5); w < m; w += warps) {
    const int e = m - 1 - w;
    const int k = __ldg(key + e);
    int slot_j, j;
    if constexpr (kStream) {  // the entry's ray and result at its stream place
      slot_j = e;
      j = e;
    } else {
      slot_j = __ldg(entry + e);
      j = slot_j % n;
    }
    ObjRay r;
    r.o = {__ldg(q + j), __ldg(q + n + j), __ldg(q + 2 * n + j)};
    r.d = {__ldg(q + 3 * n + j), __ldg(q + 4 * n + j), __ldg(q + 5 * n + j)};
    r.inv_d = {1.0f / r.d.x, 1.0f / r.d.y, 1.0f / r.d.z};
    float bt = kFltMax;
    int best = -1;
    float bu = 0.0f, bv = 0.0f;
    if (k < n_supers) {
      sweep_super(tris, boxes, k, n_chunks, tri_start, tri_count, r, lane, bt, best, bu, bv);
    } else {
      // a tail: every super from k - n_supers on, in ascending order, each
      // culled first by its super box against the running bt (lanes over
      // supers). Exact: a super box is the min/max of its chunk boxes, so
      // with finite reciprocals (no 0 * inf) every chunk slab interval lies
      // inside its super's and a chunk that passes passes its super too.
      const bool cull = isfinite(r.inv_d.x) && isfinite(r.inv_d.y) && isfinite(r.inv_d.z);
      for (int s0 = k - n_supers; s0 < n_supers; s0 += 32) {
        const int s = s0 + lane;
        float s_tmin = -kFltMax;
        bool s_in = s < n_supers;
        if (s_in && cull) {
          float s_tmax;
          row_span(supers, s, r, &s_tmin, &s_tmax);
          s_in = s_tmax >= s_tmin && s_tmax > 0.0f;
        }
        unsigned todo = __ballot_sync(kFullMask, s_in && s_tmin < bt);
        while (todo != 0u) {
          const int b = __ffs(todo) - 1;
          todo &= todo - 1u;
          if (!(__shfl_sync(kFullMask, s_tmin, b) < bt)) continue;  // bt fell since
          sweep_super(tris, boxes, s0 + b, n_chunks, tri_start, tri_count, r, lane, bt, best,
                      bu, bv);
        }
      }
    }
    if (lane == 0) {
      out_t[slot_j] = bt;
      out_tri[slot_j] = best;
      out_u[slot_j] = bu;
      out_v[slot_j] = bv;
    }
  }
}

// C's grid: as many blocks as stay resident on the device at once.
template <bool kStream>
int sweep_blocks(int device, long long entries) {
  static int resident[64] = {};
  int& blocks = resident[device & 63];
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_sweep_kernel<kStream>,
                                                  kSweepThreads, 0);
    blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long need = (entries + kSweepWarps - 1) / kSweepWarps;
  return static_cast<int>(need < blocks ? need : blocks);
}

// A's and B's grids: as many blocks of `kernel` (`threads` each) as stay
// resident with `smem` bytes of dynamic shared memory each; the last query
// is kept in `cache` ({device, smem, blocks}).
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int threads, int device, int smem, int* cache,
                          int* out) {
  if (device != cache[0] || smem != cache[1]) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
    cache[0] = device;
    cache[1] = smem;
    cache[2] = sms * per_sm;
  }
  *out = cache[2];
  return cudaSuccess;
}

int g_keys_grid[3] = {-1, -1, 0};   // A's last resident_grid query
int g_place_grid[3] = {-1, -1, 0};  // B's

// D. E is a template argument, so the slots are unrolled: every slot's
// key and t are loaded at once (row e is in bounds for every j < n) and
// no slot's load waits on another's branch. Then the least t over the
// real slots in slot order (strict <: a tie goes to the lowest slot), the
// winner's triangle, u and v read once from its row, and for a lane under
// its bound the world-space tail and the merge.
template <int E>
__global__ void __launch_bounds__(kThreads)
    merge_entries_kernel(const Tables s, const MeshTables m, const RayLanes rays,
                         const int* __restrict__ list, const int* __restrict__ count, int n,
                         int dead, int g, int has_uv, const int* __restrict__ keys,
                         const float* __restrict__ sw_t, const int* __restrict__ sw_tri,
                         const float* __restrict__ sw_u, const float* __restrict__ sw_v,
                         const float* __restrict__ q, const float* __restrict__ bt0,
                         const HitLanes out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || j >= __ldg(count)) return;
  int key[E];
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

// D's instantiation for each E in [1, kPlacePer], at E - 1
const decltype(&merge_entries_kernel<1>) kMerge[] = {
    merge_entries_kernel<1>, merge_entries_kernel<2>, merge_entries_kernel<3>,
    merge_entries_kernel<4>, merge_entries_kernel<5>, merge_entries_kernel<6>,
    merge_entries_kernel<7>, merge_entries_kernel<8>};
static_assert(sizeof(kMerge) / sizeof(kMerge[0]) == kPlacePer, "one kernel for each E");

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t,
// PyTorch's current stream) of CUDA device `device` and returns
// cudaGetLastError() of the launch. tables = {xf, inv, invt, gtype, gmat,
// mat, env}; mesh = {tri, attr, box, geoms, chunk, super}; rays =
// {ox, oy, oz, dx, dy, dz, alive}; list/count: #7's candidate list; n: the
// pool size, the stride of every [slot, j] array; the big geom `geom` owns
// supers [super_start, +n_supers), chunks [chunk_start, +n_chunks) and soup
// triangles [tri_start, +tri_count).

// t_a: #7's analytic t; t_m: the mesh hit lanes' t so far. Out: keys
// (E, n) int32, q (6, n) f32 object-space rays, bt0 (n,) f32, hist
// (4 * n_supers,) int32: the histogram (2 * n_supers,), then B's cursor
// (2 * n_supers,), both zeroed on the stream here by one memset.
extern "C" int pt_super_keys(void* const* tables, int n_geoms, void* const* mesh,
                             void* const* rays, const float* t_a, const float* t_m,
                             const int* list, const int* count, int n, int geom, int super_start,
                             int n_supers, int E, int* keys, float* q, float* bt0, int* hist,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E < 1 || E > kPlacePer) return static_cast<int>(cudaErrorInvalidValue);
  const float* boxes = static_cast<const float*>(mesh[5]) + 8 * super_start;
  if (reinterpret_cast<uintptr_t>(boxes) % sizeof(float4) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(hist, 0, sizeof(int) * 4 * static_cast<size_t>(n_supers), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int smem = static_cast<int>(sizeof(int)) * 2 * n_supers;  // the histogram
    int blocks = 0;
    err = resident_grid(super_keys_kernel, kKeysThreads, device, smem, g_keys_grid, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Tables s = make_tables(tables, n_geoms, 0, 0);
    super_keys_kernel<<<std::min(blocks, blocks_of(n, kKeysThreads)), kKeysThreads, smem, st>>>(
        s.inv + 16 * geom, reinterpret_cast<const float4*>(boxes), n_supers, E,
        make_rays(rays), t_a, t_m, list, count, n, keys, q, bt0, hist);
  }
  return static_cast<int>(cudaGetLastError());
}

// hist: A's histogram (2 * n_supers,); cursor (2 * n_supers,): zero, or
// left by earlier launches of B on the same hist (A zeroes it with hist).
// Out: the real entries' keys in ascending order and their ids
// slot * n + j at [0, total), and total (1,). One launch, even at n == 0
// (it writes total); E in [1, kPlacePer].
extern "C" int pt_place_entries(const int* keys, const int* count, int n, int E, int n_supers,
                                const int* hist, int* cursor, int* out_key, int* out_entry,
                                int* total, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E < 1 || E > kPlacePer) return static_cast<int>(cudaErrorInvalidValue);
  const int bins = 2 * n_supers;
  const int smem = static_cast<int>(sizeof(int)) * (3 * bins + 2 * kPlaceStage);
  int blocks = 0;
  err = resident_grid(place_entries_kernel, kPlaceThreads, device, smem, g_place_grid, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile_lanes = kPlaceThreads * (kPlacePer / E);
  const int tiles = n > 0 ? (n + tile_lanes - 1) / tile_lanes : 1;
  place_entries_kernel<<<std::min(blocks, tiles), kPlaceThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      keys, count, n, E, bins, hist, cursor, out_key, out_entry, total);
  return static_cast<int>(cudaGetLastError());
}

// sweep = {tris (C, 9, 32), boxes (S, 8, 32)}: C's lane-major tables;
// total: the count of real entries (device). Out: per entry id, the
// object-space t (FLT_MAX: no triangle), triangle, u and v.
extern "C" int pt_window_sweep(void* const* mesh, void* const* sweep, const int* key,
                               const int* entry, const int* total, const float* q, int n, int E,
                               int super_start, int n_supers, int chunk_start, int n_chunks,
                               int tri_start, int tri_count, float* out_t, int* out_tri,
                               float* out_u, float* out_v, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    window_sweep_kernel<false><<<sweep_blocks<false>(device, static_cast<long long>(E) * n),
                                 kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sweep[0]) + 9 * kChunk * chunk_start,
        static_cast<const float*>(sweep[1]) + 8 * kSuper * super_start,
        static_cast<const float*>(mesh[5]) + 8 * super_start, key, entry, total, q, n,
        n_supers, n_chunks, tri_start, tri_count, out_t, out_tri, out_u, out_v);
  }
  return static_cast<int>(cudaGetLastError());
}

// C in stream order (the radix route): key, q (6, n) and total are the
// sorted stream of the radix passes (n its capacity); each entry's ray is
// q[:, e] and its (t, triangle, u, v) goes to [e].
extern "C" int pt_window_sweep_stream(void* const* mesh, void* const* sweep, const int* key,
                                      const int* total, const float* q, int n, int super_start,
                                      int n_supers, int chunk_start, int n_chunks,
                                      int tri_start, int tri_count, float* out_t, int* out_tri,
                                      float* out_u, float* out_v, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    window_sweep_kernel<true><<<sweep_blocks<true>(device, n), kSweepThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sweep[0]) + 9 * kChunk * chunk_start,
        static_cast<const float*>(sweep[1]) + 8 * kSuper * super_start,
        static_cast<const float*>(mesh[5]) + 8 * super_start, key, nullptr, total, q, n,
        n_supers, n_chunks, tri_start, tri_count, out_t, out_tri, out_u, out_v);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys, q, bt0: A's; t/tri/u/v: C's; hits: #8's 9 lanes, merged in place.
// E in [1, kPlacePer], each its own instantiation.
extern "C" int pt_merge_entries(void* const* tables, int n_geoms, void* const* mesh,
                                void* const* rays, const int* list, const int* count, int n,
                                int E, int n_supers, int geom, int has_uv, const int* keys,
                                const float* t, const int* tri, const float* u, const float* v,
                                const float* q, const float* bt0, void* const* hits, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E < 1 || E > kPlacePer) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const auto kernel = kMerge[E - 1];
    kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        make_tables(tables, n_geoms, 0, 0), make_mesh_tables(mesh, 0), make_rays(rays), list,
        count, n, 2 * n_supers, geom, has_uv, keys, t, tri, u, v, q, bt0,
        make_hits(hits, true));
  }
  return static_cast<int>(cudaGetLastError());
}
