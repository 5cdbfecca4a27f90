// Per-bounce (wavefront) path-tracing kernels for Hopper (sm_90a):
//
//   #2 first_bounce_kernel replaces ops/megakernel.py::first_bounce_pallas:
//      raygen + the depth-0 bounce, written to a fresh pool; reads no pool.
//   #3 bounce_step_kernel  replaces ops/megakernel.py::bounce_step_pallas:
//      one fused intersect + shade bounce over the pool, in place.
//   #4 shade_step_kernel   replaces ops/megakernel.py::shade_step_pallas:
//      the shading half of a bounce over given Intersections (the cached
//      depth 0 of --cache-first-bounce), written to a fresh pool.
//
// The pool is structure-of-arrays, one lane per path: origin, direction,
// throughput and radiance as 12 float32 lanes, then alive and pix as
// int32 (path_common.cuh's `Lanes`). #2 and #4 run one thread per lane,
// 128 to a block, no shared memory; the bounce arithmetic is
// csrc/path_common.cuh's (`raygen`, `intersect`, `shade`), the same code
// kernel #1 runs.
//
// Dead lanes: #4 copies a dead lane through. #3 bounces the live lanes
// below its live count: the pool size, or under stream compaction (live
// lanes first) a device int32 `num_alive`, read on the device, so no host
// sync; a lane at or past it is not read, and no dead lane is written.
// That is the TPU kernel's dead-tile skip, per lane.
//
// What bounds them on the H100: the per-lane sweep and shading arithmetic
// and warp divergence, as for #1; the bytes are the pool lanes (#3 reads
// every lane's alive below the count, then 13 lanes and writes 13 per
// live lane; #2 writes 56 B; #4 reads 80 B and writes 52 B), which the
// card moves in tens of microseconds at 800x800. What the designs do
// about it: coalesced SoA lanes, and in #3 the live lanes packed into
// full warps. A block of #3 owns kBounceThreads consecutive lanes, a lane
// a thread: it reads their alive flags below the count once; if one of
// them is dead, it packs the live ones into its first threads in lane
// order (`block_prefix`, as #7 packs its lanes), so a warp's cost
// follows the live lanes and not the pool (a thread per lane runs every
// warp that holds a live lane: at depth 7 of (a) 16,462 of 20,000 warps
// for 119,339 live lanes, PERF.md §6); a block whose first lane is at or
// past the count returns whole, and a block whose lanes are all live (a
// compacted pool's) skips the packing after one barrier. Which thread
// bounces a lane moves no result: each lane is read and written by one
// thread, and the RNG is keyed on the lane's pix. A thin pool's live
// lanes still sit in most of its 32-byte sectors, so #3 on (a) stays
// above the same lanes compacted.

#include "path_common.cuh"

namespace {

struct IsectLanes {
  const float* t;
  const float* nx;
  const float* ny;
  const float* nz;
  const int* mat;
  const int* outside;
};

__global__ void __launch_bounds__(kThreads)
    first_bounce_kernel(const Tables s, const float* __restrict__ cam, const Lanes out,
                        int iteration, int resx, int resy) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= resx * resy) return;
  Path p;
  raygen(cam, pix, resx, resy, iteration, s.flags, &p.org, &p.dir);
  p.thr = {1.0f, 1.0f, 1.0f};
  p.rad = {0.0f, 0.0f, 0.0f};
  const Hit h = intersect(s, p.org, p.dir);
  const bool alive = shade(s, p, h, static_cast<uint32_t>(iteration), 0,
                           static_cast<uint32_t>(pix));
  store_path(out, pix, p);
  out.alive[pix] = alive ? 1 : 0;
  out.pix[pix] = pix;
}

constexpr int kBounceThreads = kThreads;  // #3: threads (and lanes) a block
constexpr int kBounceWarps = kBounceThreads / 32;

__global__ void __launch_bounds__(kBounceThreads)
    bounce_step_kernel(const Tables s, const Lanes pool, const int* __restrict__ num_alive,
                       int n, int iteration, int depth) {
  __shared__ int s_lanes[kBounceThreads];  // the block's live lanes, packed
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
  Path p = load_path(pool, i);
  const Hit h = intersect(s, p.org, p.dir);
  const bool alive = shade(s, p, h, static_cast<uint32_t>(iteration), depth,
                           static_cast<uint32_t>(pool.pix[i]));
  store_path(pool, i, p);
  pool.alive[i] = alive ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    shade_step_kernel(const Tables s, const Lanes in, const IsectLanes is, const Lanes out,
                      int n, int iteration, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Path p = load_path(in, i);
  bool alive = in.alive[i] != 0;
  if (alive) {
    Hit h;
    h.t = is.t[i];
    h.n = {is.nx[i], is.ny[i], is.nz[i]};
    h.mat = is.mat[i];
    h.outside = is.outside[i] != 0;
    alive = shade(s, p, h, static_cast<uint32_t>(iteration), depth,
                  static_cast<uint32_t>(in.pix[i]));
  }
  store_path(out, i, p);
  out.alive[i] = alive ? 1 : 0;
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t,
// PyTorch's current stream) of CUDA device `device` and returns
// cudaGetLastError() of the launch. tables = {xf, inv, invt, gtype, gmat,
// mat, env}; a pool is 14 pointers (12 float lanes, alive, pix).

extern "C" int pt_first_bounce(void* const* tables, int n_geoms, const float* cam,
                               void* const* pool, int iteration, int resx, int resy,
                               int rr_start, int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables s = make_tables(tables, n_geoms, flags, rr_start);
  const int n = resx * resy;
  if (n > 0) {
    first_bounce_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        s, cam, make_lanes(pool), iteration, resx, resy);
  }
  return static_cast<int>(cudaGetLastError());
}

// num_alive: a device int32 (live lanes first), or null for "all n".
extern "C" int pt_bounce_step(void* const* tables, int n_geoms, void* const* pool,
                              const int* num_alive, int n, int iteration, int depth,
                              int rr_start, int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables s = make_tables(tables, n_geoms, flags, rr_start);
  if (n > 0) {
    bounce_step_kernel<<<(n + kBounceThreads - 1) / kBounceThreads, kBounceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(s, make_lanes(pool), num_alive, n,
                                                              iteration, depth);
  }
  return static_cast<int>(cudaGetLastError());
}

// isect = {t, nx, ny, nz, material_id (int32), outside (int32)};
// pool_out's pix pointer is not written (pix passes through).
extern "C" int pt_shade_step(void* const* tables, int n_geoms, void* const* pool_in,
                             void* const* isect, void* const* pool_out, int n, int iteration,
                             int depth, int rr_start, int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables s = make_tables(tables, n_geoms, flags, rr_start);
  IsectLanes is;
  is.t = static_cast<const float*>(isect[0]);
  is.nx = static_cast<const float*>(isect[1]);
  is.ny = static_cast<const float*>(isect[2]);
  is.nz = static_cast<const float*>(isect[3]);
  is.mat = static_cast<const int*>(isect[4]);
  is.outside = static_cast<const int*>(isect[5]);
  if (n > 0) {
    shade_step_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        s, make_lanes(pool_in), is, make_lanes(pool_out), n, iteration, depth);
  }
  return static_cast<int>(cudaGetLastError());
}
