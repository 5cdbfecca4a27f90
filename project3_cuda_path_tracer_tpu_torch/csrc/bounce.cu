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
// 128 to a block; the bounce arithmetic is csrc/path_common.cuh's
// (`raygen`, the geom tests, `shade`), the same code kernel #1 runs, so
// #1 equals #2 -> #3 bit for bit.
//
// #2 is bound by instruction issue: its lanes run the same sweep over
// every geom, each box test six IEEE divisions, and the kernel keeps the
// card's schedulers busy for most of its time (PERF.md §6). Its design
// cuts the instructions a lane issues, each value computed with the
// per-lane code so the results keep their bits: a block stages the
// geoms' rows in shared memory (kStage at a time, in geom order) and,
// without depth of field, where every ray starts at the camera, the
// origin's terms once per geom (the object-space origin, a box's slab
// numerators, a sphere's |ro|^2 - 1/4); a box's two slabs of an axis
// share one reciprocal (`div_pair`); each hit keeps the object-space part
// of its normal, so the winner needs no second test; and the camera draws
// two numbers, not four, when there is no depth of field.
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
//
// Each kernel is a template on its tables: a scene with file textures,
// bump maps, a lat-long env map or SSS runs its instantiation on
// TexTables, which compiles path_common.cuh's surface stage (#4's also
// reads the cached hits' mesh UVs); the one on Tables compiles none of it.

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

// The Intersections' mesh UVs, which #4 reads under the surface stage.
struct UvLanes {
  const float* u;
  const float* v;
  const int* has_uv;
};

// #2: geoms a block stages in shared memory at a time. A scene with more
// is swept in chunks of kStage, in geom order.
constexpr int kStage = 32;

// One staged geom of #2: rows 0-2 of its inverse and transform, its type
// and, for a pinhole camera, the terms of the camera's origin that every
// lane's sweep would compute alike: the origin in object space (w: the
// sphere's |ro|^2 - 1/4), the box's slab numerators -1/2 - qo, 1/2 - qo
// and whether all six pass div_operand_ok.
struct Staged {
  float4 inv[3];
  float4 xf[3];
  float4 qo;
  float4 lo;
  float4 hi;
  int type;
  bool nums_ok;
};

// Geom g's staged row, computed by one thread of the block with the
// per-lane code (xform_point, the same subtractions and dot), so with the
// per-lane roundings; pos is the camera's origin, every lane's ray origin
// without depth of field.
template <bool kPinhole>
__device__ __forceinline__ void stage_geom(const Tables& s, int g, V3 pos, Staged* r) {
  const float* inv = s.inv + 16 * g;
  const float* xf = s.xf + 16 * g;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r->inv[k] = make_float4(__ldg(inv + 4 * k), __ldg(inv + 4 * k + 1), __ldg(inv + 4 * k + 2),
                            __ldg(inv + 4 * k + 3));
    r->xf[k] = make_float4(__ldg(xf + 4 * k), __ldg(xf + 4 * k + 1), __ldg(xf + 4 * k + 2),
                           __ldg(xf + 4 * k + 3));
  }
  r->type = __ldg(s.gtype + g);
  if constexpr (kPinhole) {
    const V3 qo = xform_point(inv, pos);
    r->qo = make_float4(qo.x, qo.y, qo.z, dot(qo, qo) - 0.25f);
    r->lo = make_float4(-0.5f - qo.x, -0.5f - qo.y, -0.5f - qo.z, 0.0f);
    r->hi = make_float4(0.5f - qo.x, 0.5f - qo.y, 0.5f - qo.z, 0.0f);
    r->nums_ok = div_operand_ok(r->lo.x) && div_operand_ok(r->lo.y) &&
                 div_operand_ok(r->lo.z) && div_operand_ok(r->hi.x) &&
                 div_operand_ok(r->hi.y) && div_operand_ok(r->hi.z);
  }
}

__device__ __forceinline__ float axis(float4 v, int a) { return a == 0 ? v.x : a == 1 ? v.y : v.z; }

// A geom test's view of a staged geom (path_common.cuh's TableGeom reads
// the tables): with kPinhole the staged origin terms, else the lane's own.
template <bool kPinhole>
struct StagedGeom {
  const Staged* r;
  __device__ __forceinline__ V3 origin(V3 o) const {
    if constexpr (kPinhole) {
      return {r->qo.x, r->qo.y, r->qo.z};
    } else {
      return xform_point(Rows3{r->inv[0], r->inv[1], r->inv[2]}, o);
    }
  }
  __device__ __forceinline__ V3 direction(V3 d) const {
    return xform_dir(Rows3{r->inv[0], r->inv[1], r->inv[2]}, d);
  }
  __device__ __forceinline__ void slab_t(float o, float d, int a, float* t1, float* t2) const {
    if constexpr (kPinhole) {
      div_pair(axis(r->lo, a), axis(r->hi, a), d, r->nums_ok, t1, t2);
    } else {
      *t1 = (-0.5f - o) / d;
      *t2 = (0.5f - o) / d;
    }
  }
  __device__ __forceinline__ float sphere_c(V3 ro) const {
    if constexpr (kPinhole) return r->qo.w;
    return dot(ro, ro) - 0.25f;
  }
  __device__ __forceinline__ V3 to_world(V3 p) const {
    return xform_point(Rows3{r->xf[0], r->xf[1], r->xf[2]}, p);
  }
};

// #2's min-t sweep: path_common.cuh's `intersect` over the staged geoms,
// chunk by chunk, in geom order with the strict-< update. Each hit keeps
// the object-space part of its normal, so the winner's normal is that
// part transformed, with no second test. Every thread of the block calls
// it (it holds the block's barriers); a thread that is not `on` only
// stages.
template <bool kPinhole>
__device__ __forceinline__ Hit intersect_staged(const Tables& s, Staged* stage, V3 pos, V3 org,
                                                V3 dir, bool on) {
  float best_t = -1.0f;
  int best_g = -1;
  V3 best_v = {0.0f, 0.0f, 0.0f};
  bool best_out = true;
  for (int g0 = 0; g0 < s.n_geoms; g0 += kStage) {
    const int in_stage = min(kStage, s.n_geoms - g0);
    if (g0 > 0) __syncthreads();  // every thread is done with the last chunk
    for (int k = threadIdx.x; k < in_stage; k += kThreads) {
      stage_geom<kPinhole>(s, g0 + k, pos, stage + k);
    }
    __syncthreads();
    if (!on) continue;
    for (int k = 0; k < in_stage; ++k) {
      const StagedGeom<kPinhole> gm{stage + k};
      V3 v = {0.0f, 0.0f, 0.0f};
      bool out = true;
      const float t = stage[k].type == kSphere
                          ? sphere_hit<true>(gm, nullptr, org, dir, true, &v, &out)
                          : box_hit<true>(gm, org, dir, true, &v, &out);
      const float prev = best_t > 0.0f ? best_t : kFltMax;
      if (t > 0.0f && prev > t) {
        best_t = t;
        best_g = g0 + k;
        best_v = v;
        best_out = out;
      }
    }
  }
  Hit h;
  h.t = best_t;
  h.n = {0.0f, 0.0f, 0.0f};
  h.mat = -1;
  h.outside = true;
  if (best_g >= 0) {
    // the world normal as box_test and sphere_test compute it
    if (__ldg(s.gtype + best_g) == kSphere) {
      h.n = normalize(xform_dir(s.invt + 16 * best_g, best_v)) * (best_out ? 1.0f : -1.0f);
    } else {
      h.n = normalize(xform_dir(s.xf + 16 * best_g, best_v));
    }
    h.outside = best_out;
    h.mat = __ldg(s.gmat + best_g);
  }
  return h;
}

// kPinhole: no depth of field, so every lane's ray starts at the camera.
template <bool kPinhole, class T>
__global__ void __launch_bounds__(kThreads)
    first_bounce_kernel(const T s, const float* __restrict__ cam, const Lanes out,
                        int iteration, int resx, int resy) {
  __shared__ Staged stage[kStage];
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = pix < resx * resy;
  Path p;
  raygen<kPinhole>(cam, pix, resx, resy, iteration, s.flags, &p.org, &p.dir);
  p.thr = {1.0f, 1.0f, 1.0f};
  p.rad = {0.0f, 0.0f, 0.0f};
  const V3 pos = {__ldg(cam + 0), __ldg(cam + 1), __ldg(cam + 2)};
  const Hit h = intersect_staged<kPinhole>(s, stage, pos, p.org, p.dir, on);
  if (on) {
    const bool alive = shade(s, p, h, static_cast<uint32_t>(iteration), 0,
                             static_cast<uint32_t>(pix));
    store_path(out, pix, p);
    out.alive[pix] = alive ? 1 : 0;
    out.pix[pix] = pix;
  }
}

constexpr int kBounceThreads = kThreads;  // #3: threads (and lanes) a block
constexpr int kBounceWarps = kBounceThreads / 32;

template <class T>
__global__ void __launch_bounds__(kBounceThreads)
    bounce_step_kernel(const T s, const Lanes pool, const int* __restrict__ num_alive,
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

// uv: read by the instantiation on TexTables alone
template <class T>
__global__ void __launch_bounds__(kThreads)
    shade_step_kernel(const T s, const Lanes in, const IsectLanes is, const Lanes out,
                      int n, int iteration, int depth, const UvLanes uv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Path p = load_path(in, i);
  bool alive = in.alive[i] != 0;
  if (alive) {
    HitOf<T> h;
    h.t = is.t[i];
    h.n = {is.nx[i], is.ny[i], is.nz[i]};
    h.mat = is.mat[i];
    h.outside = is.outside[i] != 0;
    if constexpr (T::kTex) {
      h.u = uv.u[i];
      h.v = uv.v[i];
      h.has_uv = uv.has_uv[i] != 0;
    }
    alive = shade(s, p, h, static_cast<uint32_t>(iteration), depth,
                  static_cast<uint32_t>(in.pix[i]));
  }
  store_path(out, i, p);
  out.alive[i] = alive ? 1 : 0;
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t,
// PyTorch's current stream) of CUDA device `device` and returns
// cudaGetLastError() of the launch: its instantiation on TexTables when
// flags has a kSurfaceStage bit. tables = {xf, inv, invt, gtype, gmat,
// mat, env, lights, surf, tex, bump, envmap}; a pool is 14 pointers (12
// float lanes, alive, pix).

extern "C" int pt_first_bounce(void* const* tables, int n_geoms, const float* cam,
                               void* const* pool, int iteration, int resx, int resy,
                               int rr_start, int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = resx * resy;
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (flags & kSurfaceStage) {
      auto kernel = (flags & kDof) ? first_bounce_kernel<false, TexTables>
                                   : first_bounce_kernel<true, TexTables>;
      kernel<<<n_blocks(n), kThreads, 0, st>>>(make_tex_tables(tables, n_geoms, flags, rr_start),
                                               cam, make_lanes(pool), iteration, resx, resy);
    } else {
      auto kernel = (flags & kDof) ? first_bounce_kernel<false, Tables>
                                   : first_bounce_kernel<true, Tables>;
      kernel<<<n_blocks(n), kThreads, 0, st>>>(make_tables(tables, n_geoms, flags, rr_start), cam,
                                               make_lanes(pool), iteration, resx, resy);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// num_alive: a device int32 (live lanes first), or null for "all n".
extern "C" int pt_bounce_step(void* const* tables, int n_geoms, void* const* pool,
                              const int* num_alive, int n, int iteration, int depth,
                              int rr_start, int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = (n + kBounceThreads - 1) / kBounceThreads;
    if (flags & kSurfaceStage) {
      bounce_step_kernel<<<blocks, kBounceThreads, 0, st>>>(
          make_tex_tables(tables, n_geoms, flags, rr_start), make_lanes(pool), num_alive, n,
          iteration, depth);
    } else {
      bounce_step_kernel<<<blocks, kBounceThreads, 0, st>>>(
          make_tables(tables, n_geoms, flags, rr_start), make_lanes(pool), num_alive, n,
          iteration, depth);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// isect = {t, nx, ny, nz, material_id (int32), outside (int32), tex_u,
// tex_v, has_uv (int32)} (the last three read under the surface stage);
// pool_out's pix pointer is not written (pix passes through).
extern "C" int pt_shade_step(void* const* tables, int n_geoms, void* const* pool_in,
                             void* const* isect, void* const* pool_out, int n, int iteration,
                             int depth, int rr_start, int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  IsectLanes is;
  is.t = static_cast<const float*>(isect[0]);
  is.nx = static_cast<const float*>(isect[1]);
  is.ny = static_cast<const float*>(isect[2]);
  is.nz = static_cast<const float*>(isect[3]);
  is.mat = static_cast<const int*>(isect[4]);
  is.outside = static_cast<const int*>(isect[5]);
  UvLanes uv;
  uv.u = static_cast<const float*>(isect[6]);
  uv.v = static_cast<const float*>(isect[7]);
  uv.has_uv = static_cast<const int*>(isect[8]);
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (flags & kSurfaceStage) {
      shade_step_kernel<<<n_blocks(n), kThreads, 0, st>>>(
          make_tex_tables(tables, n_geoms, flags, rr_start), make_lanes(pool_in), is,
          make_lanes(pool_out), n, iteration, depth, uv);
    } else {
      shade_step_kernel<<<n_blocks(n), kThreads, 0, st>>>(
          make_tables(tables, n_geoms, flags, rr_start), make_lanes(pool_in), is,
          make_lanes(pool_out), n, iteration, depth, uv);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
