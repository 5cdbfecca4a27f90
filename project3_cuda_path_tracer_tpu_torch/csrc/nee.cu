// NEE + MIS path-tracing kernels for Hopper (sm_90a):
//
//   #5 bounce_step_nee_kernel replaces ops/megakernel.py::bounce_step_pallas_nee:
//      one NEE + MIS bounce over the pool, in place, the MIS aux
//      (prev_pdf, prev_nondelta) riding as two more float lanes.
//   #6 full_iteration_nee_kernel replaces ops/megakernel.py::full_iteration_nee_pallas:
//      raygen and every bounce of the estimator in one launch per
//      iteration, the path state and the MIS aux in registers, each
//      pixel's radiance added into the caller's accumulator.
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
// Design: one thread per path, 128 to a block, no shared memory, as #1 and
// #3. A lane dead on entry to #5 returns at once with its lanes and aux
// unchanged. The shadow test is an any-hit loop over the geoms that stops
// at the first occluder (path_common.cuh `unoccluded`), and only lanes
// that can take the light sample (a non-delta lobe, both cosines positive)
// cast it.
//
// What bounds them on the H100: arithmetic and warp divergence, as for #1
// and #3. Per live lane and bounce they do about twice #1's work: the
// nearest-hit sweep, the light sample, and a second sweep for the shadow
// ray (it stops early when occluded). #6 moves 24 B per pixel per
// iteration (the accumulator); #5 reads 16 lanes and writes 15 per live
// lane (124 B). What the design does about it: nothing yet beyond the
// early exits; the NEE code is reached only from these two kernels, so #1-#4
// compile as they did.

#include "path_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
    full_iteration_nee_kernel(const Tables s, const Lights L, const float* __restrict__ cam,
                              float* acc_r, float* acc_g, float* acc_b, int iteration, int resx,
                              int resy, int depth) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= resx * resy) return;
  const uint32_t it = static_cast<uint32_t>(iteration);
  const uint32_t upix = static_cast<uint32_t>(pix);
  Path p;
  raygen(cam, pix, resx, resy, iteration, s.flags, &p.org, &p.dir);
  p.thr = {1.0f, 1.0f, 1.0f};
  p.rad = {0.0f, 0.0f, 0.0f};
  NeeAux a = {0.0f, 0.0f};  // the camera vertex: full weight at a light
  for (int d = 0; d < depth; ++d) {
    const Hit h = intersect(s, p.org, p.dir);
    if (!shade_nee(s, L, p, a, h, it, d, upix, d == depth - 1)) break;
  }
  acc_r[pix] += p.rad.x;
  acc_g[pix] += p.rad.y;
  acc_b[pix] += p.rad.z;
}

__global__ void __launch_bounds__(kThreads)
    bounce_step_nee_kernel(const Tables s, const Lights L, const Lanes pool,
                           float* __restrict__ prev_pdf, float* __restrict__ prev_nondelta, int n,
                           int iteration, int depth, int is_last) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (pool.alive[i] == 0) return;
  Path p = load_path(pool, i);
  NeeAux a = {prev_pdf[i], prev_nondelta[i]};
  const Hit h = intersect(s, p.org, p.dir);
  const bool alive = shade_nee(s, L, p, a, h, static_cast<uint32_t>(iteration), depth,
                               static_cast<uint32_t>(pool.pix[i]), is_last != 0);
  store_path(pool, i, p);
  pool.alive[i] = alive ? 1 : 0;
  prev_pdf[i] = a.pdf;
  prev_nondelta[i] = a.nondelta;
}

inline Lights make_lights(void* const* tables, int n_lights, float aw) {
  Lights L;
  L.idx = static_cast<const int*>(tables[7]);
  L.n = n_lights;
  L.aw = aw;
  return L;
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t,
// PyTorch's current stream) of CUDA device `device` and returns
// cudaGetLastError() of the launch. tables = {xf, inv, invt, gtype, gmat,
// mat, env, lights}; aw = the MIS light pdf model (mean light area x
// n_lights).

// pool = 16 pointers: the 12 float lanes, alive, pix, prev_pdf, prev_nondelta.
extern "C" int pt_bounce_step_nee(void* const* tables, int n_geoms, int n_lights, float aw,
                                  void* const* pool, int n, int iteration, int depth,
                                  int is_last, int rr_start, int flags, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables s = make_tables(tables, n_geoms, flags, rr_start);
  if (n > 0) {
    bounce_step_nee_kernel<<<n_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        s, make_lights(tables, n_lights, aw), make_lanes(pool), static_cast<float*>(pool[14]),
        static_cast<float*>(pool[15]), n, iteration, depth, is_last);
  }
  return static_cast<int>(cudaGetLastError());
}

// acc = {r, g, b}
extern "C" int pt_full_iteration_nee(void* const* tables, int n_geoms, int n_lights, float aw,
                                     const float* cam, float* const* acc, int iteration,
                                     int resx, int resy, int depth, int rr_start, int flags,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables s = make_tables(tables, n_geoms, flags, rr_start);
  const int n_pixels = resx * resy;
  if (n_pixels > 0) {
    full_iteration_nee_kernel<<<n_blocks(n_pixels), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        s, make_lights(tables, n_lights, aw), cam, acc[0], acc[1], acc[2], iteration, resx,
        resy, depth);
  }
  return static_cast<int>(cudaGetLastError());
}
