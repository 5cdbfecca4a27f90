// Whole-iteration path-tracing kernel for Hopper (sm_90a), kernel #1.
//
// Replaces the JAX package's ops/megakernel.py::full_iteration_pallas for
// analytic scenes (spheres and boxes): one launch per iteration does
// raygen (pinhole, stratified 4x4 AA, thin-lens DoF), the min-t sweep over
// all geoms, the minstd RNG keyed on (iteration, pixelIndex, depth) with
// the R2 / Sobol pair at depth 0 under --stratified / --sobol, every
// analytic lobe of the shader (diffuse, mirror, partial-reflective
// lottery, Phong glossy, Schlick refraction with TIR, Russian roulette,
// constant ENVLIGHT, the procedural checker) and all trace_depth bounces,
// then adds each pixel's radiance straight into the caller's accumulator.
// Adding in place saves the 3*P float read and write of a separate
// accumulate per iteration.
//
// Design: one thread per pixel (pix = x + y*resx), bounds-checked instead
// of the TPU kernel's 1024-lane padding, with the path state (origin,
// direction, throughput, radiance) in registers across bounces. A dead
// path leaves the depth loop: nothing it holds changes after death. The
// bounce itself (`intersect` + `shade`) is csrc/path_common.cuh's, shared
// with the per-bounce kernels of bounce.cu. The feature flags are uniform
// branches: a scene without them skips their code in every thread.
//
// What bounds it on the H100: arithmetic and warp divergence, not bytes.
// It writes 12 B per pixel per iteration (and reads the same 12 B of the
// accumulator); everything else is a few KB of tables. This first design
// is one thread per path and nothing more: no path regeneration, no
// sorting by material, no wgmma or TMA (there is no matrix product here).
// Making it fast is later work.

#include "path_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
    full_iteration_kernel(const Tables s, const float* __restrict__ cam, float* acc_r,
                          float* acc_g, float* acc_b, int iteration, int resx, int resy,
                          int depth) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= resx * resy) return;
  const uint32_t it = static_cast<uint32_t>(iteration);
  const uint32_t upix = static_cast<uint32_t>(pix);
  Path p;
  raygen(cam, pix, resx, resy, iteration, s.flags, &p.org, &p.dir);
  p.thr = {1.0f, 1.0f, 1.0f};
  p.rad = {0.0f, 0.0f, 0.0f};
  for (int d = 0; d < depth; ++d) {
    const Hit h = intersect(s, p.org, p.dir);
    if (!shade(s, p, h, it, d, upix)) break;
  }
  acc_r[pix] += p.rad.x;
  acc_g[pix] += p.rad.y;
  acc_b[pix] += p.rad.z;
}

}  // namespace

// Launches one iteration on `stream` (a cudaStream_t, PyTorch's current
// stream) of CUDA device `device`. tables = {xf, inv, invt, gtype, gmat,
// mat, env}; acc = {r, g, b}. Returns cudaGetLastError() of the launch.
extern "C" int pt_full_iteration(void* const* tables, int n_geoms, const float* cam,
                                 float* const* acc, int iteration, int resx, int resy,
                                 int depth, int rr_start, int flags, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables s = make_tables(tables, n_geoms, flags, rr_start);
  const int n_pixels = resx * resy;
  if (n_pixels > 0) {
    full_iteration_kernel<<<n_blocks(n_pixels), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        s, cam, acc[0], acc[1], acc[2], iteration, resx, resy, depth);
  }
  return static_cast<int>(cudaGetLastError());
}
