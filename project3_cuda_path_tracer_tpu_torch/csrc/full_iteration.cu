// Whole-iteration path-tracing kernel for Hopper (sm_90a), kernel #1.
//
// Replaces the JAX package's ops/megakernel.py::full_iteration_pallas for
// analytic scenes (spheres and boxes): for each iteration of a run, one
// launch does raygen (pinhole, stratified 4x4 AA, thin-lens DoF), the
// min-t sweep over all geoms, the minstd RNG keyed on (iteration,
// pixelIndex, depth) with
// the R2 / Sobol pair at depth 0 under --stratified / --sobol, every
// analytic lobe of the shader (diffuse, mirror, partial-reflective
// lottery, Phong glossy, Schlick refraction with TIR, Russian roulette,
// constant ENVLIGHT, the procedural checker) and all trace_depth bounces,
// then adds each pixel's radiance straight into the caller's accumulator.
// Adding in place saves the 3*P float read and write of a separate
// accumulate per iteration.
//
// What bounds it on the H100: arithmetic and warp divergence, not bytes.
// It writes 12 B per pixel per iteration (and reads the same 12 B of the
// accumulator); everything else is a few KB of tables. With one thread
// per pixel, a path that dies early leaves its lane idle until the
// longest path of its warp ends: on Cornell 800x800 d8 AA only 57% of the
// lanes of the warp-steps do a bounce.
//
// Design: persistent warps with path regeneration, over a run of
// iterations. The grid is as many blocks as stay resident (SMs x
// occupancy, computed once per device). Each lane holds one path (pixel,
// iteration, depth, origin, direction, throughput, radiance) in registers
// and the pixel's accumulator value. When its path ends (`shade` returns
// false, or it has run `depth` bounces) the lane adds the radiance to that
// value, as the plain version adds one iteration after another, and runs
// `raygen` for the pixel's next iteration in the same loop; after the
// pixel's last iteration it stores the value and takes the next pixel
// from one device-side counter (a word of its own per launch, zeroed by
// the caller): a ballot of the lanes that need a pixel, one atomicAdd of
// its popcount by the first of them, a shuffle of the base and each
// lane's rank in the ballot. So every lane bounces at its own depth until
// the pixels run out, and the launch's tail (the last paths of the last
// pixels) is paid once per run of iterations, not once per iteration.
// Each pixel gets exactly one path per iteration, and the RNG is keyed on
// (iteration, pixelIndex, depth), never on the lane, so the result does
// not depend on which lane ran which pixel: it is the thread-per-pixel
// kernel's bit for bit, as are the per-bounce kernels' (#2 -> #3). The
// bounce itself (`intersect` + `shade`) is csrc/path_common.cuh's, shared
// with the per-bounce kernels of bounce.cu. The feature flags are uniform
// branches: a scene without them skips their code in every thread. A scene
// with file textures, bump maps, a lat-long env map or SSS runs the
// kernel's instantiation on TexTables, which compiles path_common.cuh's
// surface stage; the one on Tables compiles none of it. There is no matrix
// product here, so no wgmma or TMA.

#include <algorithm>

#include "path_common.cuh"

namespace {

// 7 blocks of kThreads stay resident on an SM at the kernel's 72
// registers; naming that minimum lets ptxas schedule for it (faster on the
// H100 than the same registers without it)
template <class T>
__global__ void __launch_bounds__(kThreads, 7)
    full_iteration_kernel(const T s, const float* __restrict__ cam, float* acc_r,
                          float* acc_g, float* acc_b, int iteration0, int n_iters, int resx,
                          int resy, int depth, int* __restrict__ counter) {
  const int n_pixels = resx * resy;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  bool need = true;   // this lane has no pixel
  bool done = false;  // the pixels ran out for this lane
  bool fresh = false;  // the lane's next step starts a path
  int pix = 0, k = 0, d = 0;  // pixel, its iteration (from iteration0), depth
  V3 sum = {0.0f, 0.0f, 0.0f};  // acc[pix] plus the pixel's paths so far
  Path p;
  for (;;) {
    // each lane without a pixel takes the next one: one atomicAdd per warp
    const unsigned want = __ballot_sync(0xffffffffu, need);
    if (want) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(counter, __popc(want));
      base = __shfl_sync(0xffffffffu, base, leader);
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
    if (!__any_sync(0xffffffffu, !done)) break;
    if (done) continue;
    const int iteration = iteration0 + k;
    if (fresh) {
      raygen(cam, pix, resx, resy, iteration, s.flags, &p.org, &p.dir);
      p.thr = {1.0f, 1.0f, 1.0f};
      p.rad = {0.0f, 0.0f, 0.0f};
      d = 0;
      fresh = false;
    }
    bool alive = false;
    if (d < depth) {
      const Hit h = intersect(s, p.org, p.dir);
      alive = shade(s, p, h, static_cast<uint32_t>(iteration), d, static_cast<uint32_t>(pix));
      ++d;
    }
    if (!alive || d >= depth) {
      // the path ends: add it as the plain version adds an iteration,
      // then the pixel's next iteration, or its sum out and a new pixel
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

int g_resident[64];      // resident blocks per device, 0 until queried
int g_resident_tex[64];  // the same for the surface stage's instantiation

}  // namespace

// Launches iterations iteration0 .. iteration0 + n_iters - 1 on `stream`
// (a cudaStream_t, PyTorch's current stream) of CUDA device `device`.
// tables = {xf, inv, invt, gtype, gmat, mat, env, lights, surf, tex, bump,
// envmap} (the last four read when flags has a kSurfaceStage bit: the
// instantiation on TexTables); acc = {r, g, b};
// counter: one int32 on the device, zero before the launch and used by no
// other launch. Returns cudaGetLastError() of the launch, or the occupancy
// query's error.
extern "C" int pt_full_iteration(void* const* tables, int n_geoms, const float* cam,
                                 float* const* acc, int iteration0, int n_iters, int resx,
                                 int resy, int depth, int rr_start, int flags, int* counter,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pixels = resx * resy;
  if (n_pixels > 0 && n_iters > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int resident = 0;
    if (flags & kSurfaceStage) {
      err = resident_blocks(full_iteration_kernel<TexTables>, device, g_resident_tex, &resident);
      if (err != cudaSuccess) return static_cast<int>(err);
      full_iteration_kernel<<<std::min(resident, n_blocks(n_pixels)), kThreads, 0, st>>>(
          make_tex_tables(tables, n_geoms, flags, rr_start), cam, acc[0], acc[1], acc[2],
          iteration0, n_iters, resx, resy, depth, counter);
    } else {
      err = resident_blocks(full_iteration_kernel<Tables>, device, g_resident, &resident);
      if (err != cudaSuccess) return static_cast<int>(err);
      full_iteration_kernel<<<std::min(resident, n_blocks(n_pixels)), kThreads, 0, st>>>(
          make_tables(tables, n_geoms, flags, rr_start), cam, acc[0], acc[1], acc[2],
          iteration0, n_iters, resx, resy, depth, counter);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
