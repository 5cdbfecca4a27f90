// Whole-iteration path-tracing kernel for Hopper (sm_90a).
//
// Replaces the JAX package's ops/megakernel.py::full_iteration_pallas for
// analytic scenes (spheres and boxes): one launch per iteration does
// raygen (pinhole, stratified 4x4 AA, thin-lens DoF), the min-t sweep over
// all geoms, the minstd RNG keyed on (iteration, pixelIndex, depth), every
// analytic lobe of the shader (diffuse, mirror, partial-reflective
// lottery, Phong glossy, Schlick refraction with TIR, Russian roulette,
// constant ENVLIGHT) and all trace_depth bounces, then adds each pixel's
// radiance straight into the caller's accumulator. Adding in place saves
// the 3*P float read and write of a separate accumulate per iteration.
//
// Design: one thread per pixel (pix = x + y*resx), bounds-checked instead
// of the TPU kernel's 1024-lane padding, with the path state (origin,
// direction, throughput, radiance, alive) in registers across bounces. A
// dead path leaves the depth loop: nothing it holds changes after death.
// Geoms are swept at run time in geom-index order with the strict-<
// update, reading the (G,16) matrices through the read-only data cache
// (every thread of a warp reads the same address, so the load is a
// broadcast). Materials are indexed directly by mat_id.
//
// What bounds it on the H100: arithmetic and warp divergence, not bytes.
// It writes 12 B per pixel per iteration (and reads the same 12 B of the
// accumulator); everything else is a few KB of tables. This first design
// is one thread per path and nothing more: no path regeneration, no
// sorting by material, no wgmma or TMA (there is no matrix product here).
// Making it fast is later work.
//
// Numerics follow the plain PyTorch version (ops/megakernel.py::
// full_iteration_reference, which follows the JAX package's XLA path).
// Build without --use_fast_math: the slab test divides by direction
// components that can be 0 and relies on IEEE +-inf, and denormal
// flushing or approximate division would move results past the parity
// tolerance. FMA contraction and rsqrtf move results by an ulp or two.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kRayEps = 1e-4f;  // getPointOnRay backoff
constexpr float kFltMax = 3.402823466e38f;
constexpr float kPi = 3.1415926535897932384626422832795028841971f;
constexpr float kTwoPi = 6.2831853071795864769252867665590057683943f;
constexpr float kSqrtOneThird = 0.5773502691896257645091487805019574556476f;
// 2*RAY_EPS + 1e-3, rounded once to float as the plain version does
constexpr float kGlassPush = static_cast<float>(2.0 * 1e-4 + 1e-3);
constexpr uint32_t kLcgM = 2147483647u;  // 2^31 - 1
constexpr uint32_t kLcgA = 48271u;
constexpr float kInvM1 = static_cast<float>(1.0 / 2147483646.0);
constexpr uint32_t kRaygenStream = 255u;
constexpr int kMatCols = 11;  // see ops/megakernel.py::pack_scene_tables

// settings / scene-class flags (ops/megakernel.py::_kernel_flags)
constexpr int kAntialias = 1;
constexpr int kDof = 2;
constexpr int kPartialRefl = 4;
constexpr int kRefractive = 8;
constexpr int kRussianRoulette = 16;
constexpr int kGlossy = 32;
constexpr int kEnvConst = 64;

constexpr int kSphere = 0;  // models/scene.py::GeomType

struct Params {
  const float* xf;    // (G,16) row-major 4x4 transforms
  const float* inv;   // (G,16) inverses
  const float* invt;  // (G,16) inverse transposes
  const int* gtype;   // (G,)
  const int* gmat;    // (G,) material ids
  int n_geoms;
  const float* mat;   // (M,kMatCols)
  const float* cam;   // (16,) pos, view, up, right, pixel_length, aperture, focal
  const float* env;   // (3,) constant environment radiance
  float* acc_r;       // (P,) accumulators, added to in place
  float* acc_g;
  float* acc_b;
  int iteration;      // 1-based
  int resx, resy, depth, rr_start, flags;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize(V3 a) {
  const float inv = rsqrtf(dot(a, a) + 1e-30f);
  return a * inv;
}
__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// ---- RNG: bit-exact with ops/rng.py (src/intersections.h:12-20,
// src/pathtrace.cu:41-45) ----
__device__ __forceinline__ uint32_t utilhash(uint32_t a) {
  a = (a + 0x7ED55D16u) + (a << 12);
  a = (a ^ 0xC761C23Cu) ^ (a >> 19);
  a = (a + 0x165667B1u) + (a << 5);
  a = (a + 0xD3A2646Cu) ^ (a << 9);
  a = (a + 0xFD7046C5u) + (a << 3);
  a = (a ^ 0xB55A4F09u) ^ (a >> 16);
  return a;
}

__device__ __forceinline__ uint32_t lcg_seed(uint32_t it, uint32_t depth, uint32_t pix) {
  const uint32_t h = utilhash((1u << 31) | (depth << 22) | it) ^ utilhash(pix);
  uint32_t s = (h >> 31) + (h & 0x7FFFFFFFu);
  if (s >= kLcgM) s -= kLcgM;
  return s == 0u ? 1u : s;
}

// division-free minstd step, the same split-and-fold as ops/rng.py
__device__ __forceinline__ uint32_t lcg_next(uint32_t x) {
  const uint32_t a = (x >> 16) * kLcgA;
  const uint32_t b = (x & 0xFFFFu) * kLcgA;
  uint32_t s = (a >> 15) + ((a & 0x7FFFu) << 16) + (b >> 31) + (b & 0x7FFFFFFFu);
  s = (s >> 31) + (s & 0x7FFFFFFFu);
  if (s >= kLcgM) s -= kLcgM;
  return s;
}

__device__ __forceinline__ float lcg_uniform(uint32_t s) {
  return (static_cast<float>(static_cast<int>(s)) - 1.0f) * kInvM1;
}

// n (<= 5) sequential draws of the (iteration, pix, depth) stream
__device__ __forceinline__ void draw(uint32_t it, uint32_t depth, uint32_t pix, int n,
                                     float* u) {
  uint32_t s = lcg_seed(it, depth, pix);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k < n) {
      s = lcg_next(s);
      u[k] = lcg_uniform(s);
    }
  }
}

// ---- instance transforms: rows 0-2 of a row-major 4x4 ----
__device__ __forceinline__ V3 xform_point(const float* __restrict__ m, V3 p) {
  return {__ldg(m + 0) * p.x + __ldg(m + 1) * p.y + __ldg(m + 2) * p.z + __ldg(m + 3),
          __ldg(m + 4) * p.x + __ldg(m + 5) * p.y + __ldg(m + 6) * p.z + __ldg(m + 7),
          __ldg(m + 8) * p.x + __ldg(m + 9) * p.y + __ldg(m + 10) * p.z + __ldg(m + 11)};
}

__device__ __forceinline__ V3 xform_dir(const float* __restrict__ m, V3 d) {
  return {__ldg(m + 0) * d.x + __ldg(m + 1) * d.y + __ldg(m + 2) * d.z,
          __ldg(m + 4) * d.x + __ldg(m + 5) * d.y + __ldg(m + 6) * d.z,
          __ldg(m + 8) * d.x + __ldg(m + 9) * d.y + __ldg(m + 10) * d.z};
}

// boxIntersectionTest (src/intersections.h:48-90). Returns the world
// distance or -1; the normal and outside flag only when want_normal.
__device__ float box_test(const float* __restrict__ xf, const float* __restrict__ inv, V3 o,
                          V3 d, bool want_normal, V3* n_out, bool* outside) {
  const V3 qo = xform_point(inv, o);
  const V3 qd = normalize(xform_dir(inv, d));
  const float o3[3] = {qo.x, qo.y, qo.z};
  const float d3[3] = {qd.x, qd.y, qd.z};
  float ta[3], tb[3], sg[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // IEEE division: a zero direction component gives +-inf
    const float t1 = (-0.5f - o3[a]) / d3[a];
    const float t2 = (0.5f - o3[a]) / d3[a];
    ta[a] = fminf(t1, t2);
    tb[a] = fmaxf(t1, t2);
    sg[a] = t2 < t1 ? 1.0f : -1.0f;
  }
  const float tax = ta[0] > 0.0f ? ta[0] : -kFltMax;
  const float tay = ta[1] > 0.0f ? ta[1] : -kFltMax;
  const float taz = ta[2] > 0.0f ? ta[2] : -kFltMax;
  const float tmin = fmaxf(tax, fmaxf(tay, taz));
  const float tmax = fminf(tb[0], fminf(tb[1], tb[2]));
  const bool hit = (tmax >= tmin) && (tmax > 0.0f);
  if (!hit) return -1.0f;
  const bool inside = tmin <= 0.0f;
  const float t_obj = inside ? tmax : tmin;
  const V3 p_obj = qo + qd * (t_obj - kRayEps);
  const V3 p_world = xform_point(xf, p_obj);
  const V3 diff = o - p_world;
  const float dist = sqrtf(dot(diff, diff));
  if (want_normal) {
    // entering face (slab of tmin) or, from inside, exit face (tmax)
    bool wx, wy;
    if (inside) {
      wx = tmax == tb[0];
      wy = !wx && (tmax == tb[1]);
    } else {
      wx = tmin == tax;
      wy = !wx && (tmin == tay);
    }
    const V3 n_obj = {wx ? sg[0] : 0.0f, wy ? sg[1] : 0.0f, (wx || wy) ? 0.0f : sg[2]};
    // box normals via `transform`, as the reference does (:86)
    *n_out = normalize(xform_dir(xf, n_obj));
    *outside = !inside;
  }
  return dist;
}

// sphereIntersectionTest (src/intersections.h:102-144)
__device__ float sphere_test(const float* __restrict__ xf, const float* __restrict__ inv,
                             const float* __restrict__ invt, V3 o, V3 d, bool want_normal,
                             V3* n_out, bool* outside) {
  const V3 ro = xform_point(inv, o);
  const V3 rd = normalize(xform_dir(inv, d));
  const float vdd = dot(ro, rd);
  const float radicand = vdd * vdd - (dot(ro, ro) - 0.25f);
  const float sq = sqrtf(fmaxf(radicand, 0.0f));
  const float t1 = -vdd + sq;
  const float t2 = -vdd - sq;
  const bool both_neg = (t1 < 0.0f) && (t2 < 0.0f);
  const bool both_pos = (t1 > 0.0f) && (t2 > 0.0f);
  if (!(radicand >= 0.0f) || both_neg) return -1.0f;
  const float t_obj = both_pos ? fminf(t1, t2) : fmaxf(t1, t2);
  const V3 p_obj = ro + rd * (t_obj - kRayEps);
  const V3 p_world = xform_point(xf, p_obj);
  const V3 diff = o - p_world;
  const float dist = sqrtf(dot(diff, diff));
  if (want_normal) {
    *n_out = normalize(xform_dir(invt, p_obj)) * (both_pos ? 1.0f : -1.0f);
    *outside = both_pos;
  }
  return dist;
}

__device__ __forceinline__ float geom_test(const Params& p, int g, V3 o, V3 d, bool want_normal,
                                           V3* n, bool* outside) {
  const float* xf = p.xf + 16 * g;
  const float* inv = p.inv + 16 * g;
  if (__ldg(p.gtype + g) == kSphere) {
    return sphere_test(xf, inv, p.invt + 16 * g, o, d, want_normal, n, outside);
  }
  return box_test(xf, inv, o, d, want_normal, n, outside);
}

// two unit tangents of `axis` (not-the-normal trick, src/interactions.h:24-31)
__device__ __forceinline__ void tangent_frame(V3 axis, V3* t1, V3* t2) {
  const bool use_x = fabsf(axis.x) < kSqrtOneThird;
  const bool use_y = !use_x && (fabsf(axis.y) < kSqrtOneThird);
  const V3 na = {use_x ? 1.0f : 0.0f, use_y ? 1.0f : 0.0f, (use_x || use_y) ? 0.0f : 1.0f};
  *t1 = normalize(cross(axis, na));
  *t2 = normalize(cross(axis, *t1));
}

// calculateRandomDirectionInHemisphere (src/interactions.h:10-42)
__device__ __forceinline__ V3 cosine_hemisphere(V3 n, float u1, float u2) {
  const float up = sqrtf(u1);
  const float over = sqrtf(fmaxf(1.0f - u1, 0.0f));
  const float around = u2 * kTwoPi;
  V3 p1, p2;
  tangent_frame(n, &p1, &p2);
  return n * up + p1 * (cosf(around) * over) + p2 * (sinf(around) * over);
}

__global__ void __launch_bounds__(128) full_iteration_kernel(const Params p) {
  const int n_pixels = p.resx * p.resy;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pixels) return;
  const uint32_t it = static_cast<uint32_t>(p.iteration);
  const uint32_t upix = static_cast<uint32_t>(pix);

  // ---- raygen (ops/camera.py::generate_rays) ----
  const float* c = p.cam;
  const V3 pos = {__ldg(c + 0), __ldg(c + 1), __ldg(c + 2)};
  const V3 view = {__ldg(c + 3), __ldg(c + 4), __ldg(c + 5)};
  const V3 cup = {__ldg(c + 6), __ldg(c + 7), __ldg(c + 8)};
  const V3 right = {__ldg(c + 9), __ldg(c + 10), __ldg(c + 11)};
  float x = static_cast<float>(pix % p.resx);
  float y = static_cast<float>(pix / p.resx);
  float ucam[5];
  if (p.flags & (kAntialias | kDof)) draw(it, kRaygenStream, upix, 4, ucam);
  if (p.flags & kAntialias) {
    // stratum (iteration-1) mod 16 of a 4x4 grid
    const int s = ((p.iteration - 1) % 16 + 16) % 16;
    x = x + (static_cast<float>(s % 4) + ucam[0]) * 0.25f - 0.5f;
    y = y + (static_cast<float>(s / 4) + ucam[1]) * 0.25f - 0.5f;
  }
  const float sx = __ldg(c + 12) * (x - static_cast<float>(p.resx) * 0.5f);
  const float sy = __ldg(c + 13) * (y - static_cast<float>(p.resy) * 0.5f);
  V3 dir = normalize(view - right * sx - cup * sy);
  V3 org = pos;
  if (p.flags & kDof) {
    // concentric disk (PBRT 6.2.3) on the aperture, re-aimed at the
    // focal plane
    const float aperture = __ldg(c + 14);
    const float focal = __ldg(c + 15);
    const float a2 = 2.0f * ucam[2] - 1.0f;
    const float b2 = 2.0f * ucam[3] - 1.0f;
    float lx = 0.0f, ly = 0.0f;
    if (!(a2 == 0.0f && b2 == 0.0f)) {
      float r, theta;
      if (fabsf(a2) > fabsf(b2)) {
        r = fabsf(a2);
        theta = (kPi / 4.0f) * (b2 / a2);
      } else {
        r = fabsf(b2);
        theta = (kPi / 2.0f) - (kPi / 4.0f) * (a2 / b2);
      }
      lx = r * cosf(theta);
      ly = r * sinf(theta);
    }
    const float ft = focal / fmaxf(dot(dir, view), 1e-6f);
    const V3 focus = org + dir * ft;
    org = org + (right * (aperture * lx) + cup * (aperture * ly));
    dir = normalize(focus - org);
  }

  // scene-specialised draw slots (ops/megakernel.py::draw_slots)
  int n_draws = 2;
  const int slot_branch = (p.flags & kPartialRefl) ? n_draws++ : -1;
  const int slot_fresnel = (p.flags & kRefractive) ? n_draws++ : -1;
  const int slot_rr = (p.flags & kRussianRoulette) ? n_draws++ : -1;

  V3 thr = {1.0f, 1.0f, 1.0f};
  V3 rad = {0.0f, 0.0f, 0.0f};

  for (int depth = 0; depth < p.depth; ++depth) {
    // ---- min-t sweep in geom-index order, strict < (earlier geom wins
    // a tie); the winner's normal is computed once afterwards ----
    float best_t = -1.0f;
    int best_g = -1;
    for (int g = 0; g < p.n_geoms; ++g) {
      const float t = geom_test(p, g, org, dir, false, nullptr, nullptr);
      const float prev = best_t > 0.0f ? best_t : kFltMax;
      if (t > 0.0f && prev > t) {
        best_t = t;
        best_g = g;
      }
    }
    if (best_g < 0) {
      // escaped: collect the environment, then die
      if (p.flags & kEnvConst) {
        rad = rad + thr * V3{__ldg(p.env + 0), __ldg(p.env + 1), __ldg(p.env + 2)};
      }
      break;
    }
    V3 n;
    bool outside;
    geom_test(p, best_g, org, dir, true, &n, &outside);

    const float* m = p.mat + kMatCols * __ldg(p.gmat + best_g);
    const V3 color = {__ldg(m + 0), __ldg(m + 1), __ldg(m + 2)};
    const V3 spec = {__ldg(m + 3), __ldg(m + 4), __ldg(m + 5)};
    const float refl = __ldg(m + 6);
    const float refr = __ldg(m + 7);
    const float ior = __ldg(m + 8);
    const float emit = __ldg(m + 9);
    const float sexp = __ldg(m + 10);

    if (emit > 0.0f) {
      // light hit: contribute and terminate (src/pathtrace.cu:247-249)
      rad = rad + thr * (color * emit);
      break;
    }

    float u[5];
    draw(it, static_cast<uint32_t>(depth), upix, n_draws, u);
    const V3 p_hit = org + dir * (best_t - kRayEps);

    // mirror direction, or a Phong-glossy sample around it (kept only
    // above the surface)
    const float d_dot_n = dot(dir, n);
    V3 spec_dir = dir - n * (2.0f * d_dot_n);
    if ((p.flags & kGlossy) && sexp > 0.0f) {
      const float cos_t = powf(u[0], 1.0f / (sexp + 1.0f));
      const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
      const float phi = u[1] * kTwoPi;
      V3 g1, g2;
      tangent_frame(spec_dir, &g1, &g2);
      const V3 gl = spec_dir * cos_t + g1 * (cosf(phi) * sin_t) + g2 * (sinf(phi) * sin_t);
      if (dot(gl, n) > 0.0f) spec_dir = gl;
    }

    V3 new_dir, tint;
    V3 new_org = p_hit;
    if (refr > 0.0f && slot_fresnel >= 0) {
      // Schlick Fresnel lottery; TIR always reflects
      const float eta = outside ? 1.0f / fmaxf(ior, 1e-6f) : ior;
      const float cos_c = clamp01(-d_dot_n);
      const float ior_c = fmaxf(ior, 1.0f);
      const float q = (1.0f - ior_c) / (1.0f + ior_c);
      const float r0 = q * q;
      const float mth = clamp01(1.0f - cos_c);
      const float fresnel = r0 + (1.0f - r0) * mth * mth * mth * mth * mth;
      const float cos_i = -d_dot_n;
      const float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
      const bool do_reflect = (k < 0.0f) || (u[slot_fresnel] < fresnel);
      if (do_reflect) {
        new_dir = spec_dir;
        tint = spec;
      } else {
        const V3 refr_dir = dir * eta + n * (eta * cos_i - sqrtf(fmaxf(k, 0.0f)));
        new_dir = normalize(refr_dir);
        tint = color;
        // push the refracted ray through the interface
        new_org = p_hit + new_dir * kGlassPush;
      }
    } else if (refl > 0.0f) {
      if (slot_branch >= 0) {
        // partial reflectance: pick a lobe, divide by its probability
        const float p_spec = clamp01(refl);
        if (u[slot_branch] < p_spec) {
          new_dir = spec_dir;
          tint = spec * (1.0f / fmaxf(p_spec, 1e-6f));
        } else {
          new_dir = cosine_hemisphere(n, u[0], u[1]);
          tint = color * (1.0f / fmaxf(1.0f - p_spec, 1e-6f));
        }
      } else {
        new_dir = spec_dir;
        tint = spec;
      }
    } else {
      new_dir = cosine_hemisphere(n, u[0], u[1]);
      tint = color;
    }
    new_dir = normalize(new_dir);

    thr = thr * tint;
    if (slot_rr >= 0 && depth >= p.rr_start) {
      // Russian roulette: survive with p = max component, compensate
      const float p_surv =
          fminf(fmaxf(fmaxf(thr.x, fmaxf(thr.y, thr.z)), 0.05f), 1.0f);
      thr = thr * (1.0f / p_surv);
      if (u[slot_rr] >= p_surv) break;
    }
    org = new_org;
    dir = new_dir;
  }

  p.acc_r[pix] += rad.x;
  p.acc_g[pix] += rad.y;
  p.acc_b[pix] += rad.z;
}

}  // namespace

// Launches one iteration on `stream` (a cudaStream_t, PyTorch's current
// stream) of CUDA device `device`. Returns cudaGetLastError() of the launch.
extern "C" int pt_full_iteration(const float* xf, const float* inv, const float* invt,
                                 const int* gtype, const int* gmat, int n_geoms,
                                 const float* mat, const float* cam, const float* env,
                                 float* acc_r, float* acc_g, float* acc_b, int iteration,
                                 int resx, int resy, int depth, int rr_start, int flags,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.xf = xf;
  p.inv = inv;
  p.invt = invt;
  p.gtype = gtype;
  p.gmat = gmat;
  p.n_geoms = n_geoms;
  p.mat = mat;
  p.cam = cam;
  p.env = env;
  p.acc_r = acc_r;
  p.acc_g = acc_g;
  p.acc_b = acc_b;
  p.iteration = iteration;
  p.resx = resx;
  p.resy = resy;
  p.depth = depth;
  p.rr_start = rr_start;
  p.flags = flags;
  const int threads = 128;
  const int n_pixels = resx * resy;
  const int blocks = (n_pixels + threads - 1) / threads;
  if (blocks > 0) {
    full_iteration_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
