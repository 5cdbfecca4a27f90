// NEE + MIS path-tracing kernels for Hopper (sm_90a):
//
//   #5 bounce_step_nee_kernel replaces ops/megakernel.py::bounce_step_pallas_nee:
//      one NEE + MIS bounce over the pool, in place, the MIS aux
//      (prev_pdf, prev_nondelta) riding as two more float lanes.
//   #6 full_iteration_nee_kernel replaces ops/megakernel.py::full_iteration_nee_pallas:
//      raygen and every bounce of the estimator for a run of iterations
//      in one launch, each pixel's radiance added into the caller's
//      accumulator iteration after iteration.
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
// What bounds them on the H100: arithmetic and warp divergence, not bytes.
// Per live lane and bounce they do about twice #1's work: the nearest-hit
// sweep, the light sample, and a second sweep for the shadow ray (it
// stops at the first occluder, and only lanes that can take the light
// sample cast it). #6 moves 24 B per pixel per iteration (the
// accumulator); #5 reads 16 lanes and writes 15 per live lane (124 B).
// With one thread per path, a lane whose path has ended idles until its
// warp's longest path ends (#6), and a lane whose slot is dead idles
// while its warp's live lanes bounce (#5).
//
// Design: persistent warps (as many blocks as stay resident, computed once
// per device), each warp keeping all 32 lanes on live paths.
// - #6 is kernel #1's design (csrc/full_iteration.cu) with the MIS aux:
//   each lane holds one path (pixel, iteration, depth, path, aux) and the
//   pixel's running sum in registers; when its path ends it adds the
//   radiance to the sum, as the plain version adds one iteration after
//   another, and starts the pixel's next iteration with the aux reset to
//   (0, 0); after the pixel's last iteration it stores the sum and takes
//   the next pixel from a device-side counter (a ballot of the lanes that
//   need one, one atomicAdd per warp, a shuffle of the base). A lane's
//   step is ONE sweep over the geoms: its path's nearest-hit sweep, or its
//   vertex's shadow ray (`shade_nee` split at the shadow test: the arrival
//   and the light sample in one step, the light term and the continuation
//   in the next), both in one loop, so the lanes casting shadow rays and
//   the lanes tracing their paths sweep together instead of the shadow
//   rays running after every bounce while the other lanes wait. The light
//   term is kept as (term, scale) and added as `shade_nee` adds it.
// - #5 packs the pool's live slots into full warps: a warp takes chunks of
//   kChunk slots from a device-side counter, reads each 32 of their alive
//   words coalesced, and queues the live slots in two registers a lane
//   (lane j holds the queue's j-th slot, and its (32 + j)-th while the
//   queue holds more than 32: a ballot, then each lane pulls its slot with
//   `__fns`); it runs the bounce when all 32 lanes have a slot, and once
//   more for the rest when the pool is exhausted. A slot dead on entry is
//   read only for its alive word and never written.
// The RNG is keyed on (iteration, pixelIndex, depth), never on the lane,
// and each slot's or pixel's arithmetic is the thread-per-path kernels'
// (path_common.cuh's NEE pieces, the pdf's dot products with their
// rounding named), so which lane runs it, and in which step, changes no
// bit: both were held bit for bit against the thread-per-path kernels
// they replace (tools/torch_nee_ab.py), and chip_smoke.py holds #6 bit
// for bit against #5's route on every pixel whose camera ray the plain
// raygen reproduces (`nee_route_bits`).
// The NEE code is reached only from these two kernels, so #1-#4 compile
// as they did. Each kernel is a template on its tables: a scene with file
// textures, bump maps, a lat-long env map or SSS runs its instantiation on
// TexTables, which compiles path_common.cuh's surface stage (the albedo,
// the shading normal and the environment are the stage's at every term,
// and a subsurface vertex takes no light sample); the one on Tables
// compiles none of it. No matrix product here, so no wgmma or TMA.

#include <algorithm>

#include "path_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 256;  // #5: pool slots per fetch from the counter

// #6. A lane's step is one sweep: its path's nearest-hit sweep, or its
// vertex's shadow ray. The bounce is `shade_nee` (path_common.cuh) split
// at the shadow test, each expression as there: the arrival, the vertex
// and the light sample in the nearest-hit step; the light term and the
// continuation (`scatter`, the next aux) in the shadow step, or in the
// same step when the vertex casts no shadow ray. (The same split written
// as shared pieces that `shade_nee` also calls compiled to other roundings
// here, an ulp off on 2-7% of the accumulator's values: so it stays
// written out once more, and chip_smoke.py's `nee_route_bits` holds it
// bit for bit against `shade_nee` as #5 runs it.) 6 blocks of kThreads
// stay resident on an SM at its 80 registers; naming that minimum (ptxas
// spills a few bytes) was faster on the H100 than 90 registers at 5
// blocks.
template <class T>
__global__ void __launch_bounds__(kThreads, 6)
    full_iteration_nee_kernel(const T s, const Lights L, const float* __restrict__ cam,
                              float* acc_r, float* acc_g, float* acc_b, int iteration0,
                              int n_iters, int resx, int resy, int depth,
                              int* __restrict__ counter) {
  const int n_pixels = resx * resy;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  bool need = true;    // this lane has no pixel
  bool done = false;   // the pixels ran out for this lane
  bool fresh = false;  // the lane's next step starts a path
  bool shadow = false;  // the lane's next step sweeps its vertex's shadow ray
  int pix = 0, k = 0, d = 0;  // pixel, its iteration (from iteration0), depth
  V3 sum = {0.0f, 0.0f, 0.0f};  // acc[pix] plus the pixel's paths so far
  Path p;
  NeeAux a;
  Hit h;                  // the vertex, kept over its shadow step
  V3 p_hit, wi, contrib;  // its point, the shadow ray's direction, and
  float scale = 0.0f;     // the light term contrib * scale
  float bound = 0.0f;     // the shadow ray's length less 1e-2
  for (;;) {
    // each lane without a pixel takes the next one: one atomicAdd per warp
    const unsigned want = __ballot_sync(kFull, need);
    if (want) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(counter, __popc(want));
      base = __shfl_sync(kFull, base, leader);
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
    if (!__any_sync(kFull, !done)) break;
    if (done) continue;
    const int iteration = iteration0 + k;
    const uint32_t it = static_cast<uint32_t>(iteration);
    if (fresh) {
      raygen(cam, pix, resx, resy, iteration, s.flags, &p.org, &p.dir);
      p.thr = {1.0f, 1.0f, 1.0f};
      p.rad = {0.0f, 0.0f, 0.0f};
      a = NeeAux{0.0f, 0.0f};
      d = 0;
      fresh = false;
      shadow = false;
    }
    bool ends = d >= depth;
    if (!ends) {
      // the step's sweep: the nearest hit of the path's ray, or any hit of
      // the shadow ray below its bound (path_common.cuh `intersect` and
      // `unoccluded`, one loop)
      const V3 ro = shadow ? p_hit : p.org;
      const V3 rd = shadow ? wi : p.dir;
      float best_t = -1.0f;
      int best_g = -1;
      bool blocked = false;
      for (int g = 0; g < s.n_geoms; ++g) {
        const float t = geom_test(s, g, ro, rd, false, nullptr, nullptr);
        if (shadow) {
          if (t > 0.0f && t < bound) {
            blocked = true;
            break;
          }
        } else {
          const float prev = best_t > 0.0f ? best_t : kFltMax;
          if (t > 0.0f && prev > t) {
            best_t = t;
            best_g = g;
          }
        }
      }
      const bool is_last = d == depth - 1;
      bool vertex = true;  // a non-emissive hit to shade in this step
      if (!shadow) {
        h.t = best_t;
        h.n = {0.0f, 0.0f, 0.0f};
        h.mat = -1;
        h.outside = true;
        if (best_g >= 0) {
          geom_test(s, best_g, p.org, p.dir, true, &h.n, &h.outside);
          h.mat = __ldg(s.gmat + best_g);
        }
        const NeeAux prev = a;
        a = NeeAux{0.0f, 0.0f};
        if (!(h.t > 0.0f)) {
          escape(s, p);
          ends = true;
          vertex = false;
        } else {
          p_hit = p.org + p.dir * (h.t - kRayEps);
          HitOf<T> he = h;  // the hit as shaded
          const Material me = surface(s, he, p_hit);
          if (me.emit > 0.0f) {
            float w_bsdf = 1.0f;
            if (prev.nondelta > 0.5f) {
              const float cos_l = fabsf(dot(he.n, p.dir));
              const float pdf_light = (h.t * h.t) / fmaxf(cos_l * L.aw, 1e-8f);
              const float pp = prev.pdf * prev.pdf;
              w_bsdf = pp / fmaxf(pp + pdf_light * pdf_light, 1e-20f);
            }
            p.rad = p.rad + p.thr * (me.color * me.emit) * w_bsdf;
            ends = true;
            vertex = false;
          }
        }
      }
      if (vertex) {
        // the vertex as shaded (the surface stage again in its shadow step:
        // h keeps the hit's own normal)
        HitOf<T> hs = h;
        const Material mt = surface(s, hs, p_hit);
        const V3 n = hs.n;
        const float p_mix = clamp01(mt.refl);
        const bool glossy_lobe = (s.flags & kGlossy) && p_mix > 0.0f && mt.sexp > 0.0f;
        bool nee_able = mt.refr <= 0.0f && (p_mix < 1.0f || glossy_lobe);
        if constexpr (T::kTex) nee_able = nee_able && !subsurface(s, mt);
        const V3 mirror = p.dir - n * (2.0f * dot(p.dir, n));
        bool go_on = true;  // the vertex continues in this step
        if (shadow) {
          if (!blocked) p.rad = p.rad + contrib * scale;
          shadow = false;
        } else if (nee_able) {
          float ul[5];
          draw(it, kNeeDepthBase + static_cast<uint32_t>(d), static_cast<uint32_t>(pix), 3, ul);
          LightSample ls;
          if (sample_light(s, L, ul[0], ul[1], ul[2], &ls)) {
            const V3 to_l = ls.p - p_hit;
            const float r2 = fmaxf(dot(to_l, to_l), 1e-8f);
            const float r = sqrtf(r2);
            wi = to_l * (1.0f / r);
            const float cos_s = fmaxf(dot(n, wi), 0.0f);
            const float cos_l = fmaxf(-dot(ls.n, wi), 0.0f);
            if (cos_s > 0.0f && cos_l > 0.0f) {
              float pdf_lobe = 0.0f;
              if (glossy_lobe) {
                const float cos_a = fmaxf(dot(mirror, wi), 0.0f);
                pdf_lobe = (mt.sexp + 1.0f) * kHalfInvPi * powf(cos_a, mt.sexp);
              }
              float w_light = 1.0f;
              if (!is_last) {
                const float pl = r2 / fmaxf(cos_l * L.aw, 1e-8f);
                const float pb = (1.0f - p_mix) * cos_s * kInvPi + p_mix * pdf_lobe;
                w_light = (pl * pl) / fmaxf(pl * pl + pb * pb, 1e-20f);
              }
              const float g_geo = cos_s * cos_l / r2 * ls.weight;
              const V3 f_diff = mt.color * ((1.0f - p_mix) * kInvPi);
              const float f_spec = p_mix * pdf_lobe / fmaxf(cos_s, 1e-6f);
              const V3 f_mix = f_diff + mt.spec * f_spec;
              contrib = p.thr * f_mix * ls.le;
              scale = g_geo * w_light;
              bound = r - 1e-2f;
              shadow = true;
              go_on = false;
            }
          }
        }
        if (go_on) {
          if (is_last || !scatter(s, p, hs, mt, p_hit, it, d, static_cast<uint32_t>(pix))) {
            ends = true;
          } else {
            const float m_dot = dot_fma(mirror, p.dir);
            float next_pdf = (1.0f - p_mix) * fmaxf(dot_fma(n, p.dir), 0.0f) * kInvPi;
            if (s.flags & kGlossy) {
              const float lobe = glossy_lobe
                                     ? (mt.sexp + 1.0f) * kHalfInvPi *
                                           powf(fmaxf(m_dot, 0.0f), mt.sexp)
                                     : 0.0f;
              next_pdf = next_pdf + p_mix * lobe;
            }
            const bool mirror_pick = p_mix > 0.0f && !glossy_lobe && m_dot > kMirrorCos;
            a.pdf = next_pdf;
            a.nondelta = (nee_able && !mirror_pick) ? 1.0f : 0.0f;
            ++d;
          }
        }
      }
    }
    if (ends) {
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

// One NEE + MIS bounce of live slot i of the pool, in place: the
// thread-per-slot kernel's body.
template <class T>
__device__ __forceinline__ void nee_bounce_slot(const T& s, const Lights& L,
                                                const Lanes& pool, float* prev_pdf,
                                                float* prev_nondelta, int i, uint32_t it,
                                                int depth, bool is_last) {
  Path p = load_path(pool, i);
  NeeAux a = {prev_pdf[i], prev_nondelta[i]};
  const Hit h = intersect(s, p.org, p.dir);
  const bool alive =
      shade_nee(s, L, p, a, h, it, depth, static_cast<uint32_t>(pool.pix[i]), is_last);
  store_path(pool, i, p);
  pool.alive[i] = alive ? 1 : 0;
  prev_pdf[i] = a.pdf;
  prev_nondelta[i] = a.nondelta;
}

// #5. 6 blocks per SM at 80 registers (95 without the bound): 3% faster
// on many_materials 1080p RR, 7% slower on Cornell 800x800 AA, on the H100.
template <class T>
__global__ void __launch_bounds__(kThreads, 6)
    bounce_step_nee_kernel(const T s, const Lights L, const Lanes pool,
                           float* __restrict__ prev_pdf, float* __restrict__ prev_nondelta,
                           int n, int iteration, int depth, int is_last,
                           int* __restrict__ counter) {
  const int lane = threadIdx.x & 31;
  const uint32_t it = static_cast<uint32_t>(iteration);
  const bool last = is_last != 0;
  int queued = 0;      // live slots in the queue (the same in every lane)
  int q = 0;           // the queue's lane-th slot
  int o = 0;           // its (32 + lane)-th, while the queue holds more than 32
  int b = 0, end = 0;  // the next 32 slots of the warp's chunk, its end
  bool more = true;    // the counter may hand out more chunks
  for (;;) {
    while (more && queued < 32) {
      if (b >= end) {
        int base = 0;
        if (lane == 0) base = atomicAdd(counter, kChunk);
        base = __shfl_sync(kFull, base, 0);
        more = base < n;
        if (!more) break;
        b = base;
        end = min(base + kChunk, n);
      }
      const int i = b + lane;
      const unsigned live = __ballot_sync(kFull, i < end && pool.alive[i] != 0);
      const int c = __popc(live);
      // lane j takes the (j - queued)-th live slot of these 32, and the
      // (j + 32 - queued)-th into its overflow
      const int r = lane - queued;
      if (r >= 0 && r < c) q = b + static_cast<int>(__fns(live, 0, r + 1));
      if (r + 32 < c) o = b + static_cast<int>(__fns(live, 0, r + 33));
      queued += c;
      b += 32;
    }
    if (queued == 0) break;
    // all 32 lanes, or the last slots once the pool is exhausted
    if (lane < queued) nee_bounce_slot(s, L, pool, prev_pdf, prev_nondelta, q, it, depth, last);
    q = o;
    queued = max(queued - 32, 0);
  }
}

inline Lights make_lights(void* const* tables, int n_lights, float aw) {
  Lights L;
  L.idx = static_cast<const int*>(tables[7]);
  L.n = n_lights;
  L.aw = aw;
  return L;
}

int g_resident_nee[64];     // #6's resident blocks per device, 0 until queried
int g_resident_bounce[64];  // #5's
int g_resident_nee_tex[64];     // their instantiations on TexTables'
int g_resident_bounce_tex[64];

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t,
// PyTorch's current stream) of CUDA device `device` and returns
// cudaGetLastError() of the launch, or the occupancy query's error: the
// kernel's instantiation on TexTables when flags has a kSurfaceStage bit.
// tables = {xf, inv, invt, gtype, gmat, mat, env, lights, surf, tex, bump,
// envmap}; aw = the MIS
// light pdf model (mean light area x n_lights); counter: one int32 on the
// device, zero before the launch and used by no other launch.

// pool = 16 pointers: the 12 float lanes, alive, pix, prev_pdf, prev_nondelta.
extern "C" int pt_bounce_step_nee(void* const* tables, int n_geoms, int n_lights, float aw,
                                  void* const* pool, int n, int iteration, int depth,
                                  int is_last, int rr_start, int flags, int* counter,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Lights L = make_lights(tables, n_lights, aw);
    float* pdf = static_cast<float*>(pool[14]);
    float* nondelta = static_cast<float*>(pool[15]);
    // one warp per chunk at most
    const int wanted = n_blocks(((n + kChunk - 1) / kChunk) * 32);
    int resident = 0;
    if (flags & kSurfaceStage) {
      err = resident_blocks(bounce_step_nee_kernel<TexTables>, device, g_resident_bounce_tex,
                            &resident);
      if (err != cudaSuccess) return static_cast<int>(err);
      bounce_step_nee_kernel<<<std::min(resident, wanted), kThreads, 0, st>>>(
          make_tex_tables(tables, n_geoms, flags, rr_start), L, make_lanes(pool), pdf, nondelta,
          n, iteration, depth, is_last, counter);
    } else {
      err = resident_blocks(bounce_step_nee_kernel<Tables>, device, g_resident_bounce, &resident);
      if (err != cudaSuccess) return static_cast<int>(err);
      bounce_step_nee_kernel<<<std::min(resident, wanted), kThreads, 0, st>>>(
          make_tables(tables, n_geoms, flags, rr_start), L, make_lanes(pool), pdf, nondelta, n,
          iteration, depth, is_last, counter);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Iterations iteration0 .. iteration0 + n_iters - 1; acc = {r, g, b}.
extern "C" int pt_full_iteration_nee(void* const* tables, int n_geoms, int n_lights, float aw,
                                     const float* cam, float* const* acc, int iteration0,
                                     int n_iters, int resx, int resy, int depth, int rr_start,
                                     int flags, int* counter, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pixels = resx * resy;
  if (n_pixels > 0 && n_iters > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Lights L = make_lights(tables, n_lights, aw);
    int resident = 0;
    if (flags & kSurfaceStage) {
      err = resident_blocks(full_iteration_nee_kernel<TexTables>, device, g_resident_nee_tex,
                            &resident);
      if (err != cudaSuccess) return static_cast<int>(err);
      full_iteration_nee_kernel<<<std::min(resident, n_blocks(n_pixels)), kThreads, 0, st>>>(
          make_tex_tables(tables, n_geoms, flags, rr_start), L, cam, acc[0], acc[1], acc[2],
          iteration0, n_iters, resx, resy, depth, counter);
    } else {
      err = resident_blocks(full_iteration_nee_kernel<Tables>, device, g_resident_nee, &resident);
      if (err != cudaSuccess) return static_cast<int>(err);
      full_iteration_nee_kernel<<<std::min(resident, n_blocks(n_pixels)), kThreads, 0, st>>>(
          make_tables(tables, n_geoms, flags, rr_start), L, cam, acc[0], acc[1], acc[2],
          iteration0, n_iters, resx, resy, depth, counter);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
