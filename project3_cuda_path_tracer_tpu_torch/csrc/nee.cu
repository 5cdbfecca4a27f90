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
//
// A scene with mesh geoms runs the instantiations on MeshOf<Tables> or
// MeshOf<TexTables>: the same tables, the mesh tables of
// ops/megakernel.py (the triangles and the binary BVH's boxes) and, packed
// for these two kernels only, the BVH's `node` rows and each mesh geom's
// root (pack_nee_bvh). The analytic sweep skips the mesh
// geoms; then each mesh geom's binary BVH is walked for the same ray, as
// the plain ops/bvh_traverse.py::mesh_intersect_bvh walks it: one int
// cursor over the geom's preorder nodes, hit ? (leaf ? test its <= 4
// triangles, go skip : i + 1) : skip, so no stack and no local memory.
// Nearest hit: the walk's object-space bound is the best world t so far
// times the Frobenius norm of inv's 3x3 (a bound on the object-space
// distance, as #7's candidacy), the least (t, triangle) in walk order
// wins the geom, its world distance is taken as mesh_common.cuh's
// `epilogue` takes it, and it wins the lane only when strictly nearer
// (an exact tie goes to the analytic geom, as in the mesh pipeline);
// `epilogue` then runs once, on the winner, for the normal, the side and
// the UVs. Shadow ray: a triangle occludes when its world distance, taken
// the same way, lies in (0, r - 1e-2): the plain version's rule on the
// nearest hit's world t, tested per triangle (the walk prunes by the
// bound's object-space image and stops at the first occluder). The 80k
// triangle cap of the TPU kernels (a VMEM budget) has no counterpart: the
// walk covers every mesh geom, the big-mesh route's included, and any
// depth of tree. A per-thread walk of the 8-wide BVH (#8's tables, a stack
// in shared memory) visits fewer nodes (about 4.6 inner nodes and 1.5
// leaves against 35.7 nodes and 7.3 triangles on mesh.txt) but ran 6-35%
// slower on the H100: this walk is bound by issued instructions, not by
// its chain of dependent loads, and a wide node's eight slab tests cost
// what the binary walk's nodes did (PERF.md).

#include <algorithm>

#include "mesh_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 256;  // #5: pool slots per fetch from the counter
constexpr int kMeshGeom = 2;  // models/scene.py::GeomType.MESH

// ---- the mesh instantiations' tables and walks ----

// The tables of a mesh scene: T's, the mesh tables and the binary BVH.
template <class T>
struct MeshOf : T {
  MeshTables m;
  const int4* node;   // (B,) first triangle, count, skip, is_leaf
  const int2* roots;  // (M,) each mesh geom's first node and node count
};

template <class T>
struct IsMesh : std::false_type {};
template <class T>
struct IsMesh<MeshOf<T>> : std::true_type {};

// mesh[] = {tri, attr, box, geoms, chunk, super, node, roots}: the mesh
// tables of ops/megakernel.py::pack_mesh_tables and pack_nee_bvh
template <class T>
inline MeshOf<T> with_mesh(const T& base, void* const* mesh, int n_mesh) {
  MeshOf<T> s;
  static_cast<T&>(s) = base;
  s.m = make_mesh_tables(mesh, n_mesh);
  s.node = static_cast<const int4*>(mesh[6]);
  s.roots = static_cast<const int2*>(mesh[7]);
  return s;
}

// The world distance of the object-space hit at t on ray r from world
// origin o, as `epilogue` computes it.
__device__ __forceinline__ float world_distance(const Tables& s, int g, const ObjRay& r,
                                                float t, V3 o) {
  const V3 p_obj = r.o + r.d * (t - kRayEps);
  const V3 diff = o - xform_point(s.xf + 16 * g, p_obj);
  return sqrtf(dot(diff, diff));
}

// A ray's mesh winner: its world t (FLT_MAX for none), its mesh (-1 for
// none) and the walk's object-space winner there.
struct MeshWin {
  float t;
  int k;
  TriHit th;
};

// The walks of every mesh geom's binary BVH for the world ray (o, d), in
// mesh order. Nearest hit (!shadow): w->t enters as the analytic winner's
// world t (FLT_MAX on a miss); each geom's walk keeps the least (t,
// triangle) below the object-space image of w->t in walk order, and its
// world distance replaces w's when strictly less. Shadow ray: returns true
// at the first triangle whose world distance lies in (0, bound); w is not
// read. One loop for both, so #6's lanes of either kind walk together.
template <class T>
__device__ __forceinline__ bool mesh_walks(const MeshOf<T>& s, V3 o, V3 d, bool shadow,
                                           float bound, MeshWin* w) {
  for (int k = 0; k < s.m.n_mesh; ++k) {
    const int g = __ldg(s.m.geoms + k).x;
    const float* inv = s.inv + 16 * g;
    const ObjRay r = object_ray(inv, o, d);
    const float lim = shadow ? bound : w->t;
    TriHit th = {lim < kFltMax ? lim * frobenius3(inv) : kFltMax, -1, 0.0f, 0.0f};
    const int2 root = __ldg(s.roots + k);
    const int end = root.x + root.y;
    for (int i = root.x; i < end;) {
      const int4 nd = __ldg(s.node + i);
      if (!slab_enter(__ldg(s.m.box + 2 * i), __ldg(s.m.box + 2 * i + 1), r, th.t)) {
        i = nd.z;
      } else if (nd.w == 0) {
        ++i;
      } else {
        for (int j = 0; j < nd.y; ++j) {
          float t, u, v;
          if (tri_test(s.m, nd.x + j, r, &t, &u, &v) && t < th.t) {
            if (!shadow) {
              th = {t, nd.x + j, u, v};
            } else {
              const float dist = world_distance(s, g, r, t, o);
              if (dist > 0.0f && dist < bound) return true;
            }
          }
        }
        i = nd.z;
      }
    }
    if (!shadow && th.tri >= 0) {
      const float t = world_distance(s, g, r, th.t, o);
      if (t > 0.0f && t < w->t) *w = {t, k, th};
    }
  }
  return false;
}

// The lane's hit from the analytic winner (best_t, best_g) and the mesh
// winner w: `epilogue` on w's triangle when it has one (the world t, the
// oriented normal, the UVs), else the analytic winner's normal.
template <class T>
__device__ __forceinline__ HitOf<T> mesh_hit(const MeshOf<T>& s, V3 o, V3 d, float best_t,
                                             int best_g, const MeshWin& w) {
  HitOf<T> h;
  h.t = best_t;
  h.n = {0.0f, 0.0f, 0.0f};
  h.mat = -1;
  h.outside = true;
  if constexpr (T::kTex) {
    h.u = 0.0f;
    h.v = 0.0f;
    h.has_uv = false;
  }
  if (w.k >= 0) {
    const int4 mg = __ldg(s.m.geoms + w.k);
    const MeshHit mh =
        epilogue(s, s.m, mg.x, mg.w != 0, object_ray(s.inv + 16 * mg.x, o, d), w.th, o, d);
    h.t = mh.t;
    h.n = mh.n;
    h.outside = mh.outside;
    h.mat = __ldg(s.gmat + mg.x);
    if constexpr (T::kTex) {
      h.u = mh.u;
      h.v = mh.v;
      h.has_uv = mg.w != 0;
    }
  } else if (best_g >= 0) {
    geom_test(s, best_g, o, d, true, &h.n, &h.outside);
    h.mat = __ldg(s.gmat + best_g);
  }
  return h;
}

// A ray's MeshWin before the walks: the analytic winner's world t.
__device__ __forceinline__ MeshWin no_mesh_win(float best_t) {
  return {best_t > 0.0f ? best_t : kFltMax, -1, {kFltMax, -1, 0.0f, 0.0f}};
}

// path_common.cuh's `intersect` on a mesh scene (#5): the analytic sweep
// over the other geoms (the same order and strict-< rule), then the mesh
// walks.
template <class T>
__device__ __forceinline__ HitOf<T> intersect(const MeshOf<T>& s, V3 org, V3 dir) {
  float best_t = -1.0f;
  int best_g = -1;
  for (int g = 0; g < s.n_geoms; ++g) {
    if (__ldg(s.gtype + g) == kMeshGeom) continue;
    const float t = geom_test(s, g, org, dir, false, nullptr, nullptr);
    const float prev = best_t > 0.0f ? best_t : kFltMax;
    if (t > 0.0f && prev > t) {
      best_t = t;
      best_g = g;
    }
  }
  MeshWin w = no_mesh_win(best_t);
  mesh_walks(s, org, dir, false, 0.0f, &w);
  return mesh_hit(s, org, dir, best_t, best_g, w);
}

// path_common.cuh's `unoccluded` on a mesh scene (#5's `shade_nee` finds
// it by argument-dependent lookup): the analytic any-hit loop over the
// other geoms, then the mesh walks.
template <class T>
__device__ __forceinline__ bool unoccluded(const MeshOf<T>& s, V3 o, V3 d, float r) {
  const float bound = r - 1e-2f;
  for (int g = 0; g < s.n_geoms; ++g) {
    if (__ldg(s.gtype + g) == kMeshGeom) continue;
    const float t = geom_test(s, g, o, d, false, nullptr, nullptr);
    if (t > 0.0f && t < bound) return false;
  }
  MeshWin w = no_mesh_win(-1.0f);
  return !mesh_walks(s, o, d, true, bound, &w);
}

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
// blocks. On a mesh scene (MeshOf) the step's sweep skips the mesh geoms
// and then walks them (`mesh_walks`, for the path's nearest hit or the
// shadow ray, as #5's `intersect` and `unoccluded` do); the hit keeps a
// mesh winner's UVs over the vertex's shadow step (HitOf<T>). The mesh
// instantiations keep the bound, spilling 272-332 B: on the H100 they
// ran 3% and 12% slower on mesh.txt 800x800 AA at 5 and 4 blocks (96
// and 116-119 registers, spilling 92-120 B and none), 10% and 28% on
// mesh_big.
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
  // the vertex, kept over its shadow step (with a mesh winner's UVs on a
  // mesh scene's TexTables)
  typename std::conditional<IsMesh<T>::value, HitOf<T>, Hit>::type h;
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
        if constexpr (IsMesh<T>::value) {
          if (__ldg(s.gtype + g) == kMeshGeom) continue;
        }
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
      if constexpr (IsMesh<T>::value) {
        // the mesh walks of the step's ray: the shadow lanes' and the
        // path lanes' in one loop
        MeshWin w = no_mesh_win(best_t);
        if (!blocked && mesh_walks(s, ro, rd, shadow, bound, &w)) blocked = true;
        if (!shadow) h = mesh_hit(s, p.org, p.dir, best_t, best_g, w);
      }
      const bool is_last = d == depth - 1;
      bool vertex = true;  // a non-emissive hit to shade in this step
      if (!shadow) {
        if constexpr (!IsMesh<T>::value) {
          h.t = best_t;
          h.n = {0.0f, 0.0f, 0.0f};
          h.mat = -1;
          h.outside = true;
          if (best_g >= 0) {
            geom_test(s, best_g, p.org, p.dir, true, &h.n, &h.outside);
            h.mat = __ldg(s.gmat + best_g);
          }
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
  // a Hit; on a mesh scene's tables the mesh-aware `intersect` above
  const auto h = intersect(s, p.org, p.dir);
  const bool alive =
      shade_nee(s, L, p, a, h, it, depth, static_cast<uint32_t>(pool.pix[i]), is_last);
  store_path(pool, i, p);
  pool.alive[i] = alive ? 1 : 0;
  prev_pdf[i] = a.pdf;
  prev_nondelta[i] = a.nondelta;
}

// #5. 6 blocks per SM at 80 registers (95 without the bound): 3% faster
// on many_materials 1080p RR, 7% slower on Cornell 800x800 AA, on the H100.
// On a mesh scene (MeshOf) its slots intersect and cast their shadow rays
// through the mesh-aware `intersect` and `unoccluded` above, under the
// same bound (spilling 100-120 B; 5 and 4 blocks ran 2% and 4% faster on
// mesh.txt 800x800 AA, a path bound by the host).
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

// Each kernel's resident blocks per device, 0 until queried: its
// instantiations on Tables, TexTables, MeshOf<Tables>, MeshOf<TexTables>.
int g_resident_nee[4][64];
int g_resident_bounce[4][64];

// #5 on tables s: one warp per chunk at most.
template <class S>
cudaError_t launch_bounce_nee(const S& s, int* resident_cache, const Lights& L,
                              void* const* pool, int n, int iteration, int depth, int is_last,
                              int* counter, int device, cudaStream_t st) {
  int resident = 0;
  const cudaError_t err =
      resident_blocks(bounce_step_nee_kernel<S>, device, resident_cache, &resident);
  if (err != cudaSuccess) return err;
  const int wanted = n_blocks(((n + kChunk - 1) / kChunk) * 32);
  bounce_step_nee_kernel<<<std::min(resident, wanted), kThreads, 0, st>>>(
      s, L, make_lanes(pool), static_cast<float*>(pool[14]), static_cast<float*>(pool[15]), n,
      iteration, depth, is_last, counter);
  return cudaSuccess;
}

// #6 on tables s.
template <class S>
cudaError_t launch_full_nee(const S& s, int* resident_cache, const Lights& L, const float* cam,
                            float* const* acc, int iteration0, int n_iters, int resx, int resy,
                            int depth, int* counter, int device, cudaStream_t st) {
  int resident = 0;
  const cudaError_t err =
      resident_blocks(full_iteration_nee_kernel<S>, device, resident_cache, &resident);
  if (err != cudaSuccess) return err;
  full_iteration_nee_kernel<<<std::min(resident, n_blocks(resx * resy)), kThreads, 0, st>>>(
      s, L, cam, acc[0], acc[1], acc[2], iteration0, n_iters, resx, resy, depth, counter);
  return cudaSuccess;
}

// Run f on the tables of this launch: Tables or TexTables (the surface
// stage's flags), wrapped in MeshOf when the scene has mesh geoms; f gets
// the tables and the index of their instantiation (0-3).
template <class F>
cudaError_t with_tables(void* const* tables, int n_geoms, int flags, int rr_start,
                        void* const* mesh, int n_mesh, F f) {
  if (flags & kSurfaceStage) {
    const TexTables t = make_tex_tables(tables, n_geoms, flags, rr_start);
    return n_mesh > 0 ? f(with_mesh(t, mesh, n_mesh), 3) : f(t, 1);
  }
  const Tables t = make_tables(tables, n_geoms, flags, rr_start);
  return n_mesh > 0 ? f(with_mesh(t, mesh, n_mesh), 2) : f(t, 0);
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t,
// PyTorch's current stream) of CUDA device `device` and returns
// cudaGetLastError() of the launch, or the occupancy query's error: the
// kernel's instantiation on TexTables when flags has a kSurfaceStage bit,
// on MeshOf<...> when n_mesh > 0.
// tables = {xf, inv, invt, gtype, gmat, mat, env, lights, surf, tex, bump,
// envmap}; aw = the MIS light pdf model (mean light area x n_lights);
// mesh = {tri, attr, box, geoms, chunk, super, node, roots} for the
// n_mesh mesh geoms (null when n_mesh is 0); counter: one int32 on the
// device, zero before the launch and used by no other launch.

// pool = 16 pointers: the 12 float lanes, alive, pix, prev_pdf, prev_nondelta.
extern "C" int pt_bounce_step_nee(void* const* tables, int n_geoms, int n_lights, float aw,
                                  void* const* mesh, int n_mesh, void* const* pool, int n,
                                  int iteration, int depth, int is_last, int rr_start,
                                  int flags, int* counter, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Lights L = make_lights(tables, n_lights, aw);
    err = with_tables(tables, n_geoms, flags, rr_start, mesh, n_mesh, [&](const auto& s, int v) {
      return launch_bounce_nee(s, g_resident_bounce[v], L, pool, n, iteration, depth, is_last,
                               counter, device, st);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Iterations iteration0 .. iteration0 + n_iters - 1; acc = {r, g, b}.
extern "C" int pt_full_iteration_nee(void* const* tables, int n_geoms, int n_lights, float aw,
                                     void* const* mesh, int n_mesh, const float* cam,
                                     float* const* acc, int iteration0, int n_iters, int resx,
                                     int resy, int depth, int rr_start, int flags, int* counter,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resx * resy > 0 && n_iters > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Lights L = make_lights(tables, n_lights, aw);
    err = with_tables(tables, n_geoms, flags, rr_start, mesh, n_mesh, [&](const auto& s, int v) {
      return launch_full_nee(s, g_resident_nee[v], L, cam, acc, iteration0, n_iters, resx, resy,
                             depth, counter, device, st);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
