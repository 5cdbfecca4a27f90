// Device code shared by the mesh sources (sm_90a): mesh.cu (kernels
// #7-#10, the dense route), sorted.cu (the big-mesh route) and nee.cu
// (#5 and #6 on a mesh scene). The mesh tables, the ray and hit lanes,
// the object-space ray, the slab test, Moller-Trumbore and the
// world-space tail of a mesh hit, so that every route tests a triangle
// and finishes a hit with the same float operations in the same order.

#pragma once

#include "path_common.cuh"

namespace {

// The mesh tables, as ops/megakernel.py::pack_mesh_tables lays them out
// (four of its six: the big-mesh route reads the chunk and supernode
// boxes itself).
struct MeshTables {
  const float4* tri;  // (T,3) float4: v0.xyz v1.x | v1.yz v2.xy | v2.z - - -
  const float* attr;  // (T,16): n0 n1 n2 (xyz each), uv0 uv1 uv2 (uv each), -
  const float4* box;  // (B,2) float4: min.xyz - | max.xyz -
  const int4* geoms;  // (M,) geom index, first node, node count, has_uv
  int n_mesh;
};

// mesh[] = {tri, attr, box, geoms, chunk, super}, in that order
inline MeshTables make_mesh_tables(void* const* t, int n_mesh) {
  MeshTables m;
  m.tri = static_cast<const float4*>(t[0]);
  m.attr = static_cast<const float*>(t[1]);
  m.box = static_cast<const float4*>(t[2]);
  m.geoms = static_cast<const int4*>(t[3]);
  m.n_mesh = n_mesh;
  return m;
}

// The rays of a pool: origins and directions (world space), and alive
// (null: every lane is alive).
struct RayLanes {
  const float* o[3];
  const float* d[3];
  const int* alive;
};

inline RayLanes make_rays(void* const* r) {
  RayLanes l;
  for (int k = 0; k < 3; ++k) {
    l.o[k] = static_cast<const float*>(r[k]);
    l.d[k] = static_cast<const float*>(r[3 + k]);
  }
  l.alive = static_cast<const int*>(r[6]);
  return l;
}

// A lane's hit lanes: the analytic winner (#7's output, with the
// candidacy flag) or the mesh winner (#8's, with its UVs).
struct HitLanes {
  float* t;
  float* n[3];
  int* mat;
  unsigned char* outside;
  unsigned char* flag;  // analytic: is a mesh candidate; mesh: has_uv
  float* u;
  float* v;
};

// lanes[] = {t, nx, ny, nz, mat, outside, flag[, u, v]}
inline HitLanes make_hits(void* const* h, bool uv) {
  HitLanes l;
  l.t = static_cast<float*>(h[0]);
  for (int k = 0; k < 3; ++k) l.n[k] = static_cast<float*>(h[1 + k]);
  l.mat = static_cast<int*>(h[4]);
  l.outside = static_cast<unsigned char*>(h[5]);
  l.flag = static_cast<unsigned char*>(h[6]);
  l.u = uv ? static_cast<float*>(h[7]) : nullptr;
  l.v = uv ? static_cast<float*>(h[8]) : nullptr;
  return l;
}

__device__ __forceinline__ V3 ray_o(const RayLanes& r, int i) {
  return {r.o[0][i], r.o[1][i], r.o[2][i]};
}
__device__ __forceinline__ V3 ray_d(const RayLanes& r, int i) {
  return {r.d[0][i], r.d[1][i], r.d[2][i]};
}

// A ray in a mesh geom's object space, with its reciprocal direction.
struct ObjRay {
  V3 o, d, inv_d;
};

// The world ray (o, d) in the object space of the geom whose inverse is
// `inv`: the origin transformed, the direction transformed and normalised.
__device__ __forceinline__ ObjRay object_ray(const float* inv, V3 o, V3 d) {
  ObjRay r;
  r.o = xform_point(inv, o);
  r.d = normalize(xform_dir(inv, d));
  r.inv_d = {1.0f / r.d.x, 1.0f / r.d.y, 1.0f / r.d.z};
  return r;
}

// The Frobenius norm of inv's 3x3 block: a world distance times it bounds
// the object-space distance (it is at least the operator norm).
__device__ __forceinline__ float frobenius3(const float* inv) {
  const float i0 = __ldg(inv + 0), i1 = __ldg(inv + 1), i2 = __ldg(inv + 2);
  const float i4 = __ldg(inv + 4), i5 = __ldg(inv + 5), i6 = __ldg(inv + 6);
  const float i8 = __ldg(inv + 8), i9 = __ldg(inv + 9), i10 = __ldg(inv + 10);
  return sqrtf(i0 * i0 + i1 * i1 + i2 * i2 + i4 * i4 + i5 * i5 + i6 * i6 + i8 * i8 + i9 * i9 +
               i10 * i10);
}

// The slab interval of an AABB (IEEE inf for axis-parallel rays): the t
// at which the ray's line enters and leaves the box.
__device__ __forceinline__ void slab_span(float4 lo, float4 hi, const ObjRay& r, float* tmin,
                                          float* tmax) {
  const float t1x = (lo.x - r.o.x) * r.inv_d.x;
  const float t2x = (hi.x - r.o.x) * r.inv_d.x;
  const float t1y = (lo.y - r.o.y) * r.inv_d.y;
  const float t2y = (hi.y - r.o.y) * r.inv_d.y;
  const float t1z = (lo.z - r.o.z) * r.inv_d.z;
  const float t2z = (hi.z - r.o.z) * r.inv_d.z;
  *tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  *tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
}

// Slab test of an AABB: entered, ahead of the origin, and before `bound`.
__device__ __forceinline__ bool slab_enter(float4 lo, float4 hi, const ObjRay& r, float bound) {
  float tmin, tmax;
  slab_span(lo, hi, r, &tmin, &tmax);
  return tmax >= tmin && tmax > 0.0f && tmin < bound;
}

// How mt_test rounds u's dot product tvec . pvec. nvcc fuses the dot's
// first add with one of its two products (-fmad) and picks which from the
// code around it, an ulp apart on some hits; left to it, an edit around
// one caller could change that caller's bits. So each caller names its
// own: the BVH walk (#8) the x product fused, the big-mesh route's C the
// y product, the roundings their results have always had.
enum class URound { kFuseX, kFuseY };

template <URound kU>
__device__ __forceinline__ float u_dot(V3 a, V3 b) {
  return kU == URound::kFuseX ? __fmaf_rn(a.z, b.z, __fmaf_rn(a.x, b.x, __fmul_rn(a.y, b.y)))
                              : __fmaf_rn(a.z, b.z, __fmaf_rn(a.y, b.y, __fmul_rn(a.x, b.x)));
}

// Moller-Trumbore on a triangle given by its first corner and two edges
// (ops/intersect.py::triangle_intersect; the JAX package's _mt_chunk with
// its pre-subtracted edges): the hit's t, u and v when the ray meets the
// triangle past RAY_EPS.
template <URound kU>
__device__ __forceinline__ bool mt_test(V3 v0, V3 e1, V3 e2, const ObjRay& r, float* t_out,
                                        float* u_out, float* v_out) {
  const V3 pvec = cross(r.d, e2);
  const float det = dot(e1, pvec);
  if (!(fabsf(det) > 1e-12f)) return false;
  const float inv_det = 1.0f / det;
  const V3 tvec = r.o - v0;
  const float u = u_dot<kU>(tvec, pvec) * inv_det;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(r.d, qvec) * inv_det;
  const float t = dot(e2, qvec) * inv_det;
  if (!(u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kRayEps)) return false;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return true;
}

// mt_test on soup triangle `tri` of the tables (#8's rounding).
__device__ __forceinline__ bool tri_test(const MeshTables& m, int tri, const ObjRay& r,
                                         float* t_out, float* u_out, float* v_out) {
  const float4 a = __ldg(m.tri + 3 * tri);
  const float4 b = __ldg(m.tri + 3 * tri + 1);
  const float4 c = __ldg(m.tri + 3 * tri + 2);
  const V3 v0 = {a.x, a.y, a.z};
  return mt_test<URound::kFuseX>(v0, V3{a.w, b.x, b.y} - v0, V3{b.z, b.w, c.x} - v0, r, t_out,
                                 u_out, v_out);
}

// One mesh instance's winner in object space.
struct TriHit {
  float t;  // object-space t, FLT_MAX when nothing was hit
  int tri;
  float u, v;
};

// The plain version's tail (mesh_intersect_bvh): world distance, the
// interpolated normal through invTranspose oriented against the ray, and
// the interpolated UVs.
struct MeshHit {
  float t;
  V3 n;
  bool outside;
  float u, v;
};

__device__ __forceinline__ MeshHit epilogue(const Tables& s, const MeshTables& m, int g,
                                            bool has_uv, const ObjRay& r, const TriHit& th,
                                            V3 o, V3 d) {
  const float* at = m.attr + 16 * th.tri;
  const float w = 1.0f - th.u - th.v;
  const V3 n0 = {__ldg(at + 0), __ldg(at + 1), __ldg(at + 2)};
  const V3 n1 = {__ldg(at + 3), __ldg(at + 4), __ldg(at + 5)};
  const V3 n2 = {__ldg(at + 6), __ldg(at + 7), __ldg(at + 8)};
  const V3 n_obj = normalize(n0 * w + n1 * th.u + n2 * th.v);
  MeshHit h;
  h.u = 0.0f;
  h.v = 0.0f;
  if (has_uv) {
    h.u = w * __ldg(at + 9) + th.u * __ldg(at + 11) + th.v * __ldg(at + 13);
    h.v = w * __ldg(at + 10) + th.u * __ldg(at + 12) + th.v * __ldg(at + 14);
  }
  const V3 p_obj = r.o + r.d * (th.t - kRayEps);
  const V3 p_world = xform_point(s.xf + 16 * g, p_obj);
  const V3 n_world = normalize(xform_dir(s.invt + 16 * g, n_obj));
  h.outside = dot(n_world, d) < 0.0f;
  h.n = n_world * (h.outside ? 1.0f : -1.0f);
  const V3 diff = o - p_world;
  h.t = sqrtf(dot(diff, diff));
  return h;
}

}  // namespace
