// Ray and triangle arithmetic shared by the traversal kernels (traverse.cu,
// treelet.cu).
//
// Every operation is explicitly rounded (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn), with no fused multiply-add, in the order of the plain torch
// versions (ops/traverse.py _mt, _slab); min and max propagate NaN as
// torch.minimum/maximum do (fminf/fmaxf would drop it: a ray parallel to a
// box plane that starts on it gives 0 * inf = NaN and must miss the box).
// So each kernel agrees with its plain version bit for bit.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kParked = 1e29f;  // |origin| of a parked lane (ops/woop.py PARKED)
constexpr float kFarFudge = 1.001f;
constexpr float kDetClosest = 1e-5f;
constexpr float kDetAny = 1e-6f;

// NaN-propagating min and max (torch.minimum / torch.maximum).
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// A ray is walked when its [t_lo, t_hi] is not empty and its origin is not
// parked; any other ray misses (NaN compares false).
__device__ __forceinline__ bool tested(float4 a, float4 b) {
  return a.w < b.w && fabsf(a.x) < kParked && fabsf(a.y) < kParked && fabsf(a.z) < kParked;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

struct Tuv {
  float t, u, v;
  bool ok;
};

// Moller-Trumbore of the triangle (v0 = p.xyz, e1, e2) against ray r.
__device__ __forceinline__ Tuv mt_tri(const float4 p, const float4 e1, const float4 e2, const Ray& r,
                                      float det_eps) {
  const float hx = __fsub_rn(__fmul_rn(r.dy, e2.z), __fmul_rn(r.dz, e2.y));
  const float hy = __fsub_rn(__fmul_rn(r.dz, e2.x), __fmul_rn(r.dx, e2.z));
  const float hz = __fsub_rn(__fmul_rn(r.dx, e2.y), __fmul_rn(r.dy, e2.x));
  const float det =
      __fadd_rn(__fadd_rn(__fmul_rn(e1.x, hx), __fmul_rn(e1.y, hy)), __fmul_rn(e1.z, hz));
  const float sx = __fsub_rn(r.ox, p.x), sy = __fsub_rn(r.oy, p.y), sz = __fsub_rn(r.oz, p.z);
  const float u = __fadd_rn(__fadd_rn(__fmul_rn(sx, hx), __fmul_rn(sy, hy)), __fmul_rn(sz, hz));
  const float qx = __fsub_rn(__fmul_rn(sy, e1.z), __fmul_rn(sz, e1.y));
  const float qy = __fsub_rn(__fmul_rn(sz, e1.x), __fmul_rn(sx, e1.z));
  const float qz = __fsub_rn(__fmul_rn(sx, e1.y), __fmul_rn(sy, e1.x));
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(r.dx, qx), __fmul_rn(r.dy, qy)), __fmul_rn(r.dz, qz));
  const float t =
      __fadd_rn(__fadd_rn(__fmul_rn(e2.x, qx), __fmul_rn(e2.y, qy)), __fmul_rn(e2.z, qz));
  Tuv h;
  h.ok = fabsf(det) >= det_eps;
  const float inv = h.ok ? __fdiv_rn(1.0f, det) : 0.0f;
  h.t = __fmul_rn(t, inv);
  h.u = __fmul_rn(u, inv);
  h.v = __fmul_rn(v, inv);
  return h;
}

__device__ __forceinline__ Ray make_ray(float4 a, float4 b) {
  Ray r;
  r.ox = a.x;
  r.oy = a.y;
  r.oz = a.z;
  r.dx = b.x;
  r.dy = b.y;
  r.dz = b.z;
  r.ix = __fdiv_rn(1.0f, b.x);
  r.iy = __fdiv_rn(1.0f, b.y);
  r.iz = __fdiv_rn(1.0f, b.z);
  return r;
}

}  // namespace
