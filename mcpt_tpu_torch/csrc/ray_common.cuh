// Ray and triangle arithmetic shared by the traversal kernels (traverse.cu,
// treelet.cu), and the walk of the child-pair table that the BVH traversal
// kernels run from the tree's root in global memory and the select kernels
// run from a treelet's root in shared memory.
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
constexpr int kLeafSize = 4;  // ops/bvh.py DEFAULT_LEAF_SIZE

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


// Slab test of box (lo = na.xyz, hi = nb.xyz) over [t_lo, t_hi] (far * 1.001
// on every axis, strict tmin < tmax); tmin is the entry t.
__device__ __forceinline__ bool slab(const float4 na, const float4 nb, const Ray& r, float t_lo,
                                     float t_hi, float& tmin) {
  const float tax = __fmul_rn(__fsub_rn(na.x, r.ox), r.ix);
  const float tay = __fmul_rn(__fsub_rn(na.y, r.oy), r.iy);
  const float taz = __fmul_rn(__fsub_rn(na.z, r.oz), r.iz);
  const float tbx = __fmul_rn(__fsub_rn(nb.x, r.ox), r.ix);
  const float tby = __fmul_rn(__fsub_rn(nb.y, r.oy), r.iy);
  const float tbz = __fmul_rn(__fsub_rn(nb.z, r.oz), r.iz);
  const float nx = min_nan(tax, tbx), ny = min_nan(tay, tby), nz = min_nan(taz, tbz);
  const float fx = __fmul_rn(max_nan(tax, tbx), kFarFudge);
  const float fy = __fmul_rn(max_nan(tay, tby), kFarFudge);
  const float fz = __fmul_rn(max_nan(taz, tbz), kFarFudge);
  tmin = max_nan(t_lo, max_nan(max_nan(nx, ny), nz));
  const float tmax = min_nan(t_hi, min_nan(min_nan(fx, fy), fz));
  return tmin < tmax;
}

__device__ __forceinline__ bool slab(const float4 na, const float4 nb, const Ray& r, float t_lo,
                                     float t_hi) {
  float tmin;
  return slab(na, nb, r, t_lo, t_hi, tmin);
}

// ---------------------------------------------------------------------------
// The walk of the child-pair table (ops/traverse.py TraversalSet.pairs: one
// 64-byte row per inner node, both children's boxes and refs; a ref is row*8
// for an inner child and first*8 + count for a leaf). kGlobal: the rows and
// triangles lie in global memory and are read through the read-only cache;
// otherwise they were staged in shared memory, and every ref read from a row
// is made local to the staged treelet (ops/treelets.py): a leaf's less tb8 =
// 8 * its first triangle, an inner row's less pb8 = 8 * its first row. The
// BVH walk passes 0 for both. Triangles are three float4 (v0, e1, e2).
// ---------------------------------------------------------------------------

template <bool kGlobal>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

__device__ __forceinline__ int rebase(int ref, int tb8, int pb8) {
  return ref - ((ref & 7) ? tb8 : pb8);
}

struct Best {
  float t, u, v;
  int id;
};

// The closest-hit walk of one ray, near child first: its state and its
// steps. Each row tests both boxes over [t_lo, min(best_t, t_hi)], goes to
// the hit child with the smaller entry t (left on a tie) and pushes the
// other with its entry t. A leaf tests its triangles and keeps the smaller
// t, or the lower id on an equal t. After a leaf, or a row with no child
// hit, it pops, dropping without a load every entry whose t no longer lies
// below min(best_t, t_hi), which is the slab test of that box with the
// running best_t. The stack is the caller's: two local arrays of as many
// entries as the tree (or treelet) is deep, kept out of the struct so that
// its scalars can live in registers.
struct Walk {
  Ray r;
  float t_lo, t_hi;
  Best best;
  int ref;  // local row*8 (inner row), first*8 + count (leaf), or -1 (finished)
  int sp;
  int* stk_ref;
  float* stk_t;

  // Pops the first entry whose entry t still lies below min(best_t, t_hi).
  __device__ __forceinline__ int pop() {
    const float th = min_nan(best.t, t_hi);
    while (sp > 0) {
      --sp;
      if (stk_t[sp] < th) return stk_ref[sp];
    }
    return -1;
  }

  template <bool kGlobal>
  __device__ __forceinline__ void inner(const float4* __restrict__ pairs, int tb8, int pb8) {
    const float4* row = pairs + 4 * (ref >> 3);
    const float4 l0 = ld4<kGlobal>(row), l1 = ld4<kGlobal>(row + 1);
    const float4 r0 = ld4<kGlobal>(row + 2), r1 = ld4<kGlobal>(row + 3);
    const float th = min_nan(best.t, t_hi);
    float tl, tr;
    const bool hl = slab(l0, l1, r, t_lo, th, tl);
    const bool hr = slab(r0, r1, r, t_lo, th, tr);
    const int lref = rebase(__float_as_int(l0.w), tb8, pb8);
    const int rref = rebase(__float_as_int(l1.w), tb8, pb8);
    if (hl && hr) {
      const bool lfirst = tl <= tr;
      stk_ref[sp] = lfirst ? rref : lref;
      stk_t[sp] = lfirst ? tr : tl;
      ++sp;
      ref = lfirst ? lref : rref;
    } else if (hl) {
      ref = lref;
    } else if (hr) {
      ref = rref;
    } else {
      ref = pop();
    }
  }

  // `tbase`: the id of the walk's triangle 0.
  template <bool kGlobal>
  __device__ __forceinline__ void leaf(const float4* __restrict__ tris, int tbase) {
    const int first = ref >> 3;
    const int cnt = min(ref & 7, kLeafSize);
    for (int k = 0; k < cnt; ++k) {
      const float4* p = tris + 3 * (first + k);
      const Tuv h = mt_tri(ld4<kGlobal>(p), ld4<kGlobal>(p + 1), ld4<kGlobal>(p + 2), r, kDetClosest);
      const int id = tbase + first + k;
      // t in [t_lo, t_hi), below best_t or equal to it with a lower id
      if (h.ok && h.t >= t_lo && h.t < t_hi && (h.t < best.t || (h.t == best.t && id < best.id)) &&
          h.u >= 0.f && h.v >= 0.f && __fsub_rn(__fsub_rn(1.0f, h.u), h.v) >= 0.f) {
        best.t = h.t;
        best.u = h.u;
        best.v = h.v;
        best.id = id;
      }
    }
    ref = pop();
  }

  // Walks from `ref` with an empty stack, at most max_steps rows and leaves.
  template <bool kGlobal>
  __device__ __forceinline__ void run(const float4* __restrict__ pairs, const float4* __restrict__ tris,
                                      int tbase, int pb8, int max_steps) {
    sp = 0;
    for (int step = 0; step < max_steps && ref >= 0; ++step) {
      if ((ref & 7) == 0) {
        inner<kGlobal>(pairs, 8 * tbase, pb8);
      } else {
        leaf<kGlobal>(tris, tbase);
      }
    }
  }
};

// The any-hit walk of one ray: both boxes over [t_lo, t_hi], one hit child
// taken (the nearer, left on a tie) and the other pushed (refs only: with no
// best_t nothing is culled on a pop); the walk ends at the first accept.
// The stack is the caller's local array, as for Walk.
struct AnyWalk {
  Ray r;
  float t_lo, t_hi;
  bool found;
  int ref;
  int sp;
  int* stk;

  template <bool kGlobal>
  __device__ __forceinline__ void inner(const float4* __restrict__ pairs, int tb8, int pb8) {
    const float4* row = pairs + 4 * (ref >> 3);
    const float4 l0 = ld4<kGlobal>(row), l1 = ld4<kGlobal>(row + 1);
    const float4 r0 = ld4<kGlobal>(row + 2), r1 = ld4<kGlobal>(row + 3);
    float tl, tr;
    const bool hl = slab(l0, l1, r, t_lo, t_hi, tl);
    const bool hr = slab(r0, r1, r, t_lo, t_hi, tr);
    const int lref = rebase(__float_as_int(l0.w), tb8, pb8);
    const int rref = rebase(__float_as_int(l1.w), tb8, pb8);
    if (hl && hr) {
      const bool lfirst = tl <= tr;
      stk[sp++] = lfirst ? rref : lref;
      ref = lfirst ? lref : rref;
    } else if (hl) {
      ref = lref;
    } else if (hr) {
      ref = rref;
    } else {
      ref = sp > 0 ? stk[--sp] : -1;
    }
  }

  template <bool kGlobal>
  __device__ __forceinline__ void leaf(const float4* __restrict__ tris) {
    const int first = ref >> 3;
    const int cnt = min(ref & 7, kLeafSize);
    for (int k = 0; k < cnt; ++k) {
      const float4* p = tris + 3 * (first + k);
      const Tuv h = mt_tri(ld4<kGlobal>(p), ld4<kGlobal>(p + 1), ld4<kGlobal>(p + 2), r, kDetAny);
      if (h.ok && h.u >= 0.f && h.u <= 1.0f && h.v >= 0.f && __fadd_rn(h.u, h.v) <= 1.0f &&
          h.t >= t_lo && h.t <= t_hi) {
        found = true;
        ref = -1;
        return;
      }
    }
    ref = sp > 0 ? stk[--sp] : -1;
  }

  template <bool kGlobal>
  __device__ __forceinline__ void run(const float4* __restrict__ pairs, const float4* __restrict__ tris,
                                      int tbase, int pb8, int max_steps) {
    sp = 0;
    for (int step = 0; step < max_steps && ref >= 0; ++step) {
      if ((ref & 7) == 0) {
        inner<kGlobal>(pairs, 8 * tbase, pb8);
      } else {
        leaf<kGlobal>(tris);
      }
    }
  }
};

}  // namespace
