// BVH traversal kernels for Hopper (sm_90a): closest hit and any hit.
//
// Replace the TPU kernels _closest_kernel and _any_kernel of
// mcpt_tpu/ops/pallas/traverse.py (pallas_call sites in
// closest_hit_treelets_impl and any_hit_treelets_impl). Same function: the
// closest (t, tri, u, v), or whether any hit exists, of each ray against the
// scene's BVH, with the reference accept predicates (src/Triangle.cpp:48-78
// closest, 83-106 any) and slab test (src/AABB.cpp:25-36, far * 1.001).
// The TPU kernel cut the BVH into superblocks and 128-triangle treelets and
// tested whole ray tiles against whole treelets, because its vector unit
// works on (8, 128) tiles staged in VMEM; a GPU thread follows its own ray,
// so that layout is not used here. One thread walks one ray; the wrapper
// (ops/traverse.py) sorts the rays so that a warp's rays are coherent.
// Triangles are three float4 (v0, e1, e2), read through the read-only
// cache. There is no shared memory and no __syncthreads().
//
// Both kernels walk the child-pair table (ops/traverse.py
// TraversalSet.pairs, one 64-byte row per inner node: both children's boxes
// and refs) with a per-thread stack. After the root box (nodes[0]), each
// inner row starts its four float4 loads together and tests both boxes; a
// ref is row*8 for an inner child and first*8 + count for a leaf. The stack
// holds at most the tree's depth in inner nodes (TraversalSet.depth); each
// kernel comes with a stack of 64 entries and one of 128, and the entry
// point launches the smaller one that holds the tree (pack_traversal
// refuses a deeper one; the SAH trees of the scenes are about 30 deep).
//
// Closest hit walks near child first. Each row tests both boxes over
// [t_lo, min(best_t, t_hi)]; the walk goes to the hit child with the
// smaller entry t and pushes the other with its entry t. A leaf tests its
// triangles and keeps the smaller t, or the lower id on an equal t. After a
// leaf, or a row with no child hit, it pops, dropping without a load every
// entry whose t no longer lies below min(best_t, t_hi), which is the slab
// test of that box with the running best_t. So best_t falls early and far
// subtrees are culled before they are entered.
//
// Any hit tests both boxes over [t_lo, t_hi], goes to one hit child and
// pushes the other (refs only: with no best_t nothing is culled on a pop),
// and stops at the first accept. A leaf is tested if and only if its own
// slab test and all its ancestors' pass over the same [t_lo, t_hi] with the
// same floats, as in the reference's skip-link walk (ops/bvh.py FlatBVH:
// box hit of an inner node -> node + 1, box miss or leaf -> skip), so both
// walks test the same leaves up to the first accept and give the same
// answer in any child order. The kernel goes near child first (the smaller
// entry t, left on a tie).
//
// Arithmetic: ray_common.cuh's, single rounded f32 operations in the plain
// version's order (ops/traverse.py), so each kernel agrees with its plain
// walk bit for bit (closest_hit_ordered_plain, any_hit_ordered_plain).
//
// Loops are bounded: a walk visits each row and leaf at most once, capped
// at n_nodes steps anyway; the leaf loop at kLeafSize.
//
// Bound on this card: FP32 arithmetic per box test (~29 operations) and
// per triangle test (~56), against 64 bytes of row (two boxes) and 48 of
// triangle read per visit; the visits are data-dependent and the reads
// scattered.

#include "ray_common.cuh"

namespace {

constexpr int kBlock = 128;   // rays per block (ops/traverse.py RAY_TILE)
constexpr int kLeafSize = 4;  // ops/bvh.py DEFAULT_LEAF_SIZE
constexpr int kStackSmall = 64;  // stack entries of the kernel for trees up to 64 deep
constexpr int kStackMax = 128;   // and of the one for deeper trees (ops/traverse.py STACK_SIZE)

// Slab test of node box (lo = na.xyz, hi = nb.xyz) over [t_lo, t_hi]; tmin
// is the entry t.
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

// Moller-Trumbore of triangle `id` (tris rows of three float4: v0, e1, e2).
__device__ __forceinline__ Tuv mt(const float4* __restrict__ tris, int id, const Ray& r,
                                  float det_eps) {
  return mt_tri(__ldg(&tris[3 * id]), __ldg(&tris[3 * id + 1]), __ldg(&tris[3 * id + 2]), r, det_eps);
}

struct Best {
  float t, u, v;
  int id;
};

// The closest-hit walk of one ray: its state and its two kinds of step.
template <int kStack>
struct Walk {
  Ray r;
  float t_lo, t_hi;
  Best best;
  int ref;  // row*8 (inner row), first*8 + count (leaf), or -1 (finished)
  int sp;
  int stk_ref[kStack];
  float stk_t[kStack];

  // Pops the first entry whose entry t still lies below min(best_t, t_hi).
  __device__ __forceinline__ int pop() {
    const float th = min_nan(best.t, t_hi);
    while (sp > 0) {
      --sp;
      if (stk_t[sp] < th) return stk_ref[sp];
    }
    return -1;
  }

  __device__ __forceinline__ void inner(const float4* __restrict__ pairs) {
    const float4* row = pairs + 4 * (ref >> 3);
    const float4 l0 = __ldg(row), l1 = __ldg(row + 1), r0 = __ldg(row + 2), r1 = __ldg(row + 3);
    const float th = min_nan(best.t, t_hi);
    float tl, tr;
    const bool hl = slab(l0, l1, r, t_lo, th, tl);
    const bool hr = slab(r0, r1, r, t_lo, th, tr);
    const int lref = __float_as_int(l0.w), rref = __float_as_int(l1.w);
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

  __device__ __forceinline__ void leaf(const float4* __restrict__ tris) {
    const int first = ref >> 3;
    const int cnt = min(ref & 7, kLeafSize);
    for (int k = 0; k < cnt; ++k) {
      const int id = first + k;
      const Tuv h = mt(tris, id, r, kDetClosest);
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
};

template <int kStack>
__global__ void __launch_bounds__(kBlock)
traverse_closest_kernel(const float4* __restrict__ rays, const float4* __restrict__ nodes,
                        const float4* __restrict__ pairs, const float4* __restrict__ tris, int R,
                        int root_ref, int max_steps, float* __restrict__ out_t,
                        int* __restrict__ out_tri, float* __restrict__ out_u,
                        float* __restrict__ out_v) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= R) return;
  const float4 a = rays[2 * i];      // o.xyz, t_lo
  const float4 b = rays[2 * i + 1];  // d.xyz, t_hi
  Walk<kStack> w;
  w.best = Best{FLT_MAX, 0.f, 0.f, -1};
  w.ref = -1;
  w.sp = 0;
  w.t_lo = a.w;
  w.t_hi = b.w;
  if (tested(a, b)) {
    w.r = make_ray(a, b);
    if (slab(__ldg(&nodes[0]), __ldg(&nodes[1]), w.r, a.w, min_nan(w.best.t, b.w))) w.ref = root_ref;
  }
  for (int step = 0; step < max_steps && w.ref >= 0; ++step) {
    if ((w.ref & 7) == 0) {
      w.inner(pairs);
    } else {
      w.leaf(tris);
    }
  }
  const bool found = w.best.id >= 0;
  out_t[i] = found ? w.best.t : FLT_MAX;
  out_tri[i] = w.best.id;
  out_u[i] = found ? w.best.u : 0.f;
  out_v[i] = found ? w.best.v : 0.f;
}

template <int kStack>
__global__ void __launch_bounds__(kBlock)
traverse_any_kernel(const float4* __restrict__ rays, const float4* __restrict__ nodes,
                    const float4* __restrict__ pairs, const float4* __restrict__ tris, int R,
                    int root_ref, int max_steps, bool* __restrict__ out_hit) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= R) return;
  const float4 a = rays[2 * i];      // o.xyz, t_lo
  const float4 b = rays[2 * i + 1];  // d.xyz, t_hi
  bool found = false;
  if (tested(a, b)) {
    const Ray r = make_ray(a, b);
    int ref = slab(__ldg(&nodes[0]), __ldg(&nodes[1]), r, a.w, b.w) ? root_ref : -1;
    int sp = 0;
    int stk[kStack];
    for (int step = 0; step < max_steps && ref >= 0; ++step) {
      if ((ref & 7) == 0) {
        const float4* row = pairs + 4 * (ref >> 3);
        const float4 l0 = __ldg(row), l1 = __ldg(row + 1), r0 = __ldg(row + 2), r1 = __ldg(row + 3);
        float tl, tr;
        const bool hl = slab(l0, l1, r, a.w, b.w, tl);
        const bool hr = slab(r0, r1, r, a.w, b.w, tr);
        const int lref = __float_as_int(l0.w), rref = __float_as_int(l1.w);
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
      } else {
        const int first = ref >> 3;
        const int cnt = min(ref & 7, kLeafSize);
        for (int k = 0; k < cnt; ++k) {
          const Tuv h = mt(tris, first + k, r, kDetAny);
          if (h.ok && h.u >= 0.f && h.u <= 1.0f && h.v >= 0.f && __fadd_rn(h.u, h.v) <= 1.0f &&
              h.t >= a.w && h.t <= b.w) {
            found = true;
            break;
          }
        }
        if (found) break;
        ref = sp > 0 ? stk[--sp] : -1;
      }
    }
  }
  out_hit[i] = found;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
// `depth` is the tree's depth in inner nodes (TraversalSet.depth).
int traverse_closest(const float* rays, const float* nodes, const float* pairs, const float* tris,
                     int R, int root_ref, int n_nodes, int depth, float* out_t, int* out_tri,
                     float* out_u, float* out_v, void* stream) {
  if (depth > kStackMax) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kBlock - 1) / kBlock;
  auto kernel = depth <= kStackSmall ? traverse_closest_kernel<kStackSmall>
                                     : traverse_closest_kernel<kStackMax>;
  kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(pairs), reinterpret_cast<const float4*>(tris), R, root_ref,
      n_nodes, out_t, out_tri, out_u, out_v);
  return (int)cudaGetLastError();
}

int traverse_any(const float* rays, const float* nodes, const float* pairs, const float* tris, int R,
                 int root_ref, int n_nodes, int depth, bool* out_hit, void* stream) {
  if (depth > kStackMax) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kBlock - 1) / kBlock;
  auto kernel = depth <= kStackSmall ? traverse_any_kernel<kStackSmall>
                                     : traverse_any_kernel<kStackMax>;
  kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(pairs), reinterpret_cast<const float4*>(tris), R, root_ref,
      n_nodes, out_hit);
  return (int)cudaGetLastError();
}

}  // extern "C"
