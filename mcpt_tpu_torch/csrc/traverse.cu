// Skip-link BVH traversal kernels for Hopper (sm_90a): closest hit and any hit.
//
// Replace the TPU kernels _closest_kernel and _any_kernel of
// mcpt_tpu/ops/pallas/traverse.py (pallas_call sites in
// closest_hit_treelets_impl and any_hit_treelets_impl). Same function: the
// closest (t, tri, u, v), or whether any hit exists, of each ray against the
// scene's BVH, with the reference accept predicates (src/Triangle.cpp:48-78
// closest, 83-106 any) and slab test (src/AABB.cpp:25-36, far * 1.001).
//
// Design. One thread per ray walks the flattened preorder BVH with skip
// links (ops/bvh.py): box hit of an inner node -> node + 1; box hit of a
// leaf -> test its <= kLeafSize triangles, then skip; box miss -> skip;
// -1 ends. The TPU kernel cut the BVH into superblocks and 128-triangle
// treelets and tested whole ray tiles against whole treelets, because its
// vector unit works on (8, 128) tiles staged in VMEM; a GPU thread follows
// its own ray, so that layout is not used. Nodes are two float4 (lo.xyz,
// first*8 + count; hi.xyz, skip) and triangles three float4 (v0, e1, e2),
// read through the read-only cache. The wrapper (ops/traverse.py) sorts the
// rays so that a warp's rays are coherent. There is no shared memory and no
// __syncthreads(), so a thread leaves as soon as its walk ends.
//
// Arithmetic: ray_common.cuh's, single rounded f32 operations in the plain
// version's order (ops/traverse.py), so the two agree bit for bit.
//
// Loops are bounded: the cursor only moves forward (node + 1, or skip >
// node), and the walk is capped at n_nodes steps anyway; the leaf loop at
// kLeafSize.
//
// Bound on this card: FP32 arithmetic per node visit (~29 operations) and
// per triangle test (~56), against 32 bytes of node and 48 of triangle
// read per visit; the visits are data-dependent and the reads scattered.
// A wider BVH, an ordered stack and shared-memory staging are later work.

#include "ray_common.cuh"

namespace {

constexpr int kBlock = 128;   // rays per block (ops/traverse.py RAY_TILE)
constexpr int kLeafSize = 4;  // ops/bvh.py DEFAULT_LEAF_SIZE

// Slab test of node box (lo = na.xyz, hi = nb.xyz) over [t_lo, t_hi].
__device__ __forceinline__ bool slab(const float4 na, const float4 nb, const Ray& r, float t_lo,
                                     float t_hi) {
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
  const float tmin = max_nan(t_lo, max_nan(max_nan(nx, ny), nz));
  const float tmax = min_nan(t_hi, min_nan(min_nan(fx, fy), fz));
  return tmin < tmax;
}

// Moller-Trumbore of triangle `id` (tris rows of three float4: v0, e1, e2).
__device__ __forceinline__ Tuv mt(const float4* __restrict__ tris, int id, const Ray& r,
                                  float det_eps) {
  return mt_tri(__ldg(&tris[3 * id]), __ldg(&tris[3 * id + 1]), __ldg(&tris[3 * id + 2]), r, det_eps);
}

__global__ void __launch_bounds__(kBlock)
traverse_closest_kernel(const float4* __restrict__ rays, const float4* __restrict__ nodes,
                        const float4* __restrict__ tris, int R, int n_nodes,
                        float* __restrict__ out_t, int* __restrict__ out_tri,
                        float* __restrict__ out_u, float* __restrict__ out_v) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= R) return;
  const float4 a = rays[2 * i];      // o.xyz, t_lo
  const float4 b = rays[2 * i + 1];  // d.xyz, t_hi
  float best_t = FLT_MAX, best_u = 0.f, best_v = 0.f;
  int best_id = -1;
  if (tested(a, b)) {
    const Ray r = make_ray(a, b);
    int node = 0;
    for (int step = 0; step < n_nodes && node >= 0; ++step) {
      const float4 na = __ldg(&nodes[2 * node]);
      const float4 nb = __ldg(&nodes[2 * node + 1]);
      const bool hit = slab(na, nb, r, a.w, min_nan(best_t, b.w));
      const int word = __float_as_int(na.w);
      const int cnt = min(word & 7, kLeafSize);
      if (hit && cnt > 0) {
        const int first = word >> 3;
        for (int k = 0; k < cnt; ++k) {
          const Tuv h = mt(tris, first + k, r, kDetClosest);
          // strict < against the running best: the first of equal t wins
          if (h.ok && h.t >= a.w && h.t < min_nan(best_t, b.w) && h.u >= 0.f && h.v >= 0.f &&
              __fsub_rn(__fsub_rn(1.0f, h.u), h.v) >= 0.f) {
            best_t = h.t;
            best_id = first + k;
            best_u = h.u;
            best_v = h.v;
          }
        }
      }
      node = (hit && (word & 7) == 0) ? node + 1 : __float_as_int(nb.w);
    }
  }
  const bool found = best_id >= 0;
  out_t[i] = found ? best_t : FLT_MAX;
  out_tri[i] = best_id;
  out_u[i] = found ? best_u : 0.f;
  out_v[i] = found ? best_v : 0.f;
}

__global__ void __launch_bounds__(kBlock)
traverse_any_kernel(const float4* __restrict__ rays, const float4* __restrict__ nodes,
                    const float4* __restrict__ tris, int R, int n_nodes,
                    bool* __restrict__ out_hit) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= R) return;
  const float4 a = rays[2 * i];
  const float4 b = rays[2 * i + 1];
  bool found = false;
  if (tested(a, b)) {
    const Ray r = make_ray(a, b);
    int node = 0;
    for (int step = 0; step < n_nodes && node >= 0 && !found; ++step) {
      const float4 na = __ldg(&nodes[2 * node]);
      const float4 nb = __ldg(&nodes[2 * node + 1]);
      const bool hit = slab(na, nb, r, a.w, b.w);
      const int word = __float_as_int(na.w);
      const int cnt = min(word & 7, kLeafSize);
      if (hit && cnt > 0) {
        const int first = word >> 3;
        for (int k = 0; k < cnt; ++k) {
          const Tuv h = mt(tris, first + k, r, kDetAny);
          if (h.ok && h.u >= 0.f && h.u <= 1.0f && h.v >= 0.f && __fadd_rn(h.u, h.v) <= 1.0f &&
              h.t >= a.w && h.t <= b.w) {
            found = true;
            break;
          }
        }
      }
      node = (hit && (word & 7) == 0) ? node + 1 : __float_as_int(nb.w);
    }
  }
  out_hit[i] = found;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
int traverse_closest(const float* rays, const float* nodes, const float* tris, int R,
                     int n_nodes, float* out_t, int* out_tri, float* out_u, float* out_v,
                     void* stream) {
  const int blocks = (R + kBlock - 1) / kBlock;
  traverse_closest_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), R, n_nodes, out_t, out_tri, out_u, out_v);
  return (int)cudaGetLastError();
}

int traverse_any(const float* rays, const float* nodes, const float* tris, int R, int n_nodes,
                 bool* out_hit, void* stream) {
  const int blocks = (R + kBlock - 1) / kBlock;
  traverse_any_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), R, n_nodes, out_hit);
  return (int)cudaGetLastError();
}

}  // extern "C"
