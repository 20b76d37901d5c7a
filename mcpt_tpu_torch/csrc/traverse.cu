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
// and refs) with a per-thread stack: ray_common.cuh's Walk and AnyWalk, the
// step the select kernels (treelet.cu) run over staged treelets. After the
// root box (nodes[0]), each inner row starts its four float4 loads together
// and tests both boxes; a ref is row*8 for an inner child and first*8 +
// count for a leaf. The stack
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
constexpr int kStackSmall = 64;  // stack entries of the kernel for trees up to 64 deep
constexpr int kStackMax = 128;   // and of the one for deeper trees (ops/traverse.py STACK_SIZE)

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
  int stk_ref[kStack];
  float stk_t[kStack];
  Walk w;
  w.stk_ref = stk_ref;
  w.stk_t = stk_t;
  w.best = Best{FLT_MAX, 0.f, 0.f, -1};
  w.ref = -1;
  w.t_lo = a.w;
  w.t_hi = b.w;
  if (tested(a, b)) {
    w.r = make_ray(a, b);
    if (slab(__ldg(&nodes[0]), __ldg(&nodes[1]), w.r, a.w, min_nan(w.best.t, b.w))) w.ref = root_ref;
  }
  w.run<true>(pairs, tris, 0, 0, max_steps);
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
  int stk[kStack];
  AnyWalk w;
  w.stk = stk;
  w.found = false;
  w.ref = -1;
  w.t_lo = a.w;
  w.t_hi = b.w;
  if (tested(a, b)) {
    w.r = make_ray(a, b);
    if (slab(__ldg(&nodes[0]), __ldg(&nodes[1]), w.r, a.w, b.w)) w.ref = root_ref;
  }
  w.run<true>(pairs, tris, 0, 0, max_steps);
  out_hit[i] = w.found;
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
