// Treelet traversal kernels for Hopper (sm_90a): the schedule pre-pass, and
// schedule-fed and superblock-select closest hit and any hit.
//
// Replace the TPU kernels of mcpt_tpu/ops/pallas/schedule.py
// (_closest_kernel :253, _any_kernel :361; pallas_call sites in
// closest_hit_schedule_impl and any_hit_schedule_impl) and of
// mcpt_tpu/ops/pallas/select.py (_closest_kernel :80, _any_kernel :258;
// pallas_call sites in closest_hit_treelets_smem and any_hit_treelets_smem).
// Same function as the BVH traversal (traverse.cu): the closest (t, tri, u,
// v), or whether any hit exists, of each ray, with the reference accept
// predicates (src/Triangle.cpp:48-78 closest, 83-106 any) and the lowest
// triangle id on equal t. schedule_prepass_kernel replaces no TPU kernel:
// it is the schedule's pre-pass (mcpt_tpu build_schedule, XLA on the TPU,
// torch in the port's plain version ops/schedule.py build_schedule_plain),
// the feed of the schedule walk, moved onto the card with it.
//
// One block of kTile threads per tile of kTile sorted rays, one thread a
// ray. The treelet layout (ops/treelets.py) groups the BVH-ordered
// triangles into treelets (BVH subtrees of <= 128 triangles) and the
// treelets into superblocks.
//
// The TPU kernels tested every ray of a tile against every triangle of
// every treelet the tile visited, because a TPU core has no per-lane
// control flow and chose treelets on its scalar core. Here the block does
// what gains from sharing, choosing and staging a treelet, and each ray
// walks only the part of it that it enters. Both walks visit treelets one
// at a time: each treelet's triangles and child-pair rows (its sub-BVH, a
// run of TraversalSet.pairs) reach shared memory by two 1-D bulk copies
// (cp.async.bulk) issued by one thread and completed on an mbarrier, two
// stages deep, the next treelet's copy started before the block walks the
// current one; then every ray takes visit_staged, the step both walks
// share: a ray whose own key for the treelet (the slab test of its root box
// at the ray's current best_t) is live walks the staged sub-BVH with
// ray_common.cuh's Walk / AnyWalk, the BVH traversal's step, rebasing each
// ref it reads to the staged rows and triangles; a warp with no such ray
// skips the walk. A prefetched treelet that the exit test refreshed after
// the walk rules out is waited for unused, so no copy is in flight when a
// stage is reused or the block exits.
//
// schedule_prepass: per tile, the bundle's componentwise origin, direction
// and t intervals (warp shuffles), an interval slab test of the superblock
// boxes and then of the treelet boxes of the superblocks it keeps, each hit
// appended as a key (entry lower bound in the high bits, treelet row in the
// low bits) to a shared buffer, a bitonic sort of the buffer, and the row
// written front to back; a tile with more than v live treelets gets a
// blanked row (the wrapper sends its rays through the BVH traversal).
//
// schedule_*: the tile's schedule row, front to back, each key's treelet
// staged (its meta, root and box too, by the thread that starts the copy,
// so that no thread waits on a global load of them) and visited; closest
// hit stops at the first key whose lower bound is >= the block's largest
// best_t bits (refreshed after every treelet), any hit when every tested
// ray is occluded, a blanked row at once.
//
// select_*: the treelets chosen on the card, a superblock at a time:
//   1. superblocks in ascending column-min of the rays' entry keys
//      (atomicMin into shared memory), skipped unless a ray's own key is
//      live; closest hit stops at the cutoff (the block's largest best_t
//      bits), any hit when every tested ray is occluded;
//   2. the superblock's treelet keys, their column-min per slot, and the
//      live slots ranked by key (front to back); closest hit stops at the
//      first slot whose lower bound is >= the cutoff, refreshed after every
//      treelet; each slot staged and visited as above.
// Exit tests are block reductions (__syncthreads_or, warp __reduce_*_sync and
// a shared word a warp), so every barrier sits in block-uniform control flow:
// trip counts come from shared memory or from reductions. Loops are bounded
// by the schedule's length, the superblock and slot counts, the treelet's
// triangle count and, for a walk, its rows and leaves.
//
// Arithmetic: ray_common.cuh's Moller-Trumbore, slab test and NaN-
// propagating min/max, and the entry keys and interval slab test below, in
// the order of the plain versions (ops/schedule.py, ops/select.py), so each
// kernel agrees with its plain version bit for bit, and with the BVH
// traversal wherever both test a triangle.
//
// Bound on this card: FP32 operations. The walks do ~31 a (ray, box) entry
// key, ~29 a child-pair row visit and ~56 a triangle test, only in the
// leaves a ray reaches; the select pair's keys also choose the treelets
// (every superblock for every tested ray, every slot of each superblock its
// tile takes), the schedule pair's come only from the treelets of the row.
// Staging (at most 14,272 bytes a treelet) overlaps the previous treelet's
// walk. The pre-pass does ~93 a (tile, box) interval test and reads each
// tile's rays once.

#include <climits>
#include <cmath>
#include <type_traits>

#include "ray_common.cuh"

namespace {

constexpr int kTile = 128;   // rays per block (ops/schedule.py RAY_TILE)
constexpr int kWarps = kTile / 32;
constexpr int kMaxC = 128;    // triangles a treelet
constexpr int kMaxSB = 128;   // treelet slots a superblock
constexpr int kMaxNSp = 1024; // superblock columns
constexpr int kKeyMiss = INT_MAX;
constexpr int kIdMiss = 1 << 30;
// Dynamic shared memory a launch may take without raising the kernel's
// limit: 48 KB less the static shared memory of the kernels that take
// dynamic shared memory (the schedule walk's under 29 KB, the pre-pass's
// 4,384 bytes).
constexpr size_t kPlainDynSmem = 16 * 1024;

__device__ __forceinline__ int block_max(int x, int* red) {
  x = __reduce_max_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int m = red[0];
  for (int w = 1; w < kWarps; ++w) m = max(m, red[w]);
  __syncthreads();
  return m;
}

__device__ __forceinline__ int block_min(int x, int* red) {
  x = __reduce_min_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int m = red[0];
  for (int w = 1; w < kWarps; ++w) m = min(m, red[w]);
  __syncthreads();
  return m;
}

// Entry key of the ray against box (lo, hi, valid) with index `id` in the
// low `bits` bits: the reference slab test over [t_lo, t_hi] (far * 1.001
// on every axis, strict compare), key = f32 bits of max(near, +0) with the
// low bits replaced, kKeyMiss on a miss (ops/select.py entry_keys).
__device__ __forceinline__ int entry_key(float lx, float ly, float lz, float hx, float hy, float hz,
                                         float valid, const Ray& r, float t_lo, float t_hi, int bits,
                                         int id) {
  float near = -INFINITY, far = INFINITY;
  {
    const float ta = __fmul_rn(__fsub_rn(lx, r.ox), r.ix), tb = __fmul_rn(__fsub_rn(hx, r.ox), r.ix);
    near = max_nan(near, min_nan(ta, tb));
    far = min_nan(far, __fmul_rn(max_nan(ta, tb), kFarFudge));
  }
  {
    const float ta = __fmul_rn(__fsub_rn(ly, r.oy), r.iy), tb = __fmul_rn(__fsub_rn(hy, r.oy), r.iy);
    near = max_nan(near, min_nan(ta, tb));
    far = min_nan(far, __fmul_rn(max_nan(ta, tb), kFarFudge));
  }
  {
    const float ta = __fmul_rn(__fsub_rn(lz, r.oz), r.iz), tb = __fmul_rn(__fsub_rn(hz, r.oz), r.iz);
    near = max_nan(near, min_nan(ta, tb));
    far = min_nan(far, __fmul_rn(max_nan(ta, tb), kFarFudge));
  }
  const bool hit = valid > 0.f && max_nan(t_lo, near) < min_nan(t_hi, far);
  const float entry = near > 0.f ? near : 0.f;
  return hit ? ((__float_as_int(entry) & ~((1 << bits) - 1)) | id) : kKeyMiss;
}

// ---------------------------------------------------------------------------
// Schedule pre-pass
// ---------------------------------------------------------------------------

// One axis of a tile's bundle: its origin interval, its inverse-direction
// interval (the reciprocals of the direction interval's ends, ordered) and
// whether its directions change sign (then the axis bounds nothing).
struct Axis {
  float olo, ohi, ilo, ihi;
  bool mixed;
};

// The t interval [lb, ub] of the bundle's axis against the plane at b:
// every product of the origin and inverse-direction intervals' ends.
__device__ __forceinline__ void plane_interval(float b, const Axis& x, float& lb, float& ub) {
  const float q_lo = __fsub_rn(b, x.ohi), q_hi = __fsub_rn(b, x.olo);
  const float p1 = __fmul_rn(q_lo, x.ilo), p2 = __fmul_rn(q_lo, x.ihi);
  const float p3 = __fmul_rn(q_hi, x.ilo), p4 = __fmul_rn(q_hi, x.ihi);
  lb = min_nan(min_nan(p1, p2), min_nan(p3, p4));
  ub = max_nan(max_nan(p1, p2), max_nan(p3, p4));
}

// Interval slab test of the bundle against box (lo, hi) read at
// box[r * stride], r = 0..5 (ops/schedule.py _interval_slab): near and far
// over the axes that bound it, far * 1.001 where far > 0.
__device__ __forceinline__ void interval_slab(const Axis* ax, const float* box, int stride, float& near,
                                              float& far) {
  near = -INFINITY;
  far = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float l1, u1, l2, u2;
    plane_interval(box[a * stride], ax[a], l1, u1);
    plane_interval(box[(3 + a) * stride], ax[a], l2, u2);
    const float near_a = min_nan(l1, l2);
    float far_a = max_nan(u1, u2);
    far_a = far_a > 0.f ? __fmul_rn(far_a, kFarFudge) : far_a;
    near = max_nan(near, ax[a].mixed ? -INFINITY : near_a);
    far = min_nan(far, ax[a].mixed ? INFINITY : far_a);
  }
}

// Warp-wide NaN-propagating min / max (torch.amin / amax over the tile).
__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1) x = min_nan(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = max_nan(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Bundle values: o lo xyz, o hi xyz, d lo xyz, d hi xyz, t_lo min, t_hi max.
constexpr int kBnd = 14;

// The pre-pass of one tile (module comment). The superblock cull is exact:
// a superblock's box is a BVH node box, which contains the boxes of its
// treelets (its descendants), and every operation of the interval test is
// monotone in the box bounds where no NaN arises. For a bounding axis with
// positive inverse directions, each product of a treelet is >= the
// superblock's (blo' - ohi) * i (its q >= blo - ohi >= blo' - ohi, as
// bhi >= blo, olo <= ohi and rounding is monotone) and <= its (bhi' - olo)
// * i; with negative ones the same with the ends swapped. So the
// superblock's near is <= the treelet's, its far (the 1.001 applied where
// far > 0 is monotone too) >= the treelet's, and a treelet hit (lo < hi,
// no NaN on its path: a NaN misses) implies a superblock hit unless the
// superblock's test met a NaN. A superblock is dropped only when it misses
// with a near and a far that are not NaN; ops/schedule.py
// build_schedule_plain(cull=True) mirrors this and the CPU tests hold it
// equal to the test of every treelet.
__global__ void __launch_bounds__(kTile)
schedule_prepass_kernel(const float4* __restrict__ rays, const float* __restrict__ sb_box,
                        const float* __restrict__ blk_box, int ns, int nsp, int s_b, int v, int bits_g,
                        int* __restrict__ sched, bool* __restrict__ incomplete,
                        int* __restrict__ n_live) {
  extern __shared__ int buf[];  // the live keys, then the sorted row (next power of two >= v)
  __shared__ int sb_list[kMaxNSp];
  __shared__ float red[kWarps][kBnd];
  __shared__ float bnd[kBnd];
  __shared__ int n_sb, n_keys;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tile = blockIdx.x;
  const float4 a = rays[2 * (tile * kTile + tid)], bq = rays[2 * (tile * kTile + tid) + 1];
  const bool act = tested(a, bq);
  // (a) the bundle's bounds over the tile's tested rays
  {
    const float vals[kBnd] = {a.x, a.y, a.z, a.x, a.y, a.z, bq.x, bq.y, bq.z, bq.x, bq.y, bq.z, a.w, bq.w};
#pragma unroll
    for (int k = 0; k < kBnd; ++k) {
      const bool lo = k < 3 || (k >= 6 && k < 9) || k == 12;
      const float x = act ? vals[k] : (lo ? INFINITY : -INFINITY);
      const float m = lo ? warp_min(x) : warp_max(x);
      if (lane == 0) red[tid >> 5][k] = m;
    }
  }
  if (tid == 0) n_sb = n_keys = 0;
  __syncthreads();
  if (tid < kBnd) {
    const bool lo = tid < 3 || (tid >= 6 && tid < 9) || tid == 12;
    float m = red[0][tid];
    for (int w = 1; w < kWarps; ++w) m = lo ? min_nan(m, red[w][tid]) : max_nan(m, red[w][tid]);
    bnd[tid] = m;
  }
  __syncthreads();
  Axis ax[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dlo = bnd[6 + k], dhi = bnd[9 + k];
    const bool pos = dlo > 0.f, neg = dhi < 0.f, ok = pos || neg;
    const float i1 = __fdiv_rn(1.0f, ok ? dhi : 1.0f), i2 = __fdiv_rn(1.0f, ok ? dlo : 1.0f);
    ax[k] = Axis{bnd[k], bnd[3 + k], min_nan(i1, i2), max_nan(i1, i2), !pos && !neg};
  }
  const float tlo = bnd[12], thi = bnd[13];
  // (b) the superblocks the bundle may reach
  for (int s = tid; s < ns; s += kTile) {
    float near, far;
    interval_slab(ax, sb_box + s, nsp, near, far);
    if (max_nan(tlo, near) < min_nan(thi, far) || near != near || far != far) sb_list[atomicAdd(&n_sb, 1)] = s;
  }
  __syncthreads();
  // (c) their treelet rows (pad rows, valid 0, always miss); each live key
  //     counted, the first v kept
  const int nk = n_sb * s_b;
  for (int x = tid; x < nk; x += kTile) {
    const int s = sb_list[x / s_b], k = x % s_b;
    const float* box = blk_box + (size_t)s * 8 * s_b + k;
    if (!(box[6 * s_b] > 0.f)) continue;
    float near, far;
    interval_slab(ax, box, s_b, near, far);
    if (max_nan(tlo, near) < min_nan(thi, far)) {
      const float entry = fminf(near > 0.f ? near : 0.f, FLT_MAX);
      const int key = ((__float_as_int(entry) >> bits_g) << bits_g) | (s * s_b + k);
      const int at = atomicAdd(&n_keys, 1);
      if (at < v) buf[at] = key;
    }
  }
  __syncthreads();
  const int n = n_keys;
  int* row = sched + (size_t)tile * v;
  if (tid == 0) {
    incomplete[tile] = n > v;
    n_live[tile] = n;
  }
  if (n > v) {  // a cut row could hide the closest hit: blank it
    for (int e = tid; e < v; e += kTile) row[e] = kKeyMiss;
    return;
  }
  // (d) bitonic sort of the n keys padded with kKeyMiss to a power of two
  int p = 1;
  while (p < n) p <<= 1;
  for (int e = n + tid; e < p; e += kTile) buf[e] = kKeyMiss;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int e = tid; e < p; e += kTile) {
        const int f = e ^ j;
        if (f > e) {
          const int x = buf[e], y = buf[f];
          if ((x > y) == ((e & k) == 0)) {
            buf[e] = y;
            buf[f] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < v; e += kTile) row[e] = e < n ? buf[e] : kKeyMiss;
}

// ---------------------------------------------------------------------------
// Staging and the per-treelet step of both walks
// ---------------------------------------------------------------------------

// A stage holds one treelet: its triangles (at most kMaxC, three float4
// each), then its child-pair rows (at most kMaxC - 1, four float4 each).
constexpr int kStageTriF4 = 3 * kMaxC;
constexpr int kStageF4 = kStageTriF4 + 4 * (kMaxC - 1);  // 14,272 bytes
constexpr int kStackSmall = 16;  // stack entries for treelets up to 16 deep
constexpr int kStackMax = 128;   // and for deeper ones (ops/traverse.py STACK_SIZE)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0: start the bulk copies of treelet m = (first, count, pair_first,
// pair_count) into `dst`; the barrier's current phase completes when both
// have landed. The block's barrier before the call ended every read of
// `dst`; the proxy fence orders those reads before the copy's writes.
__device__ __forceinline__ void stage_bulk(float4* dst, uint64_t* bar, const float4* __restrict__ tris,
                                           const float4* __restrict__ pairs, int4 m) {
  const uint32_t bt = 48u * (uint32_t)m.y, bp = 64u * (uint32_t)m.w, b = smem_u32(bar);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bt + bp) : "memory");
  if (bt)
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(smem_u32(dst)), "l"(tris + 3 * (size_t)m.x), "r"(bt), "r"(b) : "memory");
  if (bp)
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(smem_u32(dst + kStageTriF4)), "l"(pairs + 4 * (size_t)m.z), "r"(bp), "r"(b) : "memory");
}

// Every thread: wait until phase `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Thread 0: make both stage barriers (one arrival a phase).
__device__ __forceinline__ void init_stage_bars(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bar[0])) : "memory");
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bar[1])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

template <bool kClosest>
using WalkOf = typename std::conditional<kClosest, Walk, AnyWalk>::type;

// The walk state of the ray (a = o.xyz, t_lo; b = d.xyz, t_hi) over the
// caller's stack arrays.
template <bool kClosest>
__device__ __forceinline__ void start_walk(WalkOf<kClosest>& w, float4 a, float4 b, int* stk_ref,
                                           float* stk_t) {
  w.r = make_ray(a, b);
  w.t_lo = a.w;
  w.t_hi = b.w;
  if constexpr (kClosest) {
    w.stk_ref = stk_ref;
    w.stk_t = stk_t;
    w.best = Best{b.w, 0.f, 0.f, kIdMiss};
  } else {
    w.stk = stk_ref;
    w.found = false;
  }
}

// Is the ray still looking for a hit (any hit: tested and not occluded)?
template <bool kClosest>
__device__ __forceinline__ bool pending(const WalkOf<kClosest>& w, bool act) {
  if constexpr (kClosest) {
    return act;
  } else {
    return act && !w.found;
  }
}

// Closest hit: the f32 bits of the ray's best_t, INT_MIN for a ray not
// tested (a block's largest is its cutoff).
template <bool kClosest>
__device__ __forceinline__ int cut_bits(const WalkOf<kClosest>& w, bool act) {
  if constexpr (kClosest) {
    return act ? __float_as_int(w.best.t) : INT_MIN;
  } else {
    return INT_MIN;
  }
}

// One ray's visit of a staged treelet, the step both walks share: the
// ray's own entry key for the treelet's box (box[r * stride]: lo.xyz,
// hi.xyz, valid) over [t_lo, min(t_hi, best_t)] for closest hit and
// [t_lo, t_hi] for any hit, `bits` low bits cleared; if it is live (closest
// hit: its lower bound below best_t's bits; any hit: the ray not yet
// occluded) the ray walks the staged sub-BVH from `root`. `stage` holds the
// treelet's triangles, then its child-pair rows; m = (first triangle,
// count, first pair row, pair count).
template <bool kClosest>
__device__ __forceinline__ void visit_staged(WalkOf<kClosest>& w, bool act, const float* box, int stride,
                                             int bits, const float4* stage, int4 m, int root) {
  auto key = [&](float hi) {
    return entry_key(box[0], box[stride], box[2 * stride], box[3 * stride], box[4 * stride],
                     box[5 * stride], box[6 * stride], w.r, w.t_lo, hi, bits, 0);
  };
  bool go;
  if constexpr (kClosest) {
    const int k = act ? key(min_nan(w.t_hi, w.best.t)) : kKeyMiss;
    go = k != kKeyMiss && (k & ~((1 << bits) - 1)) < __float_as_int(w.best.t);
  } else {
    go = pending<false>(w, act) && key(w.t_hi) != kKeyMiss;
  }
  if (go) {
    w.ref = root;
    w.template run<false>(stage + kStageTriF4, stage, m.x, 8 * m.z, 2 * m.w + 1);
  }
}

template <bool kClosest>
__device__ __forceinline__ void write_result(const WalkOf<kClosest>& w, int i, bool act,
                                             float* __restrict__ out_t, int* __restrict__ out_tri,
                                             float* __restrict__ out_u, float* __restrict__ out_v,
                                             bool* __restrict__ out_hit) {
  if constexpr (kClosest) {
    const bool hit = act && w.best.id < kIdMiss;
    out_t[i] = hit ? w.best.t : FLT_MAX;
    out_tri[i] = hit ? w.best.id : -1;
    out_u[i] = hit ? w.best.u : 0.f;
    out_v[i] = hit ? w.best.v : 0.f;
  } else {
    out_hit[i] = act && w.found;
  }
}

// ---------------------------------------------------------------------------
// Schedule-fed walk
// ---------------------------------------------------------------------------

template <bool kClosest, int kStack>
__global__ void __launch_bounds__(kTile)
schedule_kernel(const float4* __restrict__ rays, const int* __restrict__ sched,
                const float* __restrict__ blk_box, const float4* __restrict__ tris,
                const float4* __restrict__ pairs, const int* __restrict__ row_first,
                const int* __restrict__ row_count, const int* __restrict__ row_pair_first,
                const int* __restrict__ row_pair_count, const int* __restrict__ row_root, int v,
                int s_b, int bits_g, float* __restrict__ out_t, int* __restrict__ out_tri,
                float* __restrict__ out_u, float* __restrict__ out_v, bool* __restrict__ out_hit) {
  extern __shared__ int keys[];  // the tile's schedule row, v keys
  __shared__ __align__(128) float4 stage_s[2][kStageF4];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int red[kWarps];
  __shared__ int4 meta_s[2];     // stage q's treelet: first, count, pair_first, pair_count
  __shared__ int root_s[2];      // its root's local ref
  __shared__ float box_s[2][8];  // its box: lo.xyz, hi.xyz, valid
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kTile + tid;
  const float4 a = rays[2 * i], bq = rays[2 * i + 1];
  const bool act = tested(a, bq);
  int stk_ref[kStack];  // the walk's stack: refs, and entry t for closest hit
  float stk_t[kClosest ? kStack : 1];
  WalkOf<kClosest> w;
  start_walk<kClosest>(w, a, bq, stk_ref, stk_t);
  const int gmask = (1 << bits_g) - 1;
  uint32_t parity = 0;  // bit q: the phase of bar[q] to wait for next
  auto wait_stage = [&](int q) {
    bar_wait(&bar[q], (parity >> q) & 1u);
    parity ^= 1u << q;
  };
  for (int e = tid; e < v; e += kTile) keys[e] = sched[(size_t)blockIdx.x * v + e];
  if (tid == 0) init_stage_bars(bar);
  __syncthreads();
  int cut = kClosest ? block_max(cut_bits<kClosest>(w, act), red) : 0;
  // ascending keys: the first past the cutoff, or a miss, ends the row
  auto visit = [&](int p) {
    return p < v && keys[p] != kKeyMiss && (!kClosest || (keys[p] & ~gmask) < cut);
  };
  // Thread 0: stage treelet row g into stage q, its meta, root and box
  // beside it; the stores reach the other threads with the barrier's phase
  // (the arrival releases them, the wait acquires them).
  auto prefetch = [&](int q, int g) {
    const int4 m = make_int4(row_first[g], min(row_count[g], kMaxC), row_pair_first[g],
                             min(row_pair_count[g], kMaxC - 1));
    meta_s[q] = m;
    root_s[q] = row_root[g];
    const float* box = blk_box + (size_t)(g / s_b) * 8 * s_b + g % s_b;
    for (int r = 0; r < 7; ++r) box_s[q][r] = box[r * s_b];
    stage_bulk(stage_s[q], &bar[q], tris, pairs, m);
  };
  int pos = visit(0) ? 0 : v, q = 0;
  if (pos < v && tid == 0) prefetch(q, keys[pos] & gmask);
  while (pos < v) {
    int nx = visit(pos + 1) ? pos + 1 : v;
    if (nx < v && tid == 0) prefetch(q ^ 1, keys[nx] & gmask);
    wait_stage(q);
    visit_staged<kClosest>(w, act, box_s[q], 1, bits_g, stage_s[q], meta_s[q], root_s[q]);
    // the barriers below also end every read of stage q
    if constexpr (kClosest) {
      cut = block_max(cut_bits<kClosest>(w, act), red);
    } else if (!__syncthreads_or(pending<false>(w, act))) {
      if (nx < v) wait_stage(q ^ 1);  // the copy in flight lands unused
      break;
    }
    q ^= 1;
    if (nx < v && !visit(nx)) {  // the staged treelet lies past the new cutoff
      wait_stage(q);             // its copy lands unused
      nx = v;
    }
    pos = nx;
  }
  write_result<kClosest>(w, i, act, out_t, out_tri, out_u, out_v, out_hit);
}

// ---------------------------------------------------------------------------
// Superblock select walk
// ---------------------------------------------------------------------------

template <bool kClosest, int kStack>
__global__ void __launch_bounds__(kTile)
select_kernel(const float4* __restrict__ rays, const float* __restrict__ sb_box,
              const float* __restrict__ blk_box, const float4* __restrict__ tris,
              const float4* __restrict__ pairs, const int* __restrict__ row_first,
              const int* __restrict__ row_count, const int* __restrict__ row_pair_first,
              const int* __restrict__ row_pair_count, const int* __restrict__ row_root, int ns, int nsp,
              int s_b, int bits_ns, int bits_sb, float* __restrict__ out_t,
              int* __restrict__ out_tri, float* __restrict__ out_u, float* __restrict__ out_v,
              bool* __restrict__ out_hit) {
  __shared__ int colmin[kMaxNSp];
  __shared__ float blk_s[8 * kMaxSB];
  __shared__ int tcol[kMaxSB];
  __shared__ int order[kMaxSB];     // live slots in ascending key
  __shared__ int4 meta[kMaxSB];     // slot k: first, count, pair_first, pair_count
  __shared__ int root_s[kMaxSB];    // slot k: the root's local ref
  __shared__ __align__(128) float4 stage_s[2][kStageF4];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int red[kWarps];
  const int tid = threadIdx.x, lane = tid & 31;
  const int i = blockIdx.x * kTile + tid;
  const float4 a = rays[2 * i], bq = rays[2 * i + 1];
  const bool act = tested(a, bq);
  const float t_lo = a.w, t_hi = bq.w;
  int stk_ref[kStack];  // the walk's stack: refs, and entry t for closest hit
  float stk_t[kClosest ? kStack : 1];
  WalkOf<kClosest> w;
  start_walk<kClosest>(w, a, bq, stk_ref, stk_t);
  const Ray& r = w.r;
  const int mask_ns = (1 << bits_ns) - 1, mask_sb = (1 << bits_sb) - 1;
  uint32_t parity = 0;  // bit q: the phase of bar[q] to wait for next

  auto best_t = [&]() {  // closest hit: the running best; any hit: t_hi
    if constexpr (kClosest) {
      return w.best.t;
    } else {
      return t_hi;
    }
  };
  auto sb_key = [&](int s) {
    return act ? entry_key(sb_box[s], sb_box[nsp + s], sb_box[2 * nsp + s], sb_box[3 * nsp + s],
                           sb_box[4 * nsp + s], sb_box[5 * nsp + s], sb_box[6 * nsp + s], r, t_lo,
                           t_hi, bits_ns, s)
               : kKeyMiss;
  };
  auto slot_key = [&](int k, float hi) {
    return entry_key(blk_s[k], blk_s[s_b + k], blk_s[2 * s_b + k], blk_s[3 * s_b + k], blk_s[4 * s_b + k],
                     blk_s[5 * s_b + k], blk_s[6 * s_b + k], r, t_lo, hi, bits_sb, k);
  };
  auto wait_stage = [&](int q) {
    bar_wait(&bar[q], (parity >> q) & 1u);
    parity ^= 1u << q;
  };

  if (tid == 0) init_stage_bars(bar);
  // 1. the column-min of every superblock's entry keys (the ns real
  //    columns: a pad column's inverted box always misses)
  for (int s = tid; s < ns; s += kTile) colmin[s] = kKeyMiss;
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    const int m = __reduce_min_sync(0xffffffffu, sb_key(s));
    if (lane == 0) atomicMin(&colmin[s], m);
  }
  __syncthreads();
  int cut = kClosest ? block_max(act ? __float_as_int(best_t()) : INT_MIN, red) : 0;

  // 2. superblocks front to back, each once (any hit: until every tested ray is occluded)
  bool occluded = false;
  for (int pick = 0; pick < ns && !occluded; ++pick) {
    int m = kKeyMiss;
    for (int s = tid; s < ns; s += kTile) m = min(m, colmin[s]);
    m = block_min(m, red);
    if (m == kKeyMiss) break;
    const int s = m & mask_ns;
    if (tid == s % kTile) colmin[s] = kKeyMiss;  // only this thread reads colmin[s]
    if (kClosest ? (m & ~mask_ns) >= cut : !__syncthreads_or(pending<kClosest>(w, act))) break;
    const int own = sb_key(s);
    const bool live = own != kKeyMiss &&
                      (kClosest ? (own & ~mask_ns) < __float_as_int(best_t()) : pending<kClosest>(w, act));
    if (!__syncthreads_or(live)) continue;

    // 3. the column-min of the superblock's treelet keys over its slots up
    //    to its last real treelet (a pad slot's inverted box always
    //    misses), and its live slots in ascending key (front to back)
    const float* blk = blk_box + (size_t)s * 8 * s_b;
    for (int x = tid; x < 8 * s_b; x += kTile) blk_s[x] = blk[x];
    int last = 0;
    for (int k = tid; k < s_b; k += kTile) {
      const int g = s * s_b + k;
      tcol[k] = kKeyMiss;
      meta[k] = make_int4(row_first[g], min(row_count[g], kMaxC), row_pair_first[g],
                          min(row_pair_count[g], kMaxC - 1));
      root_s[k] = row_root[g];
      if (row_count[g] > 0) last = k + 1;
    }
    const int n_slots = block_max(last, red);  // its barriers publish the stores above
    const float hi = kClosest ? min_nan(t_hi, best_t()) : t_hi;
    const bool keyed = pending<kClosest>(w, act);
    for (int k = 0; k < n_slots; ++k) {
      const int km = __reduce_min_sync(0xffffffffu, keyed ? slot_key(k, hi) : kKeyMiss);
      if (lane == 0) atomicMin(&tcol[k], km);
    }
    __syncthreads();
    bool live_slot = false;
    if (tid < n_slots) {
      const int key = tcol[tid];
      live_slot = key != kKeyMiss;
      if (live_slot) {
        int rank = 0;  // live keys differ in their low bits; kKeyMiss is the largest
        for (int j = 0; j < n_slots; ++j) rank += tcol[j] < key;
        order[rank] = tid;
      }
    }
    const int nl = __syncthreads_count(live_slot);

    // 4. the slots: each staged by bulk copies, the next one's copy started
    //    before this one is walked, and visited (visit_staged)
    // ascending keys: the first slot past the cutoff ends the superblock
    auto visit = [&](int p) { return p < nl && (!kClosest || (tcol[order[p]] & ~mask_sb) < cut); };
    int pos = visit(0) ? 0 : nl, q = 0;
    if (pos < nl && tid == 0) stage_bulk(stage_s[q], &bar[q], tris, pairs, meta[order[pos]]);
    while (pos < nl) {
      const int k = order[pos];
      int nx = visit(pos + 1) ? pos + 1 : nl;
      if (nx < nl && tid == 0) stage_bulk(stage_s[q ^ 1], &bar[q ^ 1], tris, pairs, meta[order[nx]]);
      wait_stage(q);
      visit_staged<kClosest>(w, act, blk_s + k, s_b, bits_sb, stage_s[q], meta[k], root_s[k]);
      // the barriers below also end every read of stage q
      if constexpr (kClosest) {
        cut = block_max(act ? __float_as_int(best_t()) : INT_MIN, red);
      } else if (!__syncthreads_or(pending<kClosest>(w, act))) {
        if (nx < nl) wait_stage(q ^ 1);  // the copy in flight lands unused
        occluded = true;
        break;
      }
      q ^= 1;
      if (nx < nl && !visit(nx)) {  // the staged slot lies past the new cutoff
        wait_stage(q);              // its copy lands unused
        nx = nl;
      }
      pos = nx;
    }
  }
  write_result<kClosest>(w, i, act, out_t, out_tri, out_u, out_v, out_hit);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising its
// limit first where the launch needs more than the default allows.
template <class K, class... Args>
int launch(K kernel, int blocks, size_t smem, void* stream, Args... args) {
  if (smem > kPlainDynSmem) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, kTile, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <bool kClosest>
int launch_schedule(const float* rays, const int* sched, const float* blk_box, const float* tris,
                    const float* pairs, const int* row_first, const int* row_count,
                    const int* row_pair_first, const int* row_pair_count, const int* row_root, int n_tiles,
                    int v, int s_b, int bits_g, int tdepth, float* out_t, int* out_tri, float* out_u,
                    float* out_v, bool* out_hit, void* stream) {
  if (tdepth > kStackMax) return (int)cudaErrorInvalidValue;
  auto kernel = tdepth <= kStackSmall ? schedule_kernel<kClosest, kStackSmall>
                                      : schedule_kernel<kClosest, kStackMax>;
  return launch(kernel, n_tiles, (size_t)v * sizeof(int), stream, reinterpret_cast<const float4*>(rays), sched,
                blk_box, reinterpret_cast<const float4*>(tris), reinterpret_cast<const float4*>(pairs), row_first,
                row_count, row_pair_first, row_pair_count, row_root, v, s_b, bits_g, out_t, out_tri, out_u,
                out_v, out_hit);
}

template <bool kClosest>
int launch_select(const float* rays, const float* sb_box, const float* blk_box, const float* tris,
                  const float* pairs, const int* row_first, const int* row_count,
                  const int* row_pair_first, const int* row_pair_count, const int* row_root,
                  int n_tiles, int ns, int nsp, int s_b, int bits_ns, int bits_sb, int tdepth,
                  float* out_t, int* out_tri, float* out_u, float* out_v, bool* out_hit, void* stream) {
  if (tdepth > kStackMax) return (int)cudaErrorInvalidValue;
  auto kernel = tdepth <= kStackSmall ? select_kernel<kClosest, kStackSmall>
                                      : select_kernel<kClosest, kStackMax>;
  return launch(kernel, n_tiles, 0, stream, reinterpret_cast<const float4*>(rays), sb_box, blk_box,
                reinterpret_cast<const float4*>(tris), reinterpret_cast<const float4*>(pairs), row_first,
                row_count, row_pair_first, row_pair_count, row_root, ns, nsp, s_b, bits_ns, bits_sb, out_t,
                out_tri, out_u, out_v, out_hit);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
// rays: n_tiles * kTile packed rays (ops/woop.pack_rays), sorted and padded.

// The schedule of `ns` real superblocks of the nsp columns of sb_box: sched
// i32[n_tiles, v], incomplete bool[n_tiles], n_live i32[n_tiles]
// (v <= 8192).
int schedule_prepass(const float* rays, const float* sb_box, const float* blk_box, int n_tiles, int ns,
                     int nsp, int s_b, int v, int bits_g, int* sched, bool* incomplete, int* n_live,
                     void* stream) {
  int vp = 1;
  while (vp < v) vp <<= 1;
  return launch(schedule_prepass_kernel, n_tiles, (size_t)vp * sizeof(int), stream,
                reinterpret_cast<const float4*>(rays), sb_box, blk_box, ns, nsp, s_b, v, bits_g, sched,
                incomplete, n_live);
}

// schedule_* and select_*: `tdepth` (TreeletSet.tdepth) picks the stack.
int schedule_closest(const float* rays, const int* sched, const float* blk_box, const float* tris,
                     const float* pairs, const int* row_first, const int* row_count,
                     const int* row_pair_first, const int* row_pair_count, const int* row_root, int n_tiles,
                     int v, int s_b, int bits_g, int tdepth, float* out_t, int* out_tri, float* out_u,
                     float* out_v, void* stream) {
  return launch_schedule<true>(rays, sched, blk_box, tris, pairs, row_first, row_count, row_pair_first,
                               row_pair_count, row_root, n_tiles, v, s_b, bits_g, tdepth, out_t, out_tri,
                               out_u, out_v, nullptr, stream);
}

int schedule_any(const float* rays, const int* sched, const float* blk_box, const float* tris,
                 const float* pairs, const int* row_first, const int* row_count, const int* row_pair_first,
                 const int* row_pair_count, const int* row_root, int n_tiles, int v, int s_b, int bits_g,
                 int tdepth, bool* out_hit, void* stream) {
  return launch_schedule<false>(rays, sched, blk_box, tris, pairs, row_first, row_count, row_pair_first,
                                row_pair_count, row_root, n_tiles, v, s_b, bits_g, tdepth, nullptr, nullptr,
                                nullptr, nullptr, out_hit, stream);
}

// select_*: `ns` real superblocks of the nsp columns of sb_box.
int select_closest(const float* rays, const float* sb_box, const float* blk_box, const float* tris,
                   const float* pairs, const int* row_first, const int* row_count,
                   const int* row_pair_first, const int* row_pair_count, const int* row_root,
                   int n_tiles, int ns, int nsp, int s_b, int bits_ns, int bits_sb, int tdepth,
                   float* out_t, int* out_tri, float* out_u, float* out_v, void* stream) {
  return launch_select<true>(rays, sb_box, blk_box, tris, pairs, row_first, row_count, row_pair_first,
                             row_pair_count, row_root, n_tiles, ns, nsp, s_b, bits_ns, bits_sb, tdepth,
                             out_t, out_tri, out_u, out_v, nullptr, stream);
}

int select_any(const float* rays, const float* sb_box, const float* blk_box, const float* tris,
               const float* pairs, const int* row_first, const int* row_count,
               const int* row_pair_first, const int* row_pair_count, const int* row_root, int n_tiles,
               int ns, int nsp, int s_b, int bits_ns, int bits_sb, int tdepth, bool* out_hit,
               void* stream) {
  return launch_select<false>(rays, sb_box, blk_box, tris, pairs, row_first, row_count, row_pair_first,
                              row_pair_count, row_root, n_tiles, ns, nsp, s_b, bits_ns, bits_sb, tdepth,
                              nullptr, nullptr, nullptr, nullptr, out_hit, stream);
}

}  // extern "C"
