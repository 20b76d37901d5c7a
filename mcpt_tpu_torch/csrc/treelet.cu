// Treelet traversal kernels for Hopper (sm_90a): schedule-fed and
// superblock-select closest hit and any hit.
//
// Replace the TPU kernels of mcpt_tpu/ops/pallas/schedule.py
// (_closest_kernel :253, _any_kernel :361; pallas_call sites in
// closest_hit_schedule_impl and any_hit_schedule_impl) and of
// mcpt_tpu/ops/pallas/select.py (_closest_kernel :80, _any_kernel :258;
// pallas_call sites in closest_hit_treelets_smem and any_hit_treelets_smem).
// Same function as the BVH traversal (traverse.cu): the closest (t, tri, u,
// v), or whether any hit exists, of each ray, with the reference accept
// predicates (src/Triangle.cpp:48-78 closest, 83-106 any) and the lowest
// triangle id on equal t.
//
// One block of kTile threads per tile of kTile sorted rays, one thread a
// ray. The treelet layout (ops/treelets.py) groups the BVH-ordered
// triangles into treelets (BVH subtrees of <= 128 triangles) and the
// treelets into superblocks.
//
// schedule_*: the tile's row of the pre-pass's key schedule (ops/
// schedule.py build_schedule), front to back; for each key the block stages
// the treelet's triangles (thread j loads triangle j) and every tested ray
// tests all of them (test_closest / test_any). Closest hit stops when the
// next key's lower bound is >= every tested ray's best_t (int compare of
// f32 bits), any hit when every tested ray is occluded.
//
// select_*: the TPU kernel tested every ray of a tile against every
// triangle of every treelet the tile visited, because a TPU core has no
// per-lane control flow and chose treelets on its scalar core. Here the
// block does what gains from sharing, choosing and staging a treelet, and
// each ray walks only the part of it that it enters:
//   1. superblocks in ascending column-min of the rays' entry keys
//      (atomicMin into shared memory), skipped unless a ray's own key is
//      live; closest hit stops at the cutoff (the block's largest best_t
//      bits), any hit when every tested ray is occluded;
//   2. the superblock's treelet keys, their column-min per slot, and the
//      live slots ranked by key (front to back); closest hit stops at the
//      first slot whose lower bound is >= the cutoff, refreshed after every
//      treelet;
//   3. each treelet's triangles and child-pair rows (its sub-BVH, a run of
//      TraversalSet.pairs) reach shared memory by two 1-D bulk copies
//      (cp.async.bulk) issued by one thread and completed on an mbarrier,
//      two stages deep: the next treelet's copy starts before the block
//      walks the current one;
//   4. a ray whose own key for the treelet (the slab test of its root box
//      at the ray's current best_t) is live walks the staged sub-BVH with
//      ray_common.cuh's Walk / AnyWalk, the BVH traversal's step, rebasing
//      each ref it reads to the staged rows and triangles; a warp with no
//      such ray skips the walk.
// Exit tests are block reductions (__syncthreads_or, warp __reduce_*_sync and
// a shared word a warp), so every barrier sits in block-uniform control flow:
// trip counts come from shared memory or from reductions. Loops are bounded
// by the schedule's length, the superblock and slot counts, the treelet's
// triangle count and, for a walk, its rows and leaves.
//
// Arithmetic: ray_common.cuh's Moller-Trumbore, slab test and NaN-
// propagating min/max, and the entry keys below, in the order of the plain
// versions (ops/schedule.py, ops/select.py), so each kernel agrees with its
// plain version bit for bit, and with the BVH traversal wherever both test
// a triangle.
//
// Bound on this card: FP32 operations. The schedule pair does ~60 a (ray,
// triangle) test over its staged treelets, every tested ray against every
// triangle of every treelet in the tile's schedule; its staging is one
// buffer of per-thread loads. The select pair does ~31 a (ray, box) entry
// key (every superblock for every tested ray, every slot of each superblock
// its tile takes, and the root of each treelet it walks), ~29 a child-pair
// row visit and ~56 a triangle test, only in the leaves a ray reaches;
// its staging (at most 14,272 bytes a treelet) overlaps the previous
// treelet's walk.

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

// Stage treelet row g's triangles (three float4 each) in shared memory.
__device__ __forceinline__ void stage(float4* tri_s, const float4* __restrict__ tris, int first,
                                      int cnt) {
  for (int j = threadIdx.x; j < cnt; j += kTile) {
    tri_s[3 * j] = __ldg(&tris[3 * (first + j)]);
    tri_s[3 * j + 1] = __ldg(&tris[3 * (first + j) + 1]);
    tri_s[3 * j + 2] = __ldg(&tris[3 * (first + j) + 2]);
  }
}

struct Closest {
  float t, u, v;
  int id;
};

// The ray against the staged treelet (triangles first .. first + cnt - 1):
// keep the smallest (t, id) that passes the closest-hit predicate.
__device__ __forceinline__ void test_closest(const float4* tri_s, int first, int cnt, const Ray& r,
                                             float t_lo, float t_hi, Closest& b) {
  for (int j = 0; j < cnt; ++j) {
    const Tuv h = mt_tri(tri_s[3 * j], tri_s[3 * j + 1], tri_s[3 * j + 2], r, kDetClosest);
    const int id = first + j;
    if (h.ok && h.t >= t_lo && h.t < t_hi && h.t <= b.t && h.u >= 0.f && h.v >= 0.f &&
        __fsub_rn(__fsub_rn(1.0f, h.u), h.v) >= 0.f && (h.t < b.t || id < b.id)) {
      b.t = h.t;
      b.id = id;
      b.u = h.u;
      b.v = h.v;
    }
  }
}

// The ray against the staged treelet: is there an any-hit accept?
__device__ __forceinline__ bool test_any(const float4* tri_s, int cnt, const Ray& r, float t_lo,
                                         float t_hi) {
  for (int j = 0; j < cnt; ++j) {
    const Tuv h = mt_tri(tri_s[3 * j], tri_s[3 * j + 1], tri_s[3 * j + 2], r, kDetAny);
    if (h.ok && h.u >= 0.f && h.u <= 1.0f && h.v >= 0.f && __fadd_rn(h.u, h.v) <= 1.0f &&
        h.t >= t_lo && h.t <= t_hi)
      return true;
  }
  return false;
}

__device__ __forceinline__ void write_closest(int i, bool act, const Closest& b, float* out_t,
                                              int* out_tri, float* out_u, float* out_v) {
  const bool hit = act && b.id < kIdMiss;
  out_t[i] = hit ? b.t : FLT_MAX;
  out_tri[i] = hit ? b.id : -1;
  out_u[i] = hit ? b.u : 0.f;
  out_v[i] = hit ? b.v : 0.f;
}

// ---------------------------------------------------------------------------
// Schedule-fed walk
// ---------------------------------------------------------------------------

template <bool kClosest>
__global__ void __launch_bounds__(kTile)
schedule_kernel(const float4* __restrict__ rays, const int* __restrict__ sched,
                const float4* __restrict__ tris, const int* __restrict__ row_first,
                const int* __restrict__ row_count, int v, int bits_g, float* __restrict__ out_t,
                int* __restrict__ out_tri, float* __restrict__ out_u, float* __restrict__ out_v,
                bool* __restrict__ out_hit) {
  __shared__ float4 tri_s[3 * kMaxC];
  extern __shared__ int keys[];  // the tile's schedule row, v keys
  const int tile = blockIdx.x;
  const int i = tile * kTile + threadIdx.x;
  for (int e = threadIdx.x; e < v; e += kTile) keys[e] = sched[(size_t)tile * v + e];
  const float4 a = rays[2 * i], bq = rays[2 * i + 1];
  const bool act = tested(a, bq);
  const Ray r = make_ray(a, bq);
  Closest b{bq.w, 0.f, 0.f, kIdMiss};
  bool found = false;
  const int gmask = (1 << bits_g) - 1;
  __syncthreads();
  for (int e = 0; e < v; ++e) {
    const int key = keys[e];
    if (key == kKeyMiss) break;  // a blanked (incomplete) row ends at once
    const int g = key & gmask;
    const int first = __ldg(&row_first[g]), cnt = min(__ldg(&row_count[g]), kMaxC);
    stage(tri_s, tris, first, cnt);
    __syncthreads();
    if (kClosest) {
      if (act) test_closest(tri_s, first, cnt, r, a.w, bq.w, b);
    } else if (act && !found) {
      found = test_any(tri_s, cnt, r, a.w, bq.w);
    }
    const int nxt = e + 1 < v ? keys[e + 1] : kKeyMiss;
    // the barrier also keeps tri_s until every thread has tested
    const bool more = kClosest ? act && __float_as_int(b.t) > (nxt & ~gmask) : act && !found;
    if (!__syncthreads_or(more) || nxt == kKeyMiss) break;
  }
  if (kClosest)
    write_closest(i, act, b, out_t, out_tri, out_u, out_v);
  else
    out_hit[i] = act && found;
}

// ---------------------------------------------------------------------------
// Superblock select walk
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
  typename std::conditional<kClosest, Walk, AnyWalk>::type w;
  w.r = make_ray(a, bq);
  w.t_lo = t_lo;
  w.t_hi = t_hi;
  if constexpr (kClosest) {
    w.stk_ref = stk_ref;
    w.stk_t = stk_t;
    w.best = Best{t_hi, 0.f, 0.f, kIdMiss};
  } else {
    w.stk = stk_ref;
    w.found = false;
  }
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
  auto pending = [&]() {
    if constexpr (kClosest) {
      return act;
    } else {
      return act && !w.found;
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

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
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
    if (kClosest ? (m & ~mask_ns) >= cut : !__syncthreads_or(pending())) break;
    const int own = sb_key(s);
    const bool live = own != kKeyMiss && (kClosest ? (own & ~mask_ns) < __float_as_int(best_t()) : pending());
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
    const bool keyed = pending();
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
    //    before this one is walked; each ray walks the staged sub-BVH if its
    //    own key for the treelet is live at its current best_t
    // ascending keys: the first slot past the cutoff ends the superblock
    auto visit = [&](int p) { return p < nl && (!kClosest || (tcol[order[p]] & ~mask_sb) < cut); };
    int pos = visit(0) ? 0 : nl, q = 0;
    if (pos < nl && tid == 0) stage_bulk(stage_s[q], &bar[q], tris, pairs, meta[order[pos]]);
    while (pos < nl) {
      const int k = order[pos];
      int nx = visit(pos + 1) ? pos + 1 : nl;
      if (nx < nl && tid == 0) stage_bulk(stage_s[q ^ 1], &bar[q ^ 1], tris, pairs, meta[order[nx]]);
      wait_stage(q);
      bool go;
      if constexpr (kClosest) {
        const int key = act ? slot_key(k, min_nan(t_hi, best_t())) : kKeyMiss;
        go = key != kKeyMiss && (key & ~mask_sb) < __float_as_int(best_t());
      } else {
        go = pending() && slot_key(k, t_hi) != kKeyMiss;
      }
      if (go) {
        const int4 mk = meta[k];
        w.ref = root_s[k];
        w.template run<false>(stage_s[q] + kStageTriF4, stage_s[q], mk.x, 8 * mk.z, 2 * mk.w + 1);
      }
      // the barriers below also end every read of stage q
      if constexpr (kClosest) {
        cut = block_max(act ? __float_as_int(best_t()) : INT_MIN, red);
      } else if (!__syncthreads_or(pending())) {
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

template <bool kClosest>
int launch_select(const float* rays, const float* sb_box, const float* blk_box, const float* tris,
                  const float* pairs, const int* row_first, const int* row_count,
                  const int* row_pair_first, const int* row_pair_count, const int* row_root,
                  int n_tiles, int ns, int nsp, int s_b, int bits_ns, int bits_sb, int tdepth,
                  float* out_t, int* out_tri, float* out_u, float* out_v, bool* out_hit, void* stream) {
  if (tdepth > kStackMax) return (int)cudaErrorInvalidValue;
  auto kernel = tdepth <= kStackSmall ? select_kernel<kClosest, kStackSmall>
                                      : select_kernel<kClosest, kStackMax>;
  kernel<<<n_tiles, kTile, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), sb_box, blk_box, reinterpret_cast<const float4*>(tris),
      reinterpret_cast<const float4*>(pairs), row_first, row_count, row_pair_first, row_pair_count,
      row_root, ns, nsp, s_b, bits_ns, bits_sb, out_t, out_tri, out_u, out_v, out_hit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
// rays: n_tiles * kTile packed rays (ops/woop.pack_rays), sorted and padded.

int schedule_closest(const float* rays, const int* sched, const float* tris, const int* row_first,
                     const int* row_count, int n_tiles, int v, int bits_g, float* out_t, int* out_tri,
                     float* out_u, float* out_v, void* stream) {
  schedule_kernel<true><<<n_tiles, kTile, v * sizeof(int), (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), sched, reinterpret_cast<const float4*>(tris), row_first,
      row_count, v, bits_g, out_t, out_tri, out_u, out_v, nullptr);
  return (int)cudaGetLastError();
}

int schedule_any(const float* rays, const int* sched, const float* tris, const int* row_first,
                 const int* row_count, int n_tiles, int v, int bits_g, bool* out_hit, void* stream) {
  schedule_kernel<false><<<n_tiles, kTile, v * sizeof(int), (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), sched, reinterpret_cast<const float4*>(tris), row_first,
      row_count, v, bits_g, nullptr, nullptr, nullptr, nullptr, out_hit);
  return (int)cudaGetLastError();
}

// select_*: `ns` real superblocks of the nsp columns of sb_box; `tdepth`
// (TreeletSet.tdepth) picks the stack.
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
