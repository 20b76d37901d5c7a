// Treelet traversal kernels for Hopper (sm_90a): schedule-fed and
// superblock-select closest hit and any hit.
//
// Replace the TPU kernels of mcpt_tpu/ops/pallas/schedule.py
// (_closest_kernel, _any_kernel; pallas_call sites in
// closest_hit_schedule_impl and any_hit_schedule_impl) and of
// mcpt_tpu/ops/pallas/select.py (_closest_kernel, _any_kernel; pallas_call
// sites in closest_hit_treelets_smem and any_hit_treelets_smem). Same
// function as the BVH traversal (traverse.cu): the closest (t, tri, u, v),
// or whether any hit exists, of each ray, with the reference accept
// predicates (src/Triangle.cpp:48-78 closest, 83-106 any) and the lowest
// triangle id on equal t.
//
// Design. One block of kTile threads per tile of kTile sorted rays, one
// thread a ray. The treelet layout (ops/treelets.py) groups the BVH-ordered
// triangles into treelets of <= 128 and the treelets into superblocks. The
// four kernels share one step, test_closest / test_any: the block stages a
// treelet's triangles in shared memory (thread j loads triangle j), and
// every thread tests its ray against all of them. What differs is how the
// treelets are chosen:
//   * schedule_*: the tile's row of the pre-pass's key schedule (ops/
//     schedule.py build_schedule), front to back; closest hit stops when the
//     next key's lower bound is >= every tested ray's best_t (int compare of
//     f32 bits), any hit when every tested ray is occluded;
//   * select_*: superblocks in ascending column-min of the rays' entry keys
//     (atomicMin into shared memory), skipped unless a ray's own key is live,
//     and inside one the slots in slot order against the column-min of the
//     treelet keys and (closest) the cutoff, the largest best_t bits of the
//     block, refreshed after every treelet (ops/select.py).
// Exit tests are block reductions (__syncthreads_or, warp __reduce_*_sync and
// a shared word a warp), so every barrier sits in block-uniform control flow:
// trip counts come from shared memory or from reductions. Loops are bounded
// by the schedule's length, the superblock and slot counts, and the
// treelet's triangle count.
//
// Arithmetic: ray_common.cuh's Moller-Trumbore and NaN-propagating min/max,
// and the entry keys below, in the order of the plain versions (ops/
// schedule.py, ops/select.py), so each kernel agrees with its plain version
// bit for bit, and with the BVH traversal wherever both test a triangle.
//
// Bound on this card: ~60 FP32 operations per (ray, triangle) test over the
// staged treelets, and for select ~20 per (ray, box) entry key; every tested
// ray of a block tests every triangle of every treelet the block visits.
// TMA staging, a double buffer and wgmma wait for a later PR.

#include <climits>
#include <cmath>

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

template <bool kClosest>
__global__ void __launch_bounds__(kTile)
select_kernel(const float4* __restrict__ rays, const float* __restrict__ sb_box,
              const float* __restrict__ blk_box, const float4* __restrict__ tris,
              const int* __restrict__ row_first, const int* __restrict__ row_count, int nsp, int s_b,
              int bits_ns, int bits_sb, float* __restrict__ out_t, int* __restrict__ out_tri,
              float* __restrict__ out_u, float* __restrict__ out_v, bool* __restrict__ out_hit) {
  __shared__ int colmin[kMaxNSp];
  __shared__ float blk_s[8 * kMaxSB];
  __shared__ int tcol[kMaxSB];
  __shared__ float4 tri_s[3 * kMaxC];
  __shared__ int red[kWarps];
  const int tid = threadIdx.x, lane = tid & 31;
  const int i = blockIdx.x * kTile + tid;
  const float4 a = rays[2 * i], bq = rays[2 * i + 1];
  const bool act = tested(a, bq);
  const Ray r = make_ray(a, bq);
  const float t_lo = a.w, t_hi = bq.w;
  Closest b{t_hi, 0.f, 0.f, kIdMiss};
  bool found = false;
  const int mask_ns = (1 << bits_ns) - 1, mask_sb = (1 << bits_sb) - 1;

  auto sb_key = [&](int s) {
    return act ? entry_key(sb_box[s], sb_box[nsp + s], sb_box[2 * nsp + s], sb_box[3 * nsp + s],
                           sb_box[4 * nsp + s], sb_box[5 * nsp + s], sb_box[6 * nsp + s], r, t_lo,
                           t_hi, bits_ns, s)
               : kKeyMiss;
  };
  // 1. the column-min of every superblock's entry keys
  for (int s = tid; s < nsp; s += kTile) colmin[s] = kKeyMiss;
  __syncthreads();
  for (int s = 0; s < nsp; ++s) {
    const int m = __reduce_min_sync(0xffffffffu, sb_key(s));
    if (lane == 0) atomicMin(&colmin[s], m);
  }
  __syncthreads();
  int cut = kClosest ? block_max(act ? __float_as_int(b.t) : INT_MIN, red) : 0;

  // 2. superblocks front to back, each once
  for (int pick = 0; pick < nsp; ++pick) {
    int m = kKeyMiss;
    for (int s = tid; s < nsp; s += kTile) m = min(m, colmin[s]);
    m = block_min(m, red);
    if (m == kKeyMiss) break;
    const int s = m & mask_ns;
    if (tid == s % kTile) colmin[s] = kKeyMiss;  // only this thread reads colmin[s]
    if (kClosest ? (m & ~mask_ns) >= cut : !__syncthreads_or(act && !found)) break;
    const int own = sb_key(s);
    const bool live = own != kKeyMiss && (kClosest ? (own & ~mask_ns) < __float_as_int(b.t) : !found);
    if (!__syncthreads_or(live)) continue;

    // 3. the column-min of the superblock's treelet keys, then its slots
    const float* blk = blk_box + (size_t)s * 8 * s_b;
    for (int x = tid; x < 8 * s_b; x += kTile) blk_s[x] = blk[x];
    for (int k = tid; k < s_b; k += kTile) tcol[k] = kKeyMiss;
    __syncthreads();
    const float hi = kClosest ? min_nan(t_hi, b.t) : t_hi;
    const bool keyed = kClosest ? act : act && !found;
    for (int k = 0; k < s_b; ++k) {
      const int key = keyed ? entry_key(blk_s[k], blk_s[s_b + k], blk_s[2 * s_b + k], blk_s[3 * s_b + k],
                                        blk_s[4 * s_b + k], blk_s[5 * s_b + k], blk_s[6 * s_b + k], r,
                                        t_lo, hi, bits_sb, k)
                            : kKeyMiss;
      const int km = __reduce_min_sync(0xffffffffu, key);
      if (lane == 0) atomicMin(&tcol[k], km);
    }
    __syncthreads();
    for (int k = 0; k < s_b; ++k) {
      const int tk = tcol[k];
      if (tk == kKeyMiss || (kClosest && (tk & ~mask_sb) >= cut)) continue;
      const int g = s * s_b + k;
      const int first = __ldg(&row_first[g]), cnt = min(__ldg(&row_count[g]), kMaxC);
      stage(tri_s, tris, first, cnt);
      __syncthreads();
      if (kClosest) {
        if (act) test_closest(tri_s, first, cnt, r, t_lo, t_hi, b);
        cut = block_max(act ? __float_as_int(b.t) : INT_MIN, red);  // its barriers free tri_s
      } else {
        if (act && !found) found = test_any(tri_s, cnt, r, t_lo, t_hi);
        if (!__syncthreads_or(act && !found)) goto done;
      }
    }
  }
done:
  if (kClosest)
    write_closest(i, act, b, out_t, out_tri, out_u, out_v);
  else
    out_hit[i] = act && found;
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

int select_closest(const float* rays, const float* sb_box, const float* blk_box, const float* tris,
                   const int* row_first, const int* row_count, int n_tiles, int nsp, int s_b,
                   int bits_ns, int bits_sb, float* out_t, int* out_tri, float* out_u, float* out_v,
                   void* stream) {
  select_kernel<true><<<n_tiles, kTile, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), sb_box, blk_box, reinterpret_cast<const float4*>(tris),
      row_first, row_count, nsp, s_b, bits_ns, bits_sb, out_t, out_tri, out_u, out_v, nullptr);
  return (int)cudaGetLastError();
}

int select_any(const float* rays, const float* sb_box, const float* blk_box, const float* tris,
               const int* row_first, const int* row_count, int n_tiles, int nsp, int s_b, int bits_ns,
               int bits_sb, bool* out_hit, void* stream) {
  select_kernel<false><<<n_tiles, kTile, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), sb_box, blk_box, reinterpret_cast<const float4*>(tris),
      row_first, row_count, nsp, s_b, bits_ns, bits_sb, nullptr, nullptr, nullptr, nullptr, out_hit);
  return (int)cudaGetLastError();
}

}  // extern "C"
