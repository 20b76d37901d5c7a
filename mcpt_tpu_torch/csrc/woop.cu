// Woop-transform closest-hit and any-hit kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels _closest_kernel and _any_kernel of
// mcpt_tpu/ops/pallas/woop.py (pallas_call sites in
// closest_hit_woop_fused_impl and any_hit_woop_fused_impl). Same function:
// each ray is tested against the BVH-ordered triangles of every chunk its
// tile may reach, with the reference accept predicates (src/Triangle.cpp:
// 48-78 closest, 85-103 any) and the lowest triangle id on equal t.
//
// Both kernels run one ray a thread over a 256-ray tile that is also the
// tile of the chunk mask, which the wrapper computes in torch (ops/woop.py,
// tile_chunk_mask) and which is conservative. For each live chunk the block
// stages the real triangles (the last chunk's pad columns, eps = F32_MAX,
// never accept and are not staged) in static shared memory, 64 bytes a
// triangle, array of structures: W row k and p[k] as one float4 for k = 0,
// 1, 2, then (eps, ordinary flag, 0, 0). A pair reads float4 broadcasts.
// Before the exact predicate, a division-free interval pre-test rejects
// what the exact path cannot accept; the comment before the pre-test
// derives its margins. The syncs sit only in code that the whole block
// runs.
//
// Closest hit: the block first packs its tested rays into its first
// threads; each thread then walks every staged triangle and keeps its best
// (t, id, u, v) in registers; the pre-test's upper end is the running
// best_t, so once a ray has a hit every plane beyond it is rejected from
// row 2 of the projection alone. Any hit: before each stage the block
// packs its unfinished rays into its first threads, and warps whose rays
// have finished leave.
//
// Arithmetic. The projection o' = W o + p, d' = W d and t, u, v use
// explicitly rounded operations (__fmul_rn, __fadd_rn, __fdiv_rn), with
// no fused multiply-add, in the order of the plain torch version in
// ops/woop.py, so the two agree bit for bit.
//
// Bound on this card: FP32 arithmetic, about 40 operations for each
// (ray, live triangle) pair (chip_smoke.py CLOSEST_OPS, ANY_OPS), against a
// few dozen bytes of input per ray; shared-memory staging keeps the
// triangle reads off device memory and the chunk cull cuts the pairs.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;      // rays per block == chunk-mask tile (RAY_TILE)
constexpr int kStage = 256;     // triangles staged in shared memory at a time (closest hit)
constexpr int kAnyStage = 128;  // the same for the any-hit kernel, which packs its rays between stages
constexpr float kParked = 1e29f;  // |origin| of a parked lane (ops/woop.py PARKED)

// A ray is tested when it exists, its [t_lo, t_hi] is not empty and its
// origin is not parked; any other ray misses (NaN compares false).
__device__ __forceinline__ bool tested(int r, int R, float4 a, float4 b) {
  return r < R && a.w < b.w && fabsf(a.x) < kParked && fabsf(a.y) < kParked &&
         fabsf(a.z) < kParked;
}

// ---------------------------------------------------------------------------
// The division-free interval pre-test of both kernels.
//
// A pair first computes row 2 of the projection, po2 = W2 . o + p2 and pd2 =
// W2 . d, exactly as the exact path does (so the floats are the exact
// path's), and then rejects, without a division and (closest hit) without
// rows 0 and 1, what the exact path cannot accept: by an interval test on
// t against [t_lo, t_up], where t_up is t_hi for any hit and the running
// best_t for closest hit. Only a pair that passes goes through the exact
// path: rows 0 and 1, __fdiv_rn, t, u, v and the accept predicate,
// unchanged, so each answer is its plain version's bit for bit.
// (Barycentric tests on u, v and 1 - u - v added to the pre-test, and two
// rays a thread, measured slower for any hit on this card: PERF.md.)
//
// Margins. e = 2^-24 is the unit roundoff; fl() a rounded f32 operation.
// Every rounding is fl(x) = x(1 + d) + h with |d| <= e, |h| <= 2^-150,
// d h = 0 (h only below 2^-126); a sum or difference of two floats has
// h = 0, and rounding keeps its sign. For a float N and a real x, N <
// fl(x) implies N < x (fl(x) is the float nearest to x), and likewise for
// >. The pre-test applies to an ordinary pair only: the ray has t_lo >=
// 2^-100 and |o|, |d| <= 2^24, the triangle's W and p are finite and at
// most 2^24 (the stage's flag); then |po|, |pd| < 2^50 and no product
// below overflows. Any other pair goes to the exact path.
//
// Let A = |pd2|, s = sign(pd2), N = -s po2 (exact), T = N / A (real), so
// the exact path's t = fl(N r), r = fl(1/A): a pair with A < eps is
// rejected by the exact test itself. Suppose the exact path accepts.
//  * r is finite (else t or u is not finite and the pair is rejected), so
//    A > 2^-128, 1/A is a normal float's worth and r = (1/A)(1 + d1); t >=
//    t_lo >= 2^-100 is normal, t = N r (1 + d2); so t = T(1 + th), |th| <=
//    2.0001e.
//  * Lower end. fl(N r) >= t_lo gives N r >= t_lo (1 - e), so N > 0 and N
//    >= t_lo A (1 - e) / (1 + e). The test rejects when N < fl(lo_m A),
//    lo_m = fl(t_lo (1 - 2^-20)), which implies N < t_lo (1 - 2^-20)(1 +
//    e) A, a contradiction since (1 - 16e)(1 + e)^2 < (1 - e) / (1 + e).
//  * Upper end, any hit. fl(N r) <= t_hi gives N <= t_hi A (1 + e) / (1 -
//    e), and N > fl(hi_m A), hi_m = fl(t_hi (1 + 2^-20)), gives N > t_hi (1
//    + 16e)(1 - e) A, which is larger. (t_hi (1 + 2^-20) may overflow to
//    inf: no test.)
//  * Upper end, closest hit. The kernel accepts a pair only when t <
//    best_t, strictly, where best_t is t_hi or the t of an earlier accepted
//    pair, so t_lo <= best_t <= t_hi and best_t >= 2^-100 is normal. t <=
//    best_t gives the any-hit bound with t_hi replaced by best_t, and the
//    test rejects when N > fl(hi_m A), hi_m = fl(best_t (1 + 2^-20)),
//    recomputed whenever best_t falls (starting from t_hi; inf when it
//    overflows). A rejected pair has t > best_t: it would not have won,
//    whatever order the triangles come in, so skipping it leaves (t, id,
//    u, v) as they were.
// So a pair the pre-test rejects is one the exact predicate rejects, or
// (closest hit) one that cannot beat the running best. tests/
// test_torch_woop.py holds torch mirrors of the pre-test (ops/woop.py
// any_pretest_rejects, closest_pretest_rejects) against the exact
// predicates on adversarial rays.
// ---------------------------------------------------------------------------

constexpr float kOrdMax = 0x1p24f;       // |o|, |d|, |W|, |p| of an ordinary pair
constexpr float kOrdLo = 0x1p-100f;      // least t_lo of an ordinary ray
constexpr float kRelMargin = 0x1p-20f;   // of t_lo and t_hi (best_t)
constexpr int kUnroll = 4;               // triangles between two warp exit checks (any hit)

// One staged triangle: W row k and p[k] in w[k]; e = (eps, 1 if the
// triangle is ordinary else 0, 0, 0).
struct StagedTri {
  float4 w[3];
  float4 e;
};

// Stages triangles t0 .. t0+n-1 of tbl (f32[12, stride], one column per
// triangle, stride = n_chunks*chunk: row 4k+i holds W[k][i] for i < 3 and
// p[k] for i = 3) with their eps as StagedTri rows, and fills the stage up
// to a multiple of kUnroll rows with triangles that never accept (W = 0,
// p = 0, eps = F32_MAX).
__device__ __forceinline__ void load_tri_stage(StagedTri* s, const float* __restrict__ tbl,
                                               const float* __restrict__ eps, long long stride,
                                               long long t0, int n) {
  const int n_pad = (n + kUnroll - 1) / kUnroll * kUnroll;
  for (int j = threadIdx.x; j < n_pad; j += kTile) {
    float v[12];
    bool ord = true;
#pragma unroll
    for (int q = 0; q < 12; ++q) {
      v[q] = j < n ? tbl[q * stride + t0 + j] : 0.f;
      ord = ord && fabsf(v[q]) <= kOrdMax;  // false for NaN and inf
    }
    s[j].w[0] = make_float4(v[0], v[1], v[2], v[3]);
    s[j].w[1] = make_float4(v[4], v[5], v[6], v[7]);
    s[j].w[2] = make_float4(v[8], v[9], v[10], v[11]);
    s[j].e = make_float4(j < n ? eps[t0 + j] : FLT_MAX, ord ? 1.f : 0.f, 0.f, 0.f);
  }
}

// An ordinary ray: the pre-test applies to its pairs with ordinary triangles.
__device__ __forceinline__ bool ordinary_ray(float4 a, float4 b) {
  return a.w >= kOrdLo && fabsf(a.x) <= kOrdMax && fabsf(a.y) <= kOrdMax &&
         fabsf(a.z) <= kOrdMax && fabsf(b.x) <= kOrdMax && fabsf(b.y) <= kOrdMax &&
         fabsf(b.z) <= kOrdMax;
}

// Row k of the projection: (W_k . o + p_k, W_k . d), summed left to right.
__device__ __forceinline__ float2 project_row(float4 w, float ox, float oy, float oz, float dx,
                                              float dy, float dz) {
  const float po = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, w.x), __fmul_rn(oy, w.y)),
                                       __fmul_rn(oz, w.z)),
                             w.w);
  const float pd = __fadd_rn(__fadd_rn(__fmul_rn(dx, w.x), __fmul_rn(dy, w.y)), __fmul_rn(dz, w.z));
  return make_float2(po, pd);
}

// The pre-test's verdict from row 2 (A = |pd2|, N = -sign(pd2) po2): true
// when T = N / A lies outside [lo_m, up_m] by the margins above.
__device__ __forceinline__ bool interval_out(float po2, float pd2, float lo_m, float up_m) {
  const float A = fabsf(pd2);
  const float N = pd2 < 0.f ? po2 : -po2;
  // bitwise |: both tests are computed, neither is a branch
  return (N < __fmul_rn(lo_m, A)) | (N > __fmul_rn(up_m, A));
}

// This thread's position among the block's threads with `keep` set, in
// thread order, and (in total) their number, the same in every thread.
// Holds two __syncthreads() (block-uniform), the first of which also
// orders the block's earlier reads of shared memory before what follows.
__device__ __forceinline__ int block_rank(bool keep, int* warp_total, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cnt = keep;
  int inc = cnt;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  __syncthreads();
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  int pos = inc - cnt;
  total = 0;
#pragma unroll
  for (int w = 0; w < kTile / 32; ++w) {
    const int t = warp_total[w];
    pos += w < warp ? t : 0;
    total += t;
  }
  return pos;
}

// ---------------------------------------------------------------------------
// Closest hit.
//
// The block first packs its tested rays into its first threads, so that a
// warp left with no ray (lanes parked or masked by the integrator) skips
// every stage; an untested ray writes its miss at once. The rays stay in
// their tile, so the tile's chunk mask still holds for them.
// ---------------------------------------------------------------------------

struct CloseRay {
  float ox, oy, oz, dx, dy, dz, lo, hi;
  float lo_m, hi_m;  // t_lo (1 - 2^-20) and best_t (1 + 2^-20), rounded
  float best_t, best_u, best_v;
  int best_id;
  bool ord;  // an ordinary ray: the pre-test applies
};

// Tests ray y against staged triangle T (id `id`) and keeps the hit when it
// beats y's best: the pre-test above, then, only for a pair that passes
// it, the exact closest-hit predicate of the reference (src/Triangle.cpp:
// 48-78) as closest_hit_woop_plain computes it. Ids come in ascending
// order, so the strict t < best_t keeps the lowest id on an equal t.
__device__ __forceinline__ void closest_pair(const StagedTri& T, CloseRay& y, int id) {
  const float2 r2 = project_row(T.w[2], y.ox, y.oy, y.oz, y.dx, y.dy, y.dz);
  // |d'_z| >= eps is the exact path's own test
  if (!((fabsf(r2.y) >= T.e.x) & !(y.ord & (T.e.y != 0.f) & interval_out(r2.x, r2.y, y.lo_m, y.hi_m))))
    return;
  const float2 r0 = project_row(T.w[0], y.ox, y.oy, y.oz, y.dx, y.dy, y.dz);
  const float2 r1 = project_row(T.w[1], y.ox, y.oy, y.oz, y.dx, y.dy, y.dz);
  const float inv = __fdiv_rn(1.0f, r2.y);
  const float t = __fmul_rn(-r2.x, inv);
  const float u = __fadd_rn(r0.x, __fmul_rn(t, r0.y));
  const float v = __fadd_rn(r1.x, __fmul_rn(t, r1.y));
  if (t >= y.lo && t < y.hi && u >= 0.f && v >= 0.f && __fsub_rn(__fsub_rn(1.0f, u), v) >= 0.f &&
      t < y.best_t) {
    y.best_t = t;
    y.best_id = id;
    y.best_u = u;
    y.best_v = v;
    y.hi_m = __fmul_rn(t, 1.0f + kRelMargin);
  }
}

__global__ void __launch_bounds__(kTile)
woop_closest_kernel(const float4* __restrict__ rays, const float* __restrict__ tbl,
                    const float* __restrict__ eps, const uint32_t* __restrict__ mask, int R,
                    int n_chunks, int chunk, int n_tris, float* __restrict__ out_t,
                    int* __restrict__ out_tri, float* __restrict__ out_u,
                    float* __restrict__ out_v) {
  __shared__ StagedTri s[kStage];
  __shared__ float4 slot[kTile][2];
  __shared__ int slot_idx[kTile];
  __shared__ int warp_total[kTile / 32];
  int r = blockIdx.x * kTile + threadIdx.x;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < R) {
    a = rays[2 * r];      // o.xyz, t_lo
    b = rays[2 * r + 1];  // d.xyz, t_hi
  }
  const bool active = tested(r, R, a, b);
  if (r < R && !active) {
    out_t[r] = FLT_MAX;
    out_tri[r] = -1;
    out_u[r] = 0.f;
    out_v[r] = 0.f;
  }
  int total;
  const int pos = block_rank(active, warp_total, total);
  if (total == 0) return;  // block-uniform
  if (active) {
    slot[pos][0] = a;
    slot[pos][1] = b;
    slot_idx[pos] = r;
  }
  __syncthreads();
  const bool mine = threadIdx.x < total;  // this thread now holds a tested ray
  if (mine) {
    a = slot[threadIdx.x][0];
    b = slot[threadIdx.x][1];
    r = slot_idx[threadIdx.x];
  }
  CloseRay y;
  y.ox = a.x;
  y.oy = a.y;
  y.oz = a.z;
  y.dx = b.x;
  y.dy = b.y;
  y.dz = b.z;
  y.lo = a.w;
  y.hi = b.w;
  y.lo_m = __fmul_rn(a.w, 1.0f - kRelMargin);
  y.hi_m = __fmul_rn(b.w, 1.0f + kRelMargin);
  y.best_t = b.w;
  y.best_u = y.best_v = 0.f;
  y.best_id = -1;
  y.ord = ordinary_ray(a, b);
  const uint32_t live = mask[blockIdx.x];
  const long long stride = (long long)n_chunks * chunk;
  for (int c = 0; c < n_chunks; ++c) {
    if (!((live >> c) & 1u)) continue;  // uniform across the block
    const int real = min(chunk, n_tris - c * chunk);  // pad columns are not staged
    for (int j0 = 0; j0 < real; j0 += kStage) {
      const int n = min(kStage, real - j0);
      __syncthreads();  // the previous stage's last reads
      load_tri_stage(s, tbl, eps, stride, (long long)c * chunk + j0, n);
      __syncthreads();
      if (mine) {
        const int id0 = c * chunk + j0;
#pragma unroll 4
        for (int j = 0; j < n; ++j) closest_pair(s[j], y, id0 + j);
      }
    }
  }
  if (mine) {
    const bool hit = y.best_id >= 0;
    out_t[r] = hit ? y.best_t : FLT_MAX;
    out_tri[r] = y.best_id;
    out_u[r] = hit ? y.best_u : 0.f;
    out_v[r] = hit ? y.best_v : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Any hit.
//
// The block is the same 256-ray tile with the same chunk mask, so the pairs
// tested are the same as the closest-hit kernel's, one ray a thread, with
// kAnyStage triangles a stage. Before each stage the block packs its
// unfinished rays into its first threads (compact), so that a warp whose
// rays have all finished, occluded or never tested, skips the stage; a
// warp also leaves a stage once its rays have finished (checked every
// kUnroll triangles). Every __syncthreads() stays in code that the whole
// block runs. An occluded ray writes its own result at once.
// ---------------------------------------------------------------------------

struct AnyRay {
  float ox, oy, oz, dx, dy, dz, lo, hi;
  float lo_m, hi_m;  // t_lo (1 - 2^-20), t_hi (1 + 2^-20), rounded
  int idx;           // the ray's index in the batch
  bool ord;          // an ordinary ray: the pre-test applies
  bool done;         // not tested, occluded, or no ray
};

__device__ __forceinline__ AnyRay make_any_ray(float4 a, float4 b, int idx, bool active) {
  AnyRay y;
  y.ox = a.x;
  y.oy = a.y;
  y.oz = a.z;
  y.dx = b.x;
  y.dy = b.y;
  y.dz = b.z;
  y.lo = a.w;
  y.hi = b.w;
  y.lo_m = __fmul_rn(a.w, 1.0f - kRelMargin);
  y.hi_m = __fmul_rn(b.w, 1.0f + kRelMargin);
  y.idx = idx;
  y.ord = ordinary_ray(a, b);
  y.done = !active;
  return y;
}

// Packs the block's unfinished rays, in order, into its first threads, so
// that a warp left with no ray skips the stages that follow. Returns the
// number of unfinished rays (the same in every thread). Holds three
// __syncthreads() (block-uniform), the first of which also orders the last
// reads of the previous stage before the next stage is written.
__device__ __forceinline__ int compact(AnyRay& y, float4 (*slot)[3], int* warp_total) {
  int total;
  const int pos = block_rank(!y.done, warp_total, total);
  if (!y.done) {
    slot[pos][0] = make_float4(y.ox, y.oy, y.oz, y.lo);
    slot[pos][1] = make_float4(y.dx, y.dy, y.dz, y.hi);
    slot[pos][2] = make_float4(y.lo_m, y.hi_m, __int_as_float(y.idx), y.ord ? 1.f : 0.f);
  }
  __syncthreads();
  const int k = threadIdx.x;
  y.done = k >= total;
  if (k < total) {
    const float4 a = slot[k][0], b = slot[k][1], c = slot[k][2];
    y.ox = a.x;
    y.oy = a.y;
    y.oz = a.z;
    y.lo = a.w;
    y.dx = b.x;
    y.dy = b.y;
    y.dz = b.z;
    y.hi = b.w;
    y.lo_m = c.x;
    y.hi_m = c.y;
    y.idx = __float_as_int(c.z);
    y.ord = c.w != 0.f;
  }
  return total;
}

// Does ray y hit triangle T? No when `live` is false (the ray has
// finished). The pre-test above, computed for every pair without a branch
// (all three rows first); then, only for a pair that passes it, the exact
// any-hit predicate of the reference (src/Triangle.cpp:85-103) as
// any_hit_woop_plain computes it.
__device__ __forceinline__ bool any_pair(const StagedTri& T, const AnyRay& y, bool live) {
  const float2 r0 = project_row(T.w[0], y.ox, y.oy, y.oz, y.dx, y.dy, y.dz);
  const float2 r1 = project_row(T.w[1], y.ox, y.oy, y.oz, y.dx, y.dy, y.dz);
  const float2 r2 = project_row(T.w[2], y.ox, y.oy, y.oz, y.dx, y.dy, y.dz);
  const bool out = interval_out(r2.x, r2.y, y.lo_m, y.hi_m);
  // |d'_z| >= eps is the exact path's own test
  if (!(live & (fabsf(r2.y) >= T.e.x) & !(y.ord & (T.e.y != 0.f) & out))) return false;
  const float inv = __fdiv_rn(1.0f, r2.y);
  const float t = __fmul_rn(-r2.x, inv);
  const float u = __fadd_rn(r0.x, __fmul_rn(t, r0.y));
  const float v = __fadd_rn(r1.x, __fmul_rn(t, r1.y));
  return u >= 0.f && u <= 1.0f && v >= 0.f && __fadd_rn(u, v) <= 1.0f && t >= y.lo && t <= y.hi;
}

__global__ void __launch_bounds__(kTile)
woop_any_kernel(const float4* __restrict__ rays, const float* __restrict__ tbl,
                const float* __restrict__ eps, const uint32_t* __restrict__ mask, int R,
                int n_chunks, int chunk, int n_tris, bool* __restrict__ out_hit) {
  __shared__ StagedTri s[kAnyStage];
  __shared__ float4 slot[kTile][3];
  __shared__ int warp_total[kTile / 32];
  const int r = blockIdx.x * kTile + threadIdx.x;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < R) {
    a = rays[2 * r];      // o.xyz, t_lo
    b = rays[2 * r + 1];  // d.xyz, t_hi
    out_hit[r] = false;   // an occluded ray sets its own, below
  }
  AnyRay y = make_any_ray(a, b, r, tested(r, R, a, b));
  const uint32_t live = mask[blockIdx.x];
  const long long stride = (long long)n_chunks * chunk;
  for (int c = 0; c < n_chunks; ++c) {
    if (!((live >> c) & 1u)) continue;  // uniform across the block
    const int real = min(chunk, n_tris - c * chunk);  // pad columns are not staged
    for (int j0 = 0; j0 < real; j0 += kAnyStage) {
      // block-uniform: the block leaves once all of its rays have finished
      if (compact(y, slot, warp_total) == 0) return;
      const int n = min(kAnyStage, real - j0);
      load_tri_stage(s, tbl, eps, stride, (long long)c * chunk + j0, n);
      __syncthreads();
      // warp-uniform: a warp whose rays have all finished skips the stage
      for (int j = 0; j < n && __any_sync(0xffffffffu, !y.done); j += kUnroll) {
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (any_pair(s[j + k], y, !y.done)) {
            out_hit[y.idx] = true;
            y.done = true;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
int woop_closest(const float* rays, const float* tbl, const float* eps, const int* mask,
                 int R, int n_chunks, int chunk, int n_tris, float* out_t, int* out_tri,
                 float* out_u, float* out_v, void* stream) {
  const int blocks = (R + kTile - 1) / kTile;
  woop_closest_kernel<<<blocks, kTile, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), tbl, eps,
      reinterpret_cast<const uint32_t*>(mask), R, n_chunks, chunk, n_tris, out_t, out_tri, out_u,
      out_v);
  return (int)cudaGetLastError();
}

int woop_any(const float* rays, const float* tbl, const float* eps, const int* mask, int R,
             int n_chunks, int chunk, int n_tris, bool* out_hit, void* stream) {
  const int blocks = (R + kTile - 1) / kTile;
  woop_any_kernel<<<blocks, kTile, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), tbl, eps,
      reinterpret_cast<const uint32_t*>(mask), R, n_chunks, chunk, n_tris, out_hit);
  return (int)cudaGetLastError();
}

}  // extern "C"
