// Woop-transform closest-hit and any-hit kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels _closest_kernel and _any_kernel of
// mcpt_tpu/ops/pallas/woop.py (pallas_call sites in
// closest_hit_woop_fused_impl and any_hit_woop_fused_impl). Same function:
// each ray is tested against the BVH-ordered triangles of every chunk its
// tile may reach, with the reference accept predicates (src/Triangle.cpp:
// 48-78 closest, 85-103 any) and the lowest triangle id on equal t.
//
// Design. One thread per ray; a block of kTile = 256 rays is one tile of
// the chunk mask, which the wrapper computes in torch (ops/woop.py,
// tile_chunk_mask) and which is conservative. For each live chunk the block
// stages kStage triangles at a time in static shared memory, structure of
// arrays: the 3x3 W and p of the Woop map (12 floats) plus the determinant
// threshold, 13 floats a triangle, 13 KB a stage. Every thread then walks
// the stage in f32, reading each value as a broadcast, and keeps its best
// (t, id, u, v) in registers. The any-hit thread stops testing after its
// first accept but still reaches every __syncthreads(); the syncs sit only
// in code that the whole block runs, and the block leaves early, together,
// once every ray of it has a hit.
//
// Arithmetic. The projection o' = W o + p, d' = W d and t, u, v use
// explicitly rounded operations (__fmul_rn, __fadd_rn, __fdiv_rn), with
// no fused multiply-add, in the order of the plain torch version in
// ops/woop.py, so the two agree bit for bit.
//
// Bound on this card: FP32 arithmetic, about 34 operations for each
// (ray, live triangle) pair, against a few dozen bytes of input per ray;
// shared-memory staging keeps the triangle reads off device memory and the
// chunk cull cuts the pairs. wgmma, TMA and speed are later work.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;   // rays per block == chunk-mask tile (RAY_TILE)
constexpr int kStage = 256;  // triangles staged in shared memory at a time

struct Stage {
  float w[12][kStage];  // W00 W01 W02 p0  W10 W11 W12 p1  W20 W21 W22 p2
  float eps[kStage];
};

// tbl is f32[12, stride], one column per triangle (stride = n_chunks*chunk):
// row 4k+i holds W[k][i] for i < 3 and p[k] for i = 3. Stages triangles
// t0 .. t0+n-1.
__device__ __forceinline__ void load_stage(Stage& s, const float* __restrict__ tbl,
                                           const float* __restrict__ eps,
                                           long long stride, long long t0, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
#pragma unroll
    for (int q = 0; q < 12; ++q) s.w[q][j] = tbl[q * stride + t0 + j];
    s.eps[j] = eps[t0 + j];
  }
}

constexpr float kParked = 1e29f;  // |origin| of a parked lane (ops/woop.py PARKED)

// A ray is tested when it exists, its [t_lo, t_hi] is not empty and its
// origin is not parked; any other ray misses (NaN compares false).
__device__ __forceinline__ bool tested(int r, int R, float4 a, float4 b) {
  return r < R && a.w < b.w && fabsf(a.x) < kParked && fabsf(a.y) < kParked &&
         fabsf(a.z) < kParked;
}

struct Tuv {
  float t, u, v;
  bool ok;
};

__device__ __forceinline__ Tuv project(const Stage& s, int j, float ox, float oy, float oz,
                                       float dx, float dy, float dz) {
  float po[3], pd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w0 = s.w[k * 4 + 0][j], w1 = s.w[k * 4 + 1][j], w2 = s.w[k * 4 + 2][j];
    po[k] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, w0), __fmul_rn(oy, w1)),
                                __fmul_rn(oz, w2)),
                      s.w[k * 4 + 3][j]);
    pd[k] = __fadd_rn(__fadd_rn(__fmul_rn(dx, w0), __fmul_rn(dy, w1)), __fmul_rn(dz, w2));
  }
  Tuv r;
  r.ok = fabsf(pd[2]) >= s.eps[j];
  const float inv = r.ok ? __fdiv_rn(1.0f, pd[2]) : 0.0f;
  r.t = __fmul_rn(-po[2], inv);
  r.u = __fadd_rn(po[0], __fmul_rn(r.t, pd[0]));
  r.v = __fadd_rn(po[1], __fmul_rn(r.t, pd[1]));
  return r;
}

__global__ void __launch_bounds__(kTile)
woop_closest_kernel(const float4* __restrict__ rays, const float* __restrict__ tbl,
                    const float* __restrict__ eps, const uint32_t* __restrict__ mask, int R,
                    int n_chunks, int chunk, float* __restrict__ out_t,
                    int* __restrict__ out_tri, float* __restrict__ out_u,
                    float* __restrict__ out_v) {
  __shared__ Stage s;
  const int r = blockIdx.x * kTile + threadIdx.x;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < R) {
    a = rays[2 * r];      // o.xyz, t_lo
    b = rays[2 * r + 1];  // d.xyz, t_hi
  }
  const bool active = tested(r, R, a, b);
  float best_t = b.w, best_u = 0.f, best_v = 0.f;
  int best_id = -1;
  const uint32_t live = mask[blockIdx.x];
  const long long stride = (long long)n_chunks * chunk;
  for (int c = 0; c < n_chunks; ++c) {
    if (!((live >> c) & 1u)) continue;  // uniform across the block
    for (int j0 = 0; j0 < chunk; j0 += kStage) {
      const int n = min(kStage, chunk - j0);
      __syncthreads();
      load_stage(s, tbl, eps, stride, (long long)c * chunk + j0, n);
      __syncthreads();
      if (active) {
        for (int j = 0; j < n; ++j) {
          const Tuv h = project(s, j, a.x, a.y, a.z, b.x, b.y, b.z);
          const bool accept = h.ok && h.t >= a.w && h.t < b.w && h.u >= 0.f && h.v >= 0.f &&
                              __fsub_rn(__fsub_rn(1.0f, h.u), h.v) >= 0.f;
          // strict <: ids ascend, so the lowest id keeps an equal t
          if (accept && h.t < best_t) {
            best_t = h.t;
            best_id = c * chunk + j0 + j;
            best_u = h.u;
            best_v = h.v;
          }
        }
      }
    }
  }
  if (r < R) {
    const bool hit = best_id >= 0;
    out_t[r] = hit ? best_t : FLT_MAX;
    out_tri[r] = best_id;
    out_u[r] = hit ? best_u : 0.f;
    out_v[r] = hit ? best_v : 0.f;
  }
}

__global__ void __launch_bounds__(kTile)
woop_any_kernel(const float4* __restrict__ rays, const float* __restrict__ tbl,
                const float* __restrict__ eps, const uint32_t* __restrict__ mask, int R,
                int n_chunks, int chunk, bool* __restrict__ out_hit) {
  __shared__ Stage s;
  const int r = blockIdx.x * kTile + threadIdx.x;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < R) {
    a = rays[2 * r];
    b = rays[2 * r + 1];
  }
  const bool active = tested(r, R, a, b);
  bool hit = false;
  const uint32_t live = mask[blockIdx.x];
  const long long stride = (long long)n_chunks * chunk;
  for (int c = 0; c < n_chunks; ++c) {
    if (!((live >> c) & 1u)) continue;  // uniform across the block
    for (int j0 = 0; j0 < chunk; j0 += kStage) {
      // every thread reaches this sync; the block leaves together once all
      // of its rays have a hit
      if (!__syncthreads_or(active && !hit)) goto done;
      const int n = min(kStage, chunk - j0);
      load_stage(s, tbl, eps, stride, (long long)c * chunk + j0, n);
      __syncthreads();
      if (active && !hit) {
        for (int j = 0; j < n; ++j) {
          const Tuv h = project(s, j, a.x, a.y, a.z, b.x, b.y, b.z);
          if (h.ok && h.u >= 0.f && h.u <= 1.0f && h.v >= 0.f && __fadd_rn(h.u, h.v) <= 1.0f &&
              h.t >= a.w && h.t <= b.w) {
            hit = true;
            break;
          }
        }
      }
    }
  }
done:
  if (r < R) out_hit[r] = hit;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
int woop_closest(const float* rays, const float* tbl, const float* eps, const int* mask,
                 int R, int n_chunks, int chunk, float* out_t, int* out_tri, float* out_u,
                 float* out_v, void* stream) {
  const int blocks = (R + kTile - 1) / kTile;
  woop_closest_kernel<<<blocks, kTile, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), tbl, eps,
      reinterpret_cast<const uint32_t*>(mask), R, n_chunks, chunk, out_t, out_tri, out_u,
      out_v);
  return (int)cudaGetLastError();
}

int woop_any(const float* rays, const float* tbl, const float* eps, const int* mask, int R,
             int n_chunks, int chunk, bool* out_hit, void* stream) {
  const int blocks = (R + kTile - 1) / kTile;
  woop_any_kernel<<<blocks, kTile, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays), tbl, eps,
      reinterpret_cast<const uint32_t*>(mask), R, n_chunks, chunk, out_hit);
  return (int)cudaGetLastError();
}

}  // extern "C"
