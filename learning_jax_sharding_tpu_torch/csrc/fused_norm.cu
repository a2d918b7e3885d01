// Fused residual add + LayerNorm / RMSNorm for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernels learning_jax_sharding_tpu/ops/fused_norm.py
// ::_fwd_kernel (launched by _fwd there) and ::_bwd_kernel (launched by _bwd).
//
// Forward, per row of M features: s = x + resid in fp32; the new residual is
// s rounded to x's dtype; LayerNorm (centred two-pass variance: the mean
// first, then the mean of (s - mean)^2) or RMSNorm normalises the UNROUNDED
// fp32 s; y = xhat * gamma [+ beta] in fp32, written in x's dtype; optionally
// the fp32 mean (LayerNorm) and rstd of the row for the backward.
//
// Backward, per row: xhat is recomputed from the ROUNDED residual and the
// saved fp32 mean/rstd; dxhat = dy * gamma; c2 = mean(dxhat * xhat), c1 =
// mean(dxhat) (LayerNorm only); dx = rstd * (dxhat - c1 - xhat * c2), written
// in dy's dtype, then (when the residual output has a gradient) dx + dr in
// that dtype, as the JAX custom VJP adds them. dgamma = sum over rows of
// dy * xhat and dbeta = sum of dy, in fp32, cast to gamma's dtype.
//
// Design. One warp per row; rows are strided over the warps of the grid, so a
// warp loads gamma (and beta) once. Each lane holds its share of the row in
// registers: 16-byte vectors of x's dtype, lane l owning vectors l, l + 32,
// ... (at M = 768: 24 values a lane in fp32 and bf16). Row sums are warp
// shuffles (xor butterflies: every lane gets the same bits). The backward's
// dgamma/dbeta: each lane sums its columns over the warp's rows in
// registers, the block adds its warps in warp order in shared memory and
// writes one fp32 partial row per block; a second kernel sums the partials in
// a fixed order (per column, 8 contiguous slices, then the slices in order).
// The result is deterministic and uses no atomics.
//
// Bound on this card: bytes. At the 125M train shape (8192 x 768, bf16) the
// forward with a residual reads x and resid and writes y and the residual,
// 50.3 MB, about 15 us at 3.35 TB/s (H100 SXM); without one half of that.
// The backward reads dy and the residual and writes dx, 37.7 MB (50.3 with
// dr), about 11.3 us, plus the fp32 partials (0.8 MB, in L2). Left for
// later: the partials' round trip (a cluster could reduce them on chip) and
// one kernel for the forward and the add of the next residual.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows in flight per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPerLane = 32;           // values a lane holds: M <= 1024
constexpr int kMaxM = 32 * kMaxPerLane;
constexpr int kFwdMaxBlocks = 8 * 132;    // rows loop past this
constexpr int kReduceSlices = 8;          // partial slices per column

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte vector of T to fp32, and back.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int V = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = to_float(vals[e]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  constexpr int V = 16 / sizeof(T);
  uint4 raw;
  T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < V; ++e) vals[e] = from_float<T>(in[e]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// gamma / beta values of this lane's vectors, in fp32 (zeros past M, or
// where the pointer is null).
template <typename T, typename P>
__device__ __forceinline__ void load_params(float* dst, const P* src, int lane, int nvec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = kMaxPerLane / V;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int vi = c * 32 + lane;
#pragma unroll
    for (int e = 0; e < V; ++e)
      dst[c * V + e] = (src != nullptr && vi < nvec) ? to_float(src[vi * V + e]) : 0.f;
  }
}

template <typename T, typename P, bool kLayerNorm, bool kStats>
__global__ void __launch_bounds__(kThreads) fused_norm_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ resid, const P* __restrict__ gamma,
    const P* __restrict__ beta, T* __restrict__ y, T* __restrict__ r_out,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows, int M, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = kMaxPerLane / V;
  const int lane = threadIdx.x % 32;
  const int nvec = M / V;
  const float m = (float)M;

  float g[kMaxPerLane], b[kMaxPerLane];
  load_params<T>(g, gamma, lane, nvec);
  load_params<T>(b, beta, lane, nvec);

  for (int row = blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += gridDim.x * kWarps) {
    const size_t off = (size_t)row * M;
    float v[kMaxPerLane];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int vi = c * 32 + lane;
      if (vi < nvec) {
        load_vec(x + off + (size_t)vi * V, v + c * V);
        if (resid != nullptr) {
          float rv[V];
          load_vec(resid + off + (size_t)vi * V, rv);
#pragma unroll
          for (int e = 0; e < V; ++e) v[c * V + e] = __fadd_rn(v[c * V + e], rv[e]);
          store_vec(r_out + off + (size_t)vi * V, v + c * V);   // rounded once
        }
      }
    }
    // Statistics of the unrounded fp32 sum.
    float mean = 0.f, sq = 0.f;
    if (kLayerNorm) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c * 32 + lane < nvec) {
#pragma unroll
          for (int e = 0; e < V; ++e) s += v[c * V + e];
        }
      mean = __fdiv_rn(warp_sum(s), m);
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c * 32 + lane < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = __fsub_rn(v[c * V + e], mean);
          sq = __fadd_rn(sq, __fmul_rn(d, d));
        }
      }
    const float rstd = 1.f / sqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), m), eps));
    if (kStats && lane == 0) {
      if (kLayerNorm) mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int vi = c * 32 + lane;
      if (vi < nvec) {
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int i = c * V + e;
          float t = __fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), rstd), g[i]);
          out[e] = beta != nullptr ? __fadd_rn(t, b[i]) : t;
        }
        store_vec(y + off + (size_t)vi * V, out);
      }
    }
  }
}

template <typename T, typename P, bool kLayerNorm>
__global__ void __launch_bounds__(kThreads) fused_norm_bwd_kernel(
    const T* __restrict__ dy, const T* __restrict__ r, const P* __restrict__ gamma,
    const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
    const T* __restrict__ dr, T* __restrict__ dx, float* __restrict__ part_g,
    float* __restrict__ part_b, int rows, int M) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = kMaxPerLane / V;
  __shared__ float acc_g[kMaxM];
  __shared__ float acc_b[kMaxM];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nvec = M / V;
  const float m = (float)M;

  float g[kMaxPerLane], dg[kMaxPerLane], db[kMaxPerLane];
  load_params<T>(g, gamma, lane, nvec);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) dg[i] = db[i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t off = (size_t)row * M;
    const float rstd = rstd_in[row];
    const float mean = kLayerNorm ? mean_in[row] : 0.f;
    float d[kMaxPerLane], xh[kMaxPerLane];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c * 32 + lane < nvec) {
        const size_t at = off + (size_t)(c * 32 + lane) * V;
        load_vec(dy + at, d + c * V);
        load_vec(r + at, xh + c * V);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int i = c * V + e;
          xh[i] = __fmul_rn(__fsub_rn(xh[i], mean), rstd);
          dg[i] = __fadd_rn(dg[i], __fmul_rn(d[i], xh[i]));
          db[i] = __fadd_rn(db[i], d[i]);
          d[i] = __fmul_rn(d[i], g[i]);                 // dxhat
          s1 = __fadd_rn(s1, d[i]);
          s2 = __fadd_rn(s2, __fmul_rn(d[i], xh[i]));
        }
      }
    }
    const float c1 = kLayerNorm ? __fdiv_rn(warp_sum(s1), m) : 0.f;
    const float c2 = __fdiv_rn(warp_sum(s2), m);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c * 32 + lane < nvec) {
        const size_t at = off + (size_t)(c * 32 + lane) * V;
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int i = c * V + e;
          const float t = __fsub_rn(__fsub_rn(d[i], c1), __fmul_rn(xh[i], c2));
          out[e] = to_float(from_float<T>(__fmul_rn(rstd, t)));   // dx in dy's dtype
        }
        if (dr != nullptr) {
          float rv[V];
          load_vec(dr + at, rv);
#pragma unroll
          for (int e = 0; e < V; ++e) out[e] = __fadd_rn(out[e], rv[e]);
        }
        store_vec(dx + at, out);
      }
    }
  }

  // The block's partial: its warps' column sums, added in warp order.
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int vi = c * 32 + lane;
        if (vi < nvec) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int col = vi * V + e;
            acc_g[col] = w == 0 ? dg[c * V + e] : __fadd_rn(acc_g[col], dg[c * V + e]);
            acc_b[col] = w == 0 ? db[c * V + e] : __fadd_rn(acc_b[col], db[c * V + e]);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < M; col += kThreads) {
    part_g[(size_t)blockIdx.x * M + col] = acc_g[col];
    if (part_b != nullptr) part_b[(size_t)blockIdx.x * M + col] = acc_b[col];
  }
}

// out[col] = sum over blocks of part[block, col]: 32 columns per block, one
// warp per contiguous slice of partials, the slices added in order.
template <typename P>
__global__ void __launch_bounds__(kThreads) fused_norm_reduce_kernel(
    const float* __restrict__ part, P* __restrict__ out, int nblocks, int M) {
  __shared__ float slice[kReduceSlices][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const int per = (nblocks + kReduceSlices - 1) / kReduceSlices;
  const int b0 = warp * per;
  const int b1 = min(nblocks, b0 + per);
  float s = 0.f;
  if (col < M) {
#pragma unroll 8
    for (int b = b0; b < b1; ++b) s = __fadd_rn(s, part[(size_t)b * M + col]);
  }
  slice[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < M) {
    float total = slice[0][lane];
#pragma unroll
    for (int w = 1; w < kReduceSlices; ++w) total = __fadd_rn(total, slice[w][lane]);
    out[col] = from_float<P>(total);
  }
}

template <typename T, typename P>
int launch_fwd(const void* x, const void* resid, const void* gamma, const void* beta, void* y,
               void* r_out, float* mean, float* rstd, int layernorm, int rows, int M, float eps,
               cudaStream_t stream) {
  const int needed = (rows + kWarps - 1) / kWarps;
  const int blocks = needed < kFwdMaxBlocks ? needed : kFwdMaxBlocks;
  const bool stats = rstd != nullptr;
#define FWD(LN, ST)                                                                    \
  fused_norm_fwd_kernel<T, P, LN, ST><<<blocks, kThreads, 0, stream>>>(                \
      static_cast<const T*>(x), static_cast<const T*>(resid),                          \
      static_cast<const P*>(gamma), static_cast<const P*>(beta), static_cast<T*>(y),   \
      static_cast<T*>(r_out), mean, rstd, rows, M, eps)
  if (layernorm && stats) FWD(true, true);
  else if (layernorm) FWD(true, false);
  else if (stats) FWD(false, true);
  else FWD(false, false);
#undef FWD
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int launch_bwd(const void* dy, const void* r, const void* gamma, const float* mean,
               const float* rstd, const void* dr, void* dx, float* part_g, float* part_b,
               void* dgamma, void* dbeta, int layernorm, int rows, int M, int blocks,
               cudaStream_t stream) {
  auto kernel = layernorm ? fused_norm_bwd_kernel<T, P, true> : fused_norm_bwd_kernel<T, P, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(r), static_cast<const P*>(gamma), mean,
      rstd, static_cast<const T*>(dr), static_cast<T*>(dx), part_g, part_b, rows, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cols = (M + 31) / 32;
  fused_norm_reduce_kernel<P><<<cols, kThreads, 0, stream>>>(part_g, static_cast<P*>(dgamma),
                                                             blocks, M);
  if (part_b != nullptr)
    fused_norm_reduce_kernel<P><<<cols, kThreads, 0, stream>>>(part_b, static_cast<P*>(dbeta),
                                                               blocks, M);
  return (int)cudaGetLastError();
}

bool shape_ok(int rows, int M) { return rows >= 1 && M >= 8 && M <= kMaxM && M % 8 == 0; }

}  // namespace

extern "C" {

// dtype / param_dtype: 0 = float32, 1 = bfloat16 (x, resid, y, r_out: dtype;
// gamma, beta: param_dtype). resid / r_out, beta, mean / rstd may be null
// (rstd null: no statistics are written; mean is read only for LayerNorm).
// Returns cudaGetLastError() after the launch; -1 for a shape or dtype this
// kernel does not take.
int fused_norm_fwd_launch(const void* x, const void* resid, const void* gamma, const void* beta,
                          void* y, void* r_out, float* mean, float* rstd, int dtype,
                          int param_dtype, int layernorm, int rows, int M, float eps,
                          void* stream) {
  if (!shape_ok(rows, M)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, P)                                                                   \
  return launch_fwd<T, P>(x, resid, gamma, beta, y, r_out, mean, rstd, layernorm, rows, \
                          M, eps, st)
  if (dtype == 0 && param_dtype == 0) LAUNCH(float, float);
  if (dtype == 0 && param_dtype == 1) LAUNCH(float, __nv_bfloat16);
  if (dtype == 1 && param_dtype == 0) LAUNCH(__nv_bfloat16, float);
  if (dtype == 1 && param_dtype == 1) LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef LAUNCH
  return -1;
}

// part_g / part_b: (blocks, M) fp32 scratch; part_b and dbeta null without
// beta; dr null when the residual output has no gradient. dgamma / dbeta are
// written in param_dtype.
int fused_norm_bwd_launch(const void* dy, const void* r, const void* gamma, const float* mean,
                          const float* rstd, const void* dr, void* dx, float* part_g,
                          float* part_b, void* dgamma, void* dbeta, int dtype, int param_dtype,
                          int layernorm, int rows, int M, int blocks, void* stream) {
  if (!shape_ok(rows, M) || blocks < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, P)                                                                   \
  return launch_bwd<T, P>(dy, r, gamma, mean, rstd, dr, dx, part_g, part_b, dgamma,   \
                          dbeta, layernorm, rows, M, blocks, st)
  if (dtype == 0 && param_dtype == 0) LAUNCH(float, float);
  if (dtype == 0 && param_dtype == 1) LAUNCH(float, __nv_bfloat16);
  if (dtype == 1 && param_dtype == 0) LAUNCH(__nv_bfloat16, float);
  if (dtype == 1 && param_dtype == 1) LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef LAUNCH
  return -1;
}

}  // extern "C"
