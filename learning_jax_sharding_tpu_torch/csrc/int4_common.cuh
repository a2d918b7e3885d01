// What the int4 kernels (int4_matmul.cu, int4_ff.cu) share: the block's
// tiling, the activation types, and the w4a16 up-projection chunk with its
// reduction over row slices. One copy, so both kernels keep the same
// numerics: each dequantized weight (q - 8) * s is rounded to x's dtype T,
// products accumulate in fp32, and the 32 row slices reduce in a fixed order.
//
// Layout: q4 (K/2, N) uint8, split-half packed (byte row r holds kernel row r
// in its low nibble and row r + K/2 in its high nibble, offset-binary +8);
// s (K/g, N) fp32 group scales, or (1, N) for one group over all of K. Row
// r's scales are s[r/g] (low) and s[K/(2g) + r/g] (high).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace int4_common {

constexpr int kThreads = 256;
constexpr int kColThreads = 8;                     // threads across a column tile
constexpr int kTileN = kColThreads * 4;            // 32 output columns per block
constexpr int kSlices = kThreads / kColThreads;    // 32 row slices
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileM = 8;                       // rows of x per block
constexpr int kSmemLimit = 232448;                 // what a block may opt in to

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16(v); }
};

__device__ __forceinline__ size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

// Sum a value over the 4 row slices of a warp (lanes 8 apart), in place.
template <typename V>
__device__ __forceinline__ V slice_sum(V v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

template <typename V>
__device__ __forceinline__ void zero(V (&acc)[kMaxTileM][4]) {
#pragma unroll
  for (int m = 0; m < kMaxTileM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;
}

// Stage rows m0 .. m0+tile_m-1 of x (M, K) in shared memory, zeros past M.
template <typename T>
__device__ __forceinline__ void stage_rows(T* xs, const T* __restrict__ x, int m0, int M, int K,
                                           int tile_m) {
  for (int i = threadIdx.x; i < tile_m * K; i += kThreads) {
    const int m = i / K;
    xs[i] = m0 + m < M ? x[(size_t)(m0 + m) * K + i % K] : Num<T>::store(0.f);
  }
}

// The calling thread's share of xs @ dequant(q4, s) for columns c0 .. c0+3:
// packed rows slice, slice + kSlices, ... of (K/2, N) q4, into acc (fp32).
// Each thread reads one 32-bit word (4 neighbouring columns) per packed row,
// so the 8 column threads read 128 contiguous bytes of a row.
template <typename T>
__device__ __forceinline__ void w4a16_accumulate(
    float (&acc)[kMaxTileM][4], const T* xs, const uint8_t* __restrict__ q4,
    const float* __restrict__ scale, int N, int c0, int K, int ng, int group, int tile_m,
    int slice) {
  const int k_half = K / 2;
  for (int r = slice; r < k_half; r += kSlices) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(q4 + (size_t)r * N + c0);
    const int g_lo = ng == 1 ? 0 : r / group;
    const int g_hi = ng == 1 ? 0 : ng / 2 + r / group;
    const float4 s_lo = *reinterpret_cast<const float4*>(scale + (size_t)g_lo * N + c0);
    const float4 s_hi = *reinterpret_cast<const float4*>(scale + (size_t)g_hi * N + c0);
    const float sl[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
    const float sh[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
    float wl[4], wh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int byte = (word >> (8 * j)) & 0xFF;
      wl[j] = Num<T>::round(__fmul_rn((float)((byte & 0xF) - 8), sl[j]));
      wh[j] = Num<T>::round(__fmul_rn((float)((byte >> 4) - 8), sh[j]));
    }
#pragma unroll
    for (int m = 0; m < kMaxTileM; ++m) {
      if (m < tile_m) {
        const float xl = Num<T>::load(xs[m * K + r]);
        const float xh = Num<T>::load(xs[m * K + k_half + r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[m][j] = fmaf(xl, wl[j], acc[m][j]);
          acc[m][j] = fmaf(xh, wh[j], acc[m][j]);
        }
      }
    }
  }
}

// First half of the block's reduction over row slices: each warp sums its 4
// slices and writes (warp, row, column) partials to red (kWarps x kMaxTileM
// x kTileN). The caller syncs, then reads warp_sum.
template <typename V>
__device__ __forceinline__ void store_warp_sums(const V (&acc)[kMaxTileM][4], V* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int m = 0; m < kMaxTileM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const V v = slice_sum(acc[m][j]);
      if (lane < kColThreads) red[(warp * kMaxTileM + m) * kTileN + lane * 4 + j] = v;
    }
}

// Second half: the sum over the 8 warps of tile row m, column c, in order.
template <typename V>
__device__ __forceinline__ V warp_sum(const V* red, int m, int c) {
  V v = 0;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp) v += red[(wp * kMaxTileM + m) * kTileN + c];
  return v;
}

}  // namespace int4_common
