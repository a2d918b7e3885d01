// What the int4 kernels (int4_matmul.cu, int4_ff.cu) share: the CUDA-core
// block's tiling, the activation types, and the w4a16 up-projection chunk
// with its reduction over row slices; then the tensor-core machinery of
// int4_matmul.cu's designs 2 (namespace tc: the cp.async ring, the weight
// tiles dequantized once a block, the w4a16 tile product) and 3 (namespace
// sm: the swapped-operand fragments built from words of q4), which
// int4_ff.cu's tensor-core designs use too. One copy, so the kernels keep
// the same numerics: each dequantized weight (q - 8) * s is rounded to x's
// dtype T, products accumulate in fp32, and partial sums meet in a fixed
// order.
//
// Layout: q4 (K/2, N) uint8, split-half packed (byte row r holds kernel row r
// in its low nibble and row r + K/2 in its high nibble, offset-binary +8);
// s (K/g, N) fp32 group scales, or (1, N) for one group over all of K. Row
// r's scales are s[r/g] (low) and s[K/(2g) + r/g] (high).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

// ---------------------------------------------------------------------------
// int4_matmul.cu's design 2: tensor cores.

namespace tc {

using namespace tc_prims;

constexpr int kBK = 32;        // packed rows per stage (32 x columns per half)
constexpr int kBN = 128;       // output columns per block
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kQBytes = kBK * kBN;   // one stage's packed tile, row-major (k, n)
// w4a16 rows per block: 128 (warps 2 x 4 of 64 x 32), or 96 (48 x 32),
// whichever leaves the busiest SM fewer rows (the wrapper picks): more,
// smaller blocks even out the SMs' load (the q/k/v triple at M = 1024: 144
// blocks of 128 rows leave 12 SMs with two and 120 with one; 198 of 96
// rows, 66 and 66), and 96 rows pad less at small M.
constexpr int kBM16 = 128;
constexpr int kBM16Small = 96;
constexpr int kBM8 = 64;       // w4a8 rows per block: warps 2 x 4 of 32 x 32

// Shared-memory tiles are rows of 16-byte chunks padded by one chunk, so the
// 8 row addresses of an ldmatrix phase fall on 8 different bank groups.
// x tiles: (m, k) rows of kBK elements of ES bytes.
template <int ES>
struct XTile {
  static constexpr int kRowBytes = kBK * ES;          // 64 (bf16) or 32 (int8)
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kChunks = kRowBytes / 16;      // 16-byte chunks per row
};
// Weight tiles. bf16: (k, n) rows of kBN values, read by ldmatrix.trans.
// int8: (n, k) rows of kBK values (ldmatrix cannot transpose 8-bit values).
constexpr int kW16Stride = kBN * 2 + 16;
constexpr int kW16Bytes = kBK * kW16Stride;
constexpr int kW8Stride = kBK + 16;
constexpr int kW8Bytes = kBN * kW8Stride;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage's copies into ring slot (qs, xl, xh): packed rows [r0, r0+kBK)
// x columns [n0, n0+kBN) of q4, and rows [m0, m0+BM) of x at columns
// [r0, r0+kBK) (xl) and [K/2+r0, K/2+r0+kBK) (xh). Rows past M and columns
// past N read as zeros. n_vec: N and q4 allow 16-byte copies, else 4-byte.
template <int BM, int ES>
__device__ __forceinline__ void load_stage(uint8_t* qs, uint8_t* xl, uint8_t* xh,
                                           const uint8_t* __restrict__ q4,
                                           const uint8_t* __restrict__ x, int M, int K, int N,
                                           int m0, int n0, int r0, bool n_vec) {
  using X = XTile<ES>;
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * BM * X::kChunks; i += kThreads) {
    const int half = i / (BM * X::kChunks), j = i % (BM * X::kChunks);
    const int m = j / X::kChunks, c = j % X::kChunks;
    const int row = m0 + m < M ? m0 + m : M - 1;
    const uint8_t* src = x + ((size_t)row * K + (half ? K / 2 : 0) + r0) * ES + c * 16;
    cp_async16((half ? xh : xl) + m * X::kStride + c * 16, src, m0 + m < M ? 16 : 0);
  }
  if (n_vec) {
    for (int i = tid; i < kQBytes / 16; i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const bool in = n0 + c < N;
      cp_async16(qs + r * kBN + c, q4 + (size_t)(r0 + r) * N + (in ? n0 + c : 0), in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kQBytes / 4; i += kThreads) {
      const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      const bool in = n0 + c < N;
      cp_async4(qs + r * kBN + c, q4 + (size_t)(r0 + r) * N + (in ? n0 + c : 0), in ? 4 : 0);
    }
  }
}

// Exactly (float)(v - 8) for a nibble v held as 0x4B00000v: 2^23 + v - (2^23 + 8).
__device__ __forceinline__ float nibble_value(uint32_t magic_v) {
  return __fsub_rn(__uint_as_float(magic_v), 8388616.f);
}

// w4a16: the thread dequantizes packed rows 4w .. 4w+3 (w its warp) of a
// stage at columns 4*lane .. 4*lane+3 into wl/wh[k][n] = bf16((q - 8) * s)
// of the low/high nibbles, s the scale of the packed row's own group (low
// g, high ng/2 + g; one whole-K group: row 0 for both). A warp reads and
// writes whole rows: one 32-bit word and one 8-byte store per row and half.
// One row per row(i) call, so the kernel can interleave the rows with its
// products; the constructor starts the scale loads (none when !active).
struct DequantBf16 {
  const uint8_t* qs;
  uint8_t* wl;
  uint8_t* wh;
  const float* __restrict__ scale;
  int N, ng, col, row0, gsize, g, rem;
  float4 sl, sh;

  __device__ __forceinline__ DequantBf16(const uint8_t* qs_, uint8_t* wl_, uint8_t* wh_,
                                         const float* __restrict__ scale_, int N_, int n0,
                                         int r0, int ng_, int group, bool active)
      : qs(qs_), wl(wl_), wh(wh_), scale(scale_), N(N_), ng(ng_) {
    const int c = 4 * (threadIdx.x % 32);
    row0 = (threadIdx.x / 32) * 4;
    // Columns past N hold zero nibbles and are masked at the store; their
    // scales are read at a column inside N.
    col = n0 + c < N ? n0 + c : N - 4;
    gsize = ng == 1 ? 1 << 30 : group;
    const int base = r0 + row0;
    g = base / gsize;
    rem = base - g * gsize;
    if (active) load_scales();
  }

  __device__ __forceinline__ void load_scales() {
    sl = __ldg(reinterpret_cast<const float4*>(scale + (size_t)g * N + col));
    sh = __ldg(reinterpret_cast<const float4*>(scale + (size_t)(ng == 1 ? 0 : ng / 2 + g) * N + col));
  }

  __device__ __forceinline__ void row(int i) {
    if (rem == gsize) {       // the next group starts inside this thread's rows
      ++g;
      rem = 0;
      load_scales();
    }
    ++rem;
    const int c = 4 * (threadIdx.x % 32);
    const uint32_t word = *reinterpret_cast<const uint32_t*>(qs + (row0 + i) * kBN + c);
    const float s_lo[4] = {sl.x, sl.y, sl.z, sl.w}, s_hi[4] = {sh.x, sh.y, sh.z, sh.w};
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = __fmul_rn(nibble_value(((word >> (8 * j)) & 0xFu) | 0x4B000000u), s_lo[j]);
      hi[j] = __fmul_rn(nibble_value(((word >> (8 * j + 4)) & 0xFu) | 0x4B000000u), s_hi[j]);
    }
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(lo[0], lo[1]);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(lo[2], lo[3]);
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(hi[0], hi[1]);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(hi[2], hi[3]);
    *reinterpret_cast<uint2*>(wl + (row0 + i) * kW16Stride + 2 * c) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&l01), *reinterpret_cast<const uint32_t*>(&l23));
    *reinterpret_cast<uint2*>(wh + (row0 + i) * kW16Stride + 2 * c) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&h01), *reinterpret_cast<const uint32_t*>(&h23));
  }
};

// The int8 values v - 8 of four nibbles v held one a byte: the high bit
// of each byte keeps the subtraction from borrowing across bytes.
__device__ __forceinline__ uint32_t centered4(uint32_t nibbles) {
  return ((nibbles | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// w4a8: the thread takes column c = tid % kBN of the tile and its 16 packed
// rows h*16 .. h*16+15 (h = tid / kBN), and writes wl/wh[c][k] = (q - 8) of
// the low/high nibbles as int8, exact: 16 contiguous k values a half. One
// group of 4 rows per rows(i) call (the stores follow the last).
struct DequantS8 {
  const uint8_t* qs;
  uint8_t* wl;
  uint8_t* wh;
  uint32_t lo[4], hi[4];

  __device__ __forceinline__ DequantS8(const uint8_t* qs_, uint8_t* wl_, uint8_t* wh_)
      : qs(qs_), wl(wl_), wh(wh_) {}

  __device__ __forceinline__ void rows(int i) {
    const int c = threadIdx.x % kBN, h = threadIdx.x / kBN;
    const uint8_t* p = qs + (h * 16 + 4 * i) * kBN + c;
    // Bytes of rows 4i .. 4i+3 into one word, row 4i in byte 0.
    const uint32_t word = __byte_perm(__byte_perm(p[0], p[kBN], 0x0040),
                                      __byte_perm(p[2 * kBN], p[3 * kBN], 0x0040), 0x5410);
    lo[i] = centered4(word & 0x0F0F0F0Fu);
    hi[i] = centered4((word >> 4) & 0x0F0F0F0Fu);
    if (i == 3) {
      *reinterpret_cast<uint4*>(wl + c * kW8Stride + h * 16) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(wh + c * kW8Stride + h * 16) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
};

// A fragment of the 16-row tile at row m of an x tile, k-byte offset kb
// (16 bf16 or 32 int8 of depth: 32 bytes).
template <int ES>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* xs, int m, int kb) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, xs + (m + lane % 16) * XTile<ES>::kStride + kb + (lane / 16) * 16);
}

// B fragments of the 4 8-column tiles at columns wn0 .. wn0+31: bf16 from
// the (k, n) tile at depth k0 .. k0+15 (transposed by ldmatrix), int8 from
// the (n, k) tile at depth 0 .. 31.
__device__ __forceinline__ void load_b_bf16(uint32_t (&b)[4][2], const uint8_t* ws, int wn0,
                                            int k0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, ws + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * kW16Stride +
                             (wn0 + np * 16 + (lane / 16) * 8) * 2);
    b[2 * np][0] = r[0];
    b[2 * np][1] = r[1];
    b[2 * np + 1][0] = r[2];
    b[2 * np + 1][1] = r[3];
  }
}
__device__ __forceinline__ void load_b_s8(uint32_t (&b)[4][2], const uint8_t* ws, int wn0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t r[4];
    ldmatrix_x4(r, ws + (wn0 + np * 16 + lane % 8 + (lane / 16) * 8) * kW8Stride +
                       ((lane / 8) % 2) * 16);
    b[2 * np][0] = r[0];
    b[2 * np][1] = r[1];
    b[2 * np + 1][0] = r[2];
    b[2 * np + 1][1] = r[3];
  }
}

// Shared memory of a kernel with BM-row x tiles of ES-byte elements: the
// ring of stages, then two buffers of the low and high weight tiles.
// (Ring: the stages in flight, kStages unless a kernel asks for more.)
template <int BM, int ES, int WBytes, int Ring = kStages>
struct Layout {
  static constexpr int kRing = Ring;
  static constexpr int kX = BM * XTile<ES>::kStride;   // one x tile
  static constexpr int kStage = kQBytes + 2 * kX;
  static constexpr int kBytes = Ring * kStage + 4 * WBytes;
  __device__ static uint8_t* q(uint8_t* s, int stage) { return s + stage % Ring * kStage; }
  __device__ static uint8_t* xl(uint8_t* s, int stage) { return q(s, stage) + kQBytes; }
  __device__ static uint8_t* xh(uint8_t* s, int stage) { return xl(s, stage) + kX; }
  __device__ static uint8_t* wl(uint8_t* s, int stage) {
    return s + Ring * kStage + stage % 2 * 2 * WBytes;
  }
  __device__ static uint8_t* wh(uint8_t* s, int stage) { return wl(s, stage) + WBytes; }
};

// The K loop both tensor-core kernels share. Iteration kt multiplies stage
// kt's x tiles by its weight tiles, dequantizes stage kt+1's packed tile
// into the other weight buffer, and starts the copies of stage kt+2: one
// block-wide sync a stage orders the buffers. dequant(s) dequantizes stage
// s whole (the first stage, before the loop); stage(kt, next, fetch) runs
// iteration kt's products with stage kt+1's dequantization (when next)
// and the copies (fetch()) interleaved between them, so the ALU work and
// the copies issue while the tensor cores execute the products.
template <typename L, int BM, int ES, typename Dequant, typename Stage>
__device__ __forceinline__ void k_loop(uint8_t* smem, const uint8_t* __restrict__ q4,
                                       const uint8_t* __restrict__ x, int M, int K, int N,
                                       int m0, int n0, bool n_vec, Dequant dequant,
                                       Stage stage) {
  const int stages = K / 2 / kBK;
  auto load = [&](int s) {
    if (s < stages)
      load_stage<BM, ES>(L::q(smem, s), L::xl(smem, s), L::xh(smem, s), q4, x, M, K, N, m0,
                         n0, s * kBK, n_vec);
    cp_async_commit();
  };
  load(0);
  load(1);
  cp_async_wait<1>();
  __syncthreads();
  dequant(0);
  for (int kt = 0; kt < stages; ++kt) {
    cp_async_wait<0>();
    __syncthreads();   // stage kt+1 landed, stage kt's weights whole, stage kt-1 done
    stage(kt, kt + 1 < stages, [&] { load(kt + 2); });
  }
}


// Rows [m0, m0 + BM) of bf16 x (M, K) times columns [n0, n0 + kBN) of
// dequant(q4, scale), added to acc (int4_matmul_tc_kernel's product;
// int4_ff.cu's up projection): warp w holds rows wm0 = (w / 4) * BM / 2 ..
// + BM / 2 - 1 and columns wn0 = (w % 4) * 32 .. + 31 of the tile, its
// accumulator (mt, nt) rows wm0 + 16 mt + lane / 4 (+ 8) and columns
// wn0 + 8 nt + 2 (lane % 4) + {0, 1}.
template <int BM>
__device__ __forceinline__ void w4a16_tile(float (&acc)[BM / 32][4][4], uint8_t* smem,
                                           const __nv_bfloat16* __restrict__ x,
                                           const uint8_t* __restrict__ q4,
                                           const float* __restrict__ scale, int M, int K,
                                           int N, int ng, int group, bool n_vec, int m0,
                                           int n0) {
  using L = Layout<BM, 2, kW16Bytes>;
  constexpr int MT = BM / 32;   // 16-row MMA tiles a warp: its rows are BM / 2
  const int warp = threadIdx.x / 32;
  const int wm0 = (warp / 4) * (BM / 2), wn0 = (warp % 4) * 32;
  auto dequant = [&](int s, bool active) {
    return DequantBf16(L::q(smem, s), L::wl(smem, s), L::wh(smem, s), scale, N, n0, s * kBK,
                       ng, group, active);
  };
  auto stage = [&](int kt, bool next, auto fetch) {
    DequantBf16 d = dequant(kt + 1, next);
    // Four groups of 16 products (low and high half, two k16 steps each),
    // one row of the next stage's dequantization after each.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int half = j / 2, k0 = (j % 2) * 16;
      const uint8_t* xs = half ? L::xh(smem, kt) : L::xl(smem, kt);
      uint32_t b[4][2];
      load_b_bf16(b, half ? L::wh(smem, kt) : L::wl(smem, kt), wn0, k0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        load_a<2>(a, xs, wm0 + mt * 16, 2 * k0);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
      if (j == 0) fetch();
      if (next) d.row(j);
    }
  };
  k_loop<L, BM, 2>(smem, q4, reinterpret_cast<const uint8_t*>(x), M, K, N, m0, n0, n_vec,
                      [&](int s) {
                        DequantBf16 d = dequant(s, true);
#pragma unroll
                        for (int i = 0; i < 4; ++i) d.row(i);
                      },
                      stage);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// int4_matmul.cu's design 3: small M on tensor cores with the operands swapped.

namespace sm {

using namespace tc_prims;

constexpr int kTiles = 2;                  // 16-column MMA tiles a warp
constexpr int kCols = 16 * kTiles;         // 32 output columns a warp
constexpr int kLaneCols = 2 * kTiles;      // 4 columns a lane: one 32-bit word a packed row
constexpr int kRows = 8;                   // rows of x a warp: the MMA's n
constexpr int kChunk = 32;                 // packed rows a chunk
constexpr int kStages = 2;                 // chunks of loads a lane keeps in flight
constexpr int kMaxPieces = 16;             // pieces of K a block splits a column tile into
constexpr int kMaxThreads = 512;           // kMaxPieces warps
constexpr int kTileOut = kRows * kCols;    // outputs of a column tile and row tile

// Column tiles a block takes beside its pieces: 4 warps at least.
__host__ __device__ __forceinline__ int tiles_a_block(int splits) {
  return splits >= 4 ? 1 : 4 / splits;
}

// The lane's 4 columns of one packed row as one word, zeros past N (N is a
// multiple of 4). Streamed weights: read once, kept out of L1.
__device__ __forceinline__ uint32_t load_cols(const uint8_t* row, int col, int N) {
  uint32_t v = 0u;
  if (col < N) asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(row + col));
  return v;
}

// Scales of the lane's 4 columns in one scale row, zeros past N.
__device__ __forceinline__ void load_scales(float (&s)[kLaneCols], const float* __restrict__ row,
                                            int col, int N) {
  const float4 v = col < N ? __ldg(reinterpret_cast<const float4*>(row + col))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  s[0] = v.x;
  s[1] = v.y;
  s[2] = v.z;
  s[3] = v.w;
}

// Packed-row chunks [c0, c1) of piece p of `splits`, over `groups` runs of
// cg chunks: up to one piece a group, a piece takes whole groups; past that,
// each group is cut into d = splits / groups pieces. w4a16 passes one-chunk
// groups. ops/int4_matmul.py::split_pieces is the plain twin.
struct Span {
  int c0, c1, d;
};
__device__ __forceinline__ Span piece_span(int p, int splits, int groups, int cg) {
  if (splits <= groups) return {p * groups / splits * cg, (p + 1) * groups / splits * cg, 1};
  const int d = splits / groups, g = p / d, j = p % d;
  return {g * cg + j * cg / d, g * cg + (j + 1) * cg / d, d};
}

// A warp's work: warp w of the block takes piece p = w / C of column tile
// ci = w % C of the block's C = tiles_a_block(splits), the grid's column
// tile ct. Inactive past N (it still meets the block's barrier).
struct Item {
  int ci, ct, p;
  bool active;
};
__device__ __forceinline__ Item work_item(int N, int splits) {
  const int tiles = tiles_a_block(splits), w = threadIdx.x / 32;
  Item it;
  it.ci = w % tiles;
  it.p = w / tiles;
  it.ct = blockIdx.x * tiles + it.ci;
  it.active = it.ct * kCols < N;
  return it;
}

// Exactly (float)(v - 8) for nibble v in byte I of a word of masked nibbles.
template <int I>
__device__ __forceinline__ float nibble(uint32_t masked) {
  return __fsub_rn(__uint_as_float(__byte_perm(masked, 0x4Bu, 0x4550 + I)), 8388616.f);
}

// (q - 8) * s in fp32 for the lane's 4 columns of one packed row, low or
// high nibbles (rounded to bf16 where they are packed into fragments).
template <bool High>
__device__ __forceinline__ void dequant_row(float (&v)[kLaneCols], uint32_t word,
                                            const float (&s)[kLaneCols]) {
  const uint32_t m = (High ? word >> 4 : word) & 0x0F0F0F0Fu;
  v[0] = __fmul_rn(nibble<0>(m), s[0]);
  v[1] = __fmul_rn(nibble<1>(m), s[1]);
  v[2] = __fmul_rn(nibble<2>(m), s[2]);
  v[3] = __fmul_rn(nibble<3>(m), s[3]);
}

// 4 x 4 byte transpose: o[j] byte i = w[i] byte j.
__device__ __forceinline__ void transpose4(uint32_t (&o)[4], uint32_t w0, uint32_t w1, uint32_t w2,
                                           uint32_t w3) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t2 = __byte_perm(w0, w1, 0x7362), t3 = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// Four nibbles v, one a byte, as the int8 values v - 8 (the high bit of each
// byte keeps the subtraction from borrowing across bytes).
__device__ __forceinline__ uint32_t centered(uint32_t nibbles) {
  return ((nibbles | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// Run the chunks [c0, c1) through a ring of kStages stages: the loads of
// chunks c+1 .. c+kStages-1 are in flight while chunk c's products run.
// fetch(stage, c) issues a chunk's loads, compute(stage, c) uses them.
template <typename Stage, typename Fetch, typename Compute>
__device__ __forceinline__ void chunk_ring(int c0, int c1, Fetch fetch, Compute compute) {
  Stage st[kStages];
#pragma unroll
  for (int i = 0; i + 1 < kStages; ++i)
    if (c0 + i < c1) fetch(st[i], c0 + i);
  for (int c = c0; c < c1; c += kStages) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (c + i >= c1) break;
      if (c + i + kStages - 1 < c1) fetch(st[(i + kStages - 1) % kStages], c + i + kStages - 1);
      compute(st[i], c + i);
    }
  }
}

// Where lane (g, t) keeps value e of tile nt of its C fragment in a column
// tile's kRows x kCols partial: row 2t + e % 2, column kLaneCols g + 2 nt +
// e / 2.
__device__ __forceinline__ int frag_index(int g, int t, int nt, int e) {
  return (2 * t + e % 2) * kCols + kLaneCols * g + 2 * nt + e / 2;
}

}  // namespace sm

}  // namespace int4_common
