// Fused int4 dequant-matmul for Hopper (sm_90a), plain CUDA C++.
//
// Replaces three TPU kernels of learning_jax_sharding_tpu/ops/int4_matmul.py:
//   _kernel       (pallas_call in int4_matmul):   x @ dequant(q4, s), w4a16
//   _kernel3      (pallas_call in int4_matmul3):  the q/k/v triple, one launch
//   _kernel_w4a8  (pallas_call in int4_matmul):   int8 rows x int4 -> int32
// They compute what those kernels compute, on the split-half packed layout
// described in int4_common.cuh.
//
// Numerics. w4a16: each dequantized weight (q - 8) * s is computed in fp32
// and rounded to x's dtype T, products accumulate in fp32, the output is T.
// NW weights (1, or 3 for q/k/v) share one x: blockIdx.z picks the weight.
// w4a8: x arrives as per-row int8 (the wrapper's quantize_rows_int8) with
// fp32 row scales; each scale group's products are summed exactly in int32,
// converted to fp32, multiplied by the group scale, summed over the groups in
// order (low group g, then high group g), multiplied by the row scale and
// written in T. The three designs below compute exactly this; the wrapper
// (ops/int4_matmul.py::_variant) picks one by shape.
//
// Design 1, CUDA cores (int4_matmul_kernel<T, NW>, int4_matmul_w4a8_kernel<T>;
// fp32 activations, the rows between designs 3 and 2, and layouts neither
// takes). A
// block owns 32 output columns and up to 8 rows of x, staged in shared
// memory. Its 256 threads are 8 column threads x 32 row slices: a thread
// reads one 32-bit word (4 neighbouring columns) of q4 per packed row, so 8
// threads read 128 contiguous bytes of a row, and it walks the packed rows of
// its slice (int4_common.cuh, shared with int4_ff.cu). The TPU kernel's whole
// (K/2, block_n) tile in VMEM becomes 32 slices reduced in the block, by warp
// shuffles and then over the 8 warps in a fixed order (w4a8 reduces its
// int32 group partials, which is exact). Products run as fp32 FMA or
// __dp4a. It is the yardstick of design 3 at decode.
//
// Design 2, tensor cores (int4_matmul_tc_kernel<NW, BM> for bf16 x,
// int4_matmul_w4a8_tc_kernel<T> for int8 x; prefill and the larger M past
// design 1's grid limit, K/2 a multiple of 32 and, for w4a8, groups a
// multiple of 32 packed rows). A block owns a 128 x 128 or 96 x 128 (w4a16:
// whichever leaves the busiest SM fewer rows, ops/int4_matmul.py::
// _tile_rows) or 64 x 128 (w4a8) output tile; 8 warps in 2 x 4 each hold a
// 64 x 32 (48 x 32) or 32 x 32 piece in registers. The K loop walks 32 packed
// rows a stage through a 3-stage cp.async ring in shared memory. A stage
// has the packed tile and two x tiles, since packed rows [r0, r0+32) meet x
// columns [r0, r0+32) through their low nibbles and [K/2+r0, K/2+r0+32)
// through their high nibbles. Each packed tile is dequantized ONCE per
// block into two weight tiles, double-buffered, while the tensor cores
// multiply the previous stage: bf16 (q - 8) * s for w4a16, stored (k, n)
// and read transposed by ldmatrix.trans, with the scale of the row's own
// group (any group that divides K/2, or one whole-K group); the exact int8
// (q - 8) for w4a8, stored (n, k). Products run on mma.sync.m16n8k16 bf16
// -> fp32, or m16n8k32 s8 -> s32 with two int32 accumulators per output
// (low and high nibble rows), folded into an fp32 total (kept in shared
// memory) at each group's end in design 1's order. At M = 1024 each weight
// is read and dequantized M/128 = 8 times (16 for w4a8) instead of M/8 =
// 128. Bound at prefill (1024 rows): the products, 2*M*K*N operations, over
// the bf16 (989 TFLOP/s) or int8 (1979 TOP/s) tensor-core peak.
//
// Design 3, small M on tensor cores (int4_matmul_small_m_kernel<NW> for bf16
// x, int4_matmul_w4a8_small_m_kernel<T> for int8 x; decode and up to a few
// dozen rows, K/2 and every group whole 32-row chunks). Bound at decode (8
// rows): the packed weights and scales over 3.35 TB/s (0.31 MB for a
// 768 x 768 projection, 20.5 MB for the 125M lm_head). The operands are
// swapped, out^T = W^T x^T: the dequantized weights are the A operand (16
// output columns x depth) and 8 rows of x the B operand, the n = 8 of
// mma.sync.m16n8k16 (bf16) and m16n8k32 (s8), so nothing is padded. Inside
// one MMA the depth order is free as long as A and B agree, and the
// column order is free as long as the epilogue stores by it: a lane takes 4
// neighbouring columns of a packed row as one 32-bit word of q4, builds its
// A fragments from those words in registers (w4a16: two packed rows'
// (q - 8) * s in fp32, rounded to bf16 in pairs; w4a8: a 4 x 4 byte
// transpose of four rows, centred to int8), and reads its B fragments as
// words of x's own rows in place: no shared-memory tile at all. A warp owns
// 32 output columns and a piece of the packed rows, walked in 32-row chunks
// with the next chunk's loads issued before this one's products. Where the
// column tiles leave the card under-filled (the 768-column sites), K is
// split into pieces (ops/int4_matmul.py::_splits, at most 16): the pieces of
// a column tile are the warps of one block, and their partials meet in
// shared memory after one barrier, added in piece order (w4a16, fp32) or,
// for w4a8, as exact int32 sums per scale group (pieces of whole groups, or
// equal parts of every group) that then fold in design 1's order: bit-equal
// to the plain version, split or not. No second kernel, no workspace.
//
// What the designs leave for later: wgmma (warpgroup MMA from shared memory,
// the only way to Hopper's full tensor-core rate; mma.sync reaches a part of
// it), TMA with mbarriers in place of cp.async, a persistent grid that
// overlaps one tile's epilogue with the next tile's loads and evens out
// grids of a few blocks an SM (the 96-row tile only narrows that
// imbalance), a producer warp that dequantizes while
// consumer warpgroups multiply (here every warp does both, with one
// block-wide sync a stage), and larger warp tiles (fewer fragment loads a
// product; registers cap them at 64 x 32). Design 3 spends more
// instructions dequantizing than moving bytes: its lm_head sits at about 3x
// its bytes bound, and a cheaper dequantization (fewer operations a nibble)
// is its next step.

#include "int4_common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace int4_common;

struct Weights {
  const uint8_t* q4[3];
  const float* scale[3];
  void* out[3];
};

template <typename T, int NW>
__global__ void __launch_bounds__(kThreads) int4_matmul_kernel(
    const T* __restrict__ x, Weights w, int M, int K, int N, int ng, int group,
    int tile_m) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                                    // tile_m x K
  float* red = reinterpret_cast<float*>(smem + align16((size_t)tile_m * K * sizeof(T)));

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * tile_m;
  stage_rows(xs, x, m0, M, K, tile_m);
  __syncthreads();

  // Pick the weight with selects: indexing the parameter arrays by a
  // run-time value would copy them to local memory.
  const int which = NW == 1 ? 0 : blockIdx.z;
  const uint8_t* __restrict__ q4 = which == 0 ? w.q4[0] : which == 1 ? w.q4[1] : w.q4[2];
  const float* __restrict__ scale =
      which == 0 ? w.scale[0] : which == 1 ? w.scale[1] : w.scale[2];
  T* __restrict__ out = static_cast<T*>(which == 0 ? w.out[0] : which == 1 ? w.out[1] : w.out[2]);
  const int cg = tid % kColThreads, slice = tid / kColThreads;
  const int c0 = blockIdx.x * kTileN + cg * 4;

  float acc[kMaxTileM][4];
  zero(acc);
  if (c0 < N) w4a16_accumulate<T>(acc, xs, q4, scale, N, c0, K, ng, group, tile_m, slice);

  store_warp_sums(acc, red);
  __syncthreads();
  if (tid < tile_m * kTileN) {
    const int m = tid / kTileN, c = tid % kTileN;
    const int row = m0 + m, col = blockIdx.x * kTileN + c;
    if (row < M && col < N) out[(size_t)row * N + col] = Num<T>::store(warp_sum(red, m, c));
  }
}

// 4 packed rows (words w[0..3], rows r..r+3) of one column byte j -> the low
// and high nibbles as int8x4, row r in byte 0, for __dp4a.
__device__ __forceinline__ void nibbles4(const uint32_t (&w)[4], int j, int& lo, int& hi) {
  uint32_t l = 0, h = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int byte = (w[i] >> (8 * j)) & 0xFF;
    l |= (uint32_t)(((byte & 0xF) - 8) & 0xFF) << (8 * i);
    h |= (uint32_t)(((byte >> 4) - 8) & 0xFF) << (8 * i);
  }
  lo = (int)l;
  hi = (int)h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) int4_matmul_w4a8_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx,
    const uint8_t* __restrict__ q4, const float* __restrict__ scale, T* __restrict__ out,
    int M, int K, int N, int ng, int group, int tile_m) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);                          // tile_m x K
  int* red_lo = reinterpret_cast<int*>(smem + align16((size_t)tile_m * K));
  int* red_hi = red_lo + kWarps * kMaxTileM * kTileN;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * tile_m;
  for (int i = tid; i < tile_m * K; i += kThreads) {
    const int m = i / K;
    xs[i] = m0 + m < M ? xq[(size_t)(m0 + m) * K + i % K] : 0;
  }
  __syncthreads();

  const int cg = tid % kColThreads, slice = tid / kColThreads;
  const int c0 = blockIdx.x * kTileN + cg * 4;
  const int k_half = K / 2;
  // One whole-K group: all packed rows, low and high summed in int32 before
  // the single scale, as the TPU kernel does.
  const int rows = ng == 1 ? k_half : group;
  const int ngroups = ng == 1 ? 1 : ng / 2;
  // The epilogue thread of output (em, ec) keeps its fp32 sum over groups.
  const int em = tid / kTileN, ec = tid % kTileN;
  const int erow = m0 + em, ecol = blockIdx.x * kTileN + ec;
  const bool epilogue = tid < tile_m * kTileN && erow < M && ecol < N;
  float total = 0.f;

  for (int g = 0; g < ngroups; ++g) {
    int acc_lo[kMaxTileM][4], acc_hi[kMaxTileM][4];
    zero(acc_lo);
    zero(acc_hi);

    if (c0 < N) {
      for (int r = g * rows + slice * 4; r < (g + 1) * rows; r += kSlices * 4) {
        uint32_t words[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          words[i] = *reinterpret_cast<const uint32_t*>(q4 + (size_t)(r + i) * N + c0);
        int lo4[4], hi4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) nibbles4(words, j, lo4[j], hi4[j]);
#pragma unroll
        for (int m = 0; m < kMaxTileM; ++m) {
          if (m < tile_m) {
            const int xl = *reinterpret_cast<const int*>(xs + m * K + r);
            const int xh = *reinterpret_cast<const int*>(xs + m * K + k_half + r);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc_lo[m][j] = __dp4a(xl, lo4[j], acc_lo[m][j]);
              acc_hi[m][j] = __dp4a(xh, hi4[j], acc_hi[m][j]);
            }
          }
        }
      }
    }

    store_warp_sums(acc_lo, red_lo);
    store_warp_sums(acc_hi, red_hi);
    __syncthreads();
    if (epilogue) {
      const int lo = warp_sum(red_lo, em, ec), hi = warp_sum(red_hi, em, ec);
      if (ng == 1) {
        total = __fmul_rn((float)(lo + hi), scale[ecol]);
      } else {
        total = __fadd_rn(total, __fmul_rn((float)lo, scale[(size_t)g * N + ecol]));
        total = __fadd_rn(total, __fmul_rn((float)hi, scale[(size_t)(ng / 2 + g) * N + ecol]));
      }
    }
    __syncthreads();   // red_lo / red_hi are rewritten by the next group
  }
  if (epilogue) out[(size_t)erow * N + ecol] = Num<T>::store(__fmul_rn(total, sx[erow]));
}

// ---------------------------------------------------------------------------
// Design 2: tensor cores.

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
template <int BM, int ES, int WBytes>
struct Layout {
  static constexpr int kX = BM * XTile<ES>::kStride;   // one x tile
  static constexpr int kStage = kQBytes + 2 * kX;
  static constexpr int kBytes = kStages * kStage + 4 * WBytes;
  __device__ static uint8_t* q(uint8_t* s, int stage) { return s + stage % kStages * kStage; }
  __device__ static uint8_t* xl(uint8_t* s, int stage) { return q(s, stage) + kQBytes; }
  __device__ static uint8_t* xh(uint8_t* s, int stage) { return xl(s, stage) + kX; }
  __device__ static uint8_t* wl(uint8_t* s, int stage) {
    return s + kStages * kStage + stage % 2 * 2 * WBytes;
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

}  // namespace tc

template <int NW, int BM>
__global__ void __launch_bounds__(kThreads, 2) int4_matmul_tc_kernel(
    const __nv_bfloat16* __restrict__ x, Weights w, int M, int K, int N, int ng, int group,
    int n_vec) {
  using namespace tc;
  using L = Layout<BM, 2, kW16Bytes>;
  constexpr int MT = BM / 32;   // 16-row MMA tiles a warp: its rows are BM / 2
  extern __shared__ __align__(16) unsigned char smem[];
  const int which = NW == 1 ? 0 : blockIdx.z;
  const uint8_t* __restrict__ q4 = which == 0 ? w.q4[0] : which == 1 ? w.q4[1] : w.q4[2];
  const float* __restrict__ scale =
      which == 0 ? w.scale[0] : which == 1 ? w.scale[1] : w.scale[2];
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(
      which == 0 ? w.out[0] : which == 1 ? w.out[1] : w.out[2]);

  // blockIdx.x walks M fastest: the row tiles that share a weight tile run
  // together and find it in L2.
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / 4) * (BM / 2), wn0 = (warp % 4) * 32;
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

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

  // Accumulator (mt, nt): rows lane/4 (+8), columns 2*(lane%4) + {0, 1}.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn0 + nt * 8 + 2 * (lane % 4);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + wm0 + mt * 16 + lane / 4 + 8 * hr;
        if (row < M && col < N)   // N is even: col < N covers col + 1
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
      }
    }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// w4a8 keeps each thread's 32 fp32 totals in shared memory, [slot][thread]
// (one word per thread a slot: no bank conflicts), touched once a group:
// the registers go to the two int32 accumulators, and two blocks fit an SM.
constexpr int kTotals = 2 * 4 * 4;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) int4_matmul_w4a8_tc_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const uint8_t* __restrict__ q4,
    const float* __restrict__ scale, T* __restrict__ out, int M, int K, int N, int ng,
    int group, int n_vec) {
  using namespace tc;
  using L = Layout<kBM8, 1, kW8Bytes>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * kBM8, n0 = blockIdx.y * kBN;
  // One whole-K group: all packed rows, low and high summed in int32 before
  // the single scale, as design 1 does.
  const int group_stages = (ng == 1 ? K / 2 : group) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / 4) * 32, wn0 = (warp % 4) * 32;
  int acc_lo[2][4][4], acc_hi[2][4][4];
  float* totals = reinterpret_cast<float*>(smem + L::kBytes) + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_lo[i][j][e] = acc_hi[i][j][e] = 0;
#pragma unroll
  for (int i = 0; i < kTotals; ++i) totals[i * kThreads] = 0.f;

  // Two groups of 8 products (the low half, then the high half), two
  // word rows of the next stage's dequantization after each.
  auto products = [&](int (&acc)[2][4][4], const uint8_t* xs, const uint8_t* ws) {
    uint32_t b[4][2];
    load_b_s8(b, ws, wn0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t a[4];
      load_a<1>(a, xs, wm0 + mt * 16, 0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
    }
  };
  // At a group's end, fold its exact int32 partials into the fp32 total.
  auto fold = [&](int kt) {
    if ((kt + 1) % group_stages) return;
    const int g = (kt + 1) / group_stages - 1;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + wn0 + nt * 8 + 2 * (lane % 4) + e;
        const int cc = col < N ? col : N - 1;
        const float sl = __ldg(scale + (size_t)g * N + cc);
        const float sh = ng == 1 ? 0.f : __ldg(scale + (size_t)(ng / 2 + g) * N + cc);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 2 * hr + e;
            float& t = totals[((mt * 4 + nt) * 4 + i) * kThreads];
            if (ng == 1) {
              t = __fmul_rn((float)(acc_lo[mt][nt][i] + acc_hi[mt][nt][i]), sl);
            } else {
              t = __fadd_rn(t, __fmul_rn((float)acc_lo[mt][nt][i], sl));
              t = __fadd_rn(t, __fmul_rn((float)acc_hi[mt][nt][i], sh));
            }
            acc_lo[mt][nt][i] = acc_hi[mt][nt][i] = 0;
          }
      }
  };
  auto stage = [&](int kt, bool next, auto fetch) {
    DequantS8 d(L::q(smem, kt + 1), L::wl(smem, kt + 1), L::wh(smem, kt + 1));
    products(acc_lo, L::xl(smem, kt), L::wl(smem, kt));
    fetch();
    if (next) {
      d.rows(0);
      d.rows(1);
    }
    products(acc_hi, L::xh(smem, kt), L::wh(smem, kt));
    if (next) {
      d.rows(2);
      d.rows(3);
    }
    fold(kt);
  };
  k_loop<L, kBM8, 1>(smem, q4, reinterpret_cast<const uint8_t*>(xq), M, K, N, m0, n0, n_vec,
                     [&](int s) {
                       DequantS8 d(L::q(smem, s), L::wl(smem, s), L::wh(smem, s));
#pragma unroll
                       for (int i = 0; i < 4; ++i) d.rows(i);
                     },
                     stage);

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm0 + mt * 16 + lane / 4 + 8 * hr;
      if (row >= M) continue;
      const float s = sx[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn0 + nt * 8 + 2 * (lane % 4);
        if (col < N)
          store2<T>(out + (size_t)row * N + col,
                    __fmul_rn(totals[((mt * 4 + nt) * 4 + 2 * hr) * kThreads], s),
                    __fmul_rn(totals[((mt * 4 + nt) * 4 + 2 * hr + 1) * kThreads], s));
      }
    }
}

// ---------------------------------------------------------------------------
// Design 3: small M on tensor cores with the operands swapped.

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

// The lane of a small-M warp: g = lane / 4 names its 4 columns from col =
// kCols ct + 4 g and its row of x, m0 + g (the B operand's column g); t =
// lane % 4 its depth slots. MMA tile T (16 "rows" = output columns) maps its
// row g to column col + 2T and its row g + 8 to col + 2T + 1, so lane (g, t)
// builds its A fragments from the word it loaded of each packed row, and its
// C fragment holds columns col + 2T (c0, c1) and col + 2T + 1 (c2, c3) of x
// rows m0 + 2t (c0, c2) and m0 + 2t + 1 (c1, c3). A split's pieces of a
// column tile are warps of one block: each writes its fp32 partial to shared
// memory, and after the block's barrier the outputs are their sums in piece
// order, rounded to bf16.
template <int NW>
__global__ void __launch_bounds__(sm::kMaxThreads) int4_matmul_small_m_kernel(
    const __nv_bfloat16* __restrict__ x, Weights w, int M, int K, int N, int ng, int group,
    int splits) {
  using namespace sm;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);   // [ci][p][kRows][kCols]
  const Item it = work_item(N, splits);
  const int which = NW == 1 ? 0 : blockIdx.z;
  const uint8_t* __restrict__ q4 = which == 0 ? w.q4[0] : which == 1 ? w.q4[1] : w.q4[2];
  const float* __restrict__ scale =
      which == 0 ? w.scale[0] : which == 1 ? w.scale[1] : w.scale[2];
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(
      which == 0 ? w.out[0] : which == 1 ? w.out[1] : w.out[2]);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k_half = K / 2, chunks = k_half / kChunk;
  const int col = it.ct * kCols + kLaneCols * g, m0 = blockIdx.y * kRows;
  const bool x_in = m0 + g < M;
  const uint32_t* __restrict__ xrow =
      reinterpret_cast<const uint32_t*>(x + (size_t)(x_in ? m0 + g : 0) * K);

  // A chunk (32 packed rows from r0) is 4 k16 steps. Step s gives lane t
  // the packed rows r0 + 8s + 2t + {0, 1}: depth slots 2t, 2t + 1 are
  // their low nibbles (x columns r0 + 8s + 2t + {0, 1}), slots 8 + 2t,
  // 9 + 2t their high nibbles (x columns K/2 + the same): both x pairs are
  // one 32-bit word of x's own row, read in place.
  struct Stage {
    uint32_t q[8];                        // packed row r0 + 8s + 2t + e at q[2s + e]
    uint32_t b[4][2];                     // step s: x low and high pairs
    float sl[kLaneCols], sh[kLaneCols];   // the chunk's group scales, low and high
  };
  float acc[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  auto fetch = [&](Stage& st, int c) {
    const int r0 = c * kChunk;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        st.q[2 * s + e] = load_cols(q4 + (size_t)(r0 + 8 * s + 2 * t + e) * N, col, N);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = r0 + 8 * s + 2 * t;
      st.b[s][0] = x_in ? __ldg(xrow + k / 2) : 0u;
      st.b[s][1] = x_in ? __ldg(xrow + (k_half + k) / 2) : 0u;
    }
    const int gi = ng == 1 ? 0 : r0 / group;
    load_scales(st.sl, scale + (size_t)gi * N, col, N);
    load_scales(st.sh, scale + (size_t)(ng == 1 ? 0 : ng / 2 + gi) * N, col, N);
  };
  auto compute = [&](const Stage& st, int) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float lo0[kLaneCols], lo1[kLaneCols], hi0[kLaneCols], hi1[kLaneCols];
      dequant_row<false>(lo0, st.q[2 * s], st.sl);
      dequant_row<false>(lo1, st.q[2 * s + 1], st.sl);
      dequant_row<true>(hi0, st.q[2 * s], st.sh);
      dequant_row<true>(hi1, st.q[2 * s + 1], st.sh);
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const uint32_t a[4] = {pack_bf16(lo0[2 * nt], lo1[2 * nt]),
                               pack_bf16(lo0[2 * nt + 1], lo1[2 * nt + 1]),
                               pack_bf16(hi0[2 * nt], hi1[2 * nt]),
                               pack_bf16(hi0[2 * nt + 1], hi1[2 * nt + 1])};
        mma_bf16(acc[nt], a, st.b[s][0], st.b[s][1]);
      }
    }
  };
  if (it.active) {
    const Span span = piece_span(it.p, splits, chunks, 1);
    chunk_ring<Stage>(span.c0, span.c1, fetch, compute);
  }

  if (splits == 1) {
    if (!it.active) return;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + 2 * t + hr;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const int c = col + 2 * nt;
        if (c < N)   // N is a multiple of 4: c < N covers c + 1
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + c) =
              __floats2bfloat162_rn(acc[nt][hr], acc[nt][2 + hr]);
      }
    }
    return;
  }
  float* mine = part + (size_t)(it.ci * splits + it.p) * kTileOut;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[frag_index(g, t, nt, e)] = acc[nt][e];
  __syncthreads();
  const int tiles = tiles_a_block(splits);
  for (int o = threadIdx.x; o < tiles * kTileOut; o += blockDim.x) {
    const int ci = o / kTileOut, i = o % kTileOut;
    const int m = m0 + i / kCols, c = (blockIdx.x * tiles + ci) * kCols + i % kCols;
    if (m >= M || c >= N) continue;
    const float* p = part + (size_t)ci * splits * kTileOut + i;
    float sum = p[0];
    for (int j = 1; j < splits; ++j) sum = __fadd_rn(sum, p[(size_t)j * kTileOut]);
    out[(size_t)m * N + c] = __float2bfloat16(sum);
  }
}

// w4a8: a chunk (32 packed rows from r0) is one k32 step of each half. Lane
// t takes the packed rows r0 + 16h + 4t + i (h, i < 2, 4): depth slots
// 4t + i and 16 + 4t + i, in the byte order of x's own row, so its B
// fragments are 32-bit words of x read in place. A 4 x 4 byte transpose
// turns four packed rows x the lane's four columns into one word per column,
// the int8 A fragment of that column (low nibbles for the low half's
// product, high for the high half's). Each scale group's int32 sums stay
// exact: at its end (or the piece's), they fold into fp32 in design 1's
// order (unsplit), or go to the block's shared memory as the slot of that
// group (or of the piece, past one piece a group); after the barrier each
// output adds a group's slots in int32 and folds them in design 1's order.
template <typename T>
__global__ void __launch_bounds__(sm::kMaxThreads) int4_matmul_w4a8_small_m_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const uint8_t* __restrict__ q4,
    const float* __restrict__ scale, T* __restrict__ out, int M, int K, int N, int ng, int group,
    int splits) {
  using namespace sm;
  extern __shared__ __align__(16) unsigned char smem[];
  const Item it = work_item(N, splits);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k_half = K / 2, chunks = k_half / kChunk;
  // One whole-K group: all packed rows, low and high summed in int32 before
  // the single scale, as design 1 does.
  const int groups = ng == 1 ? 1 : ng / 2;
  const int cg = chunks / groups;
  const int d = splits <= groups ? 1 : splits / groups;
  const int slots = groups * d;
  const Span span = piece_span(it.p, splits, groups, cg);
  int* part = reinterpret_cast<int*>(smem);   // [ci][slot][lo, hi][kRows][kCols]
  const int col = it.ct * kCols + kLaneCols * g, m0 = blockIdx.y * kRows;
  const bool x_in = m0 + g < M;
  const uint32_t* __restrict__ xrow =
      reinterpret_cast<const uint32_t*>(xq + (size_t)(x_in ? m0 + g : 0) * K);

  struct Stage {
    uint32_t q[8];           // packed row r0 + 16h + 4t + i at q[4h + i]
    uint32_t b[4];           // x words: low (h = 0, 1), then high
  };
  int acc_lo[kTiles][4], acc_hi[kTiles][4];
  float total[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_lo[i][e] = acc_hi[i][e] = 0;
      total[i][e] = 0.f;
    }

  auto fetch = [&](Stage& st, int c) {
    const int r0 = c * kChunk;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st.q[4 * h + i] = load_cols(q4 + (size_t)(r0 + 16 * h + 4 * t + i) * N, col, N);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = r0 + 16 * h + 4 * t;
      st.b[h] = x_in ? __ldg(xrow + k / 4) : 0u;
      st.b[2 + h] = x_in ? __ldg(xrow + (k_half + k) / 4) : 0u;
    }
  };
  // The group's (or the piece's part of it) int32 sums are whole: fold them
  // (unsplit) or keep them as their slot; start the next group from zero.
  auto group_end = [&](int gi) {
    if (splits == 1) {
      float sl[kLaneCols], sh[kLaneCols];
      load_scales(sl, scale + (size_t)gi * N, col, N);
      load_scales(sh, scale + (size_t)(ng == 1 ? 0 : ng / 2 + gi) * N, col, N);
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int L = 2 * nt + e / 2;
          float& v = total[nt][e];
          if (ng == 1) {
            v = __fmul_rn((float)(acc_lo[nt][e] + acc_hi[nt][e]), sl[L]);
          } else {
            v = __fadd_rn(v, __fmul_rn((float)acc_lo[nt][e], sl[L]));
            v = __fadd_rn(v, __fmul_rn((float)acc_hi[nt][e], sh[L]));
          }
        }
    } else {
      const int slot = d == 1 ? gi : it.p;
      int* lo = part + ((size_t)(it.ci * slots + slot) * 2) * kTileOut;
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[frag_index(g, t, nt, e)] = acc_lo[nt][e];
          lo[kTileOut + frag_index(g, t, nt, e)] = acc_hi[nt][e];
        }
    }
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_lo[nt][e] = acc_hi[nt][e] = 0;
  };
  auto compute = [&](const Stage& st, int c) {
    uint32_t o0[4], o1[4];                  // per column: rows 4t + i, and 16 + 4t + i
    transpose4(o0, st.q[0], st.q[1], st.q[2], st.q[3]);
    transpose4(o1, st.q[4], st.q[5], st.q[6], st.q[7]);
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {   // columns 2 nt, 2 nt + 1
      const uint32_t a_lo[4] = {centered(o0[2 * nt] & 0x0F0F0F0Fu),
                                centered(o0[2 * nt + 1] & 0x0F0F0F0Fu),
                                centered(o1[2 * nt] & 0x0F0F0F0Fu),
                                centered(o1[2 * nt + 1] & 0x0F0F0F0Fu)};
      const uint32_t a_hi[4] = {centered((o0[2 * nt] >> 4) & 0x0F0F0F0Fu),
                                centered((o0[2 * nt + 1] >> 4) & 0x0F0F0F0Fu),
                                centered((o1[2 * nt] >> 4) & 0x0F0F0F0Fu),
                                centered((o1[2 * nt + 1] >> 4) & 0x0F0F0F0Fu)};
      tc::mma_s8(acc_lo[nt], a_lo, st.b[0], st.b[1]);
      tc::mma_s8(acc_hi[nt], a_hi, st.b[2], st.b[3]);
    }
    if ((c + 1) % cg == 0 || c + 1 == span.c1) group_end(c / cg);
  };
  if (it.active) chunk_ring<Stage>(span.c0, span.c1, fetch, compute);

  if (splits == 1) {
    if (!it.active) return;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + 2 * t + hr;
      if (m >= M) continue;
      const float s = sx[m];
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const int c = col + 2 * nt;
        if (c < N)
          store2<T>(out + (size_t)m * N + c, __fmul_rn(total[nt][hr], s),
                    __fmul_rn(total[nt][2 + hr], s));
      }
    }
    return;
  }
  __syncthreads();
  const int tiles = tiles_a_block(splits);
  for (int o = threadIdx.x; o < tiles * kTileOut; o += blockDim.x) {
    const int ci = o / kTileOut, i = o % kTileOut;
    const int m = m0 + i / kCols, c = (blockIdx.x * tiles + ci) * kCols + i % kCols;
    if (m >= M || c >= N) continue;
    const int* p = part + (size_t)ci * slots * 2 * kTileOut + i;
    float v = 0.f;
    for (int gi = 0; gi < groups; ++gi) {
      int lo = 0, hi = 0;
      for (int j = 0; j < d; ++j) {
        lo += p[(size_t)((gi * d + j) * 2) * kTileOut];
        hi += p[(size_t)((gi * d + j) * 2 + 1) * kTileOut];
      }
      if (ng == 1) {
        v = __fmul_rn((float)(lo + hi), scale[c]);
      } else {
        v = __fadd_rn(v, __fmul_rn((float)lo, scale[(size_t)gi * N + c]));
        v = __fadd_rn(v, __fmul_rn((float)hi, scale[(size_t)(ng / 2 + gi) * N + c]));
      }
    }
    out[(size_t)m * N + c] = Num<T>::store(__fmul_rn(v, sx[m]));
  }
}

// Rows of x per block: up to 8, fewer when a tile of x would not fit.
int pick_tile_m(int M, int K, int itemsize) {
  int tile = kMaxTileM;
  while (tile > 1 && (size_t)tile * K * itemsize > 160 * 1024) tile /= 2;
  return M < tile ? M : tile;
}

template <typename Fn>
cudaError_t set_smem(Fn kernel, size_t bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int NW>
int launch_w4a16(const void* x, const Weights& w, int M, int K, int N, int ng, int group,
                 cudaStream_t stream) {
  if (M == 0) return (int)cudaSuccess;
  const int tile_m = pick_tile_m(M, K, sizeof(T));
  const size_t smem = ((size_t)tile_m * K * sizeof(T) + 15) / 16 * 16 +
                      (size_t)kWarps * kMaxTileM * kTileN * sizeof(float);
  auto kernel = int4_matmul_kernel<T, NW>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTileN - 1) / kTileN, (M + tile_m - 1) / tile_m, NW);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), w, M, K, N, ng, group,
                                           tile_m);
  return (int)cudaGetLastError();
}

// Design 2 for bf16 x with BM-row tiles.
template <int NW, int BM>
int launch_w4a16_tc_tiles(const void* x, const Weights& w, int M, int K, int N, int ng,
                          int group, bool n_vec, cudaStream_t stream) {
  using L = tc::Layout<BM, 2, tc::kW16Bytes>;
  auto kernel = int4_matmul_tc_kernel<NW, BM>;
  cudaError_t err = set_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (N + tc::kBN - 1) / tc::kBN, NW);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(static_cast<const __nv_bfloat16*>(x), w, M, K, N,
                                                ng, group, n_vec);
  return (int)cudaGetLastError();
}

// Design 2 for bf16 x: K/2 a multiple of 32 (whole stages); x 16-byte
// aligned; tile_rows rows of x a block, tc::kBM16 or tc::kBM16Small (the
// wrapper's choice, ops/int4_matmul.py::_tile_rows).
template <int NW>
int launch_w4a16_tc(const void* x, const Weights& w, int M, int K, int N, int ng, int group,
                    int tile_rows, cudaStream_t stream) {
  if (M == 0) return (int)cudaSuccess;
  if ((K / 2) % tc::kBK || reinterpret_cast<uintptr_t>(x) % 16) return -1;
  bool n_vec = N % 16 == 0;
  for (int i = 0; i < NW; ++i) n_vec = n_vec && reinterpret_cast<uintptr_t>(w.q4[i]) % 16 == 0;
  if (tile_rows == tc::kBM16)
    return launch_w4a16_tc_tiles<NW, tc::kBM16>(x, w, M, K, N, ng, group, n_vec, stream);
  if (tile_rows == tc::kBM16Small)
    return launch_w4a16_tc_tiles<NW, tc::kBM16Small>(x, w, M, K, N, ng, group, n_vec, stream);
  return -1;
}

template <typename T>
int launch_w4a8(const int8_t* xq, const float* sx, const uint8_t* q4, const float* scale,
                void* out, int M, int K, int N, int ng, int group, cudaStream_t stream) {
  if (M == 0) return (int)cudaSuccess;
  const int tile_m = pick_tile_m(M, K, 1);
  const size_t smem = ((size_t)tile_m * K + 15) / 16 * 16 +
                      2 * (size_t)kWarps * kMaxTileM * kTileN * sizeof(int);
  auto kernel = int4_matmul_w4a8_kernel<T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTileN - 1) / kTileN, (M + tile_m - 1) / tile_m);
  kernel<<<grid, kThreads, smem, stream>>>(xq, sx, q4, scale, static_cast<T*>(out), M, K, N,
                                           ng, group, tile_m);
  return (int)cudaGetLastError();
}

// Design 2 for int8 x: K/2 and every group (or K/2 for one whole-K group)
// a multiple of 32 packed rows, the MMA's depth; xq 16-byte aligned.
template <typename T>
int launch_w4a8_tc(const int8_t* xq, const float* sx, const uint8_t* q4, const float* scale,
                   void* out, int M, int K, int N, int ng, int group, cudaStream_t stream) {
  using L = tc::Layout<tc::kBM8, 1, tc::kW8Bytes>;
  constexpr int kBytes = L::kBytes + kTotals * kThreads * sizeof(float);
  if (M == 0) return (int)cudaSuccess;
  const int rows = ng == 1 ? K / 2 : group;
  if ((K / 2) % tc::kBK || rows % tc::kBK || reinterpret_cast<uintptr_t>(xq) % 16) return -1;
  const bool n_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(q4) % 16 == 0;
  auto kernel = int4_matmul_w4a8_tc_kernel<T>;
  cudaError_t err = set_smem(kernel, kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + tc::kBM8 - 1) / tc::kBM8, (N + tc::kBN - 1) / tc::kBN);
  kernel<<<grid, kThreads, kBytes, stream>>>(xq, sx, q4, scale, static_cast<T*>(out), M, K,
                                                N, ng, group, n_vec);
  return (int)cudaGetLastError();
}

// Design 3's grid: a block takes tiles_a_block(splits) 32-column tiles,
// each in `splits` pieces of K (a warp each); x rows in tiles of 8 (y); NW
// weights (z).
inline dim3 small_m_grid(int M, int N, int splits, int nw) {
  const int tiles = sm::tiles_a_block(splits);
  const int tiles_n = (N + sm::kCols - 1) / sm::kCols;
  return dim3((tiles_n + tiles - 1) / tiles, (M + sm::kRows - 1) / sm::kRows, nw);
}

// The layout design 3 takes: K/2 in whole 32-row chunks, each group (or the
// one whole-K group) whole chunks.
inline bool small_m_layout(int K, int ng, int group) {
  return K % 2 == 0 && (K / 2) % sm::kChunk == 0 && (ng == 1 || group % sm::kChunk == 0);
}

// Design 3 for bf16 x: `splits` pieces of the packed rows (at most one a
// chunk, at most kMaxPieces), each column tile's pieces in one block.
template <int NW>
int launch_w4a16_small_m(const void* x, const Weights& w, int M, int K, int N, int ng,
                         int group, int splits, cudaStream_t stream) {
  if (M == 0) return (int)cudaSuccess;
  if (!small_m_layout(K, ng, group) || splits < 1 || splits > sm::kMaxPieces ||
      splits > K / 2 / sm::kChunk || reinterpret_cast<uintptr_t>(x) % 4)
    return -1;
  const int tiles = sm::tiles_a_block(splits);
  const size_t smem = splits == 1 ? 0 : (size_t)tiles * splits * sm::kTileOut * sizeof(float);
  auto kernel = int4_matmul_small_m_kernel<NW>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<small_m_grid(M, N, splits, NW), 32 * tiles * splits, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, M, K, N, ng, group, splits);
  return (int)cudaGetLastError();
}

// Design 3 for int8 x: `splits` pieces (at most kMaxPieces) of whole groups
// (up to one a group) or of equal parts of every group (a multiple of the
// groups, at most one a chunk of each); their int32 group sums meet in the
// block's shared memory (tiles x slots x 2 x 8 x 32 int32, slots the groups,
// or the pieces past one a group).
template <typename T>
int launch_w4a8_small_m(const int8_t* xq, const float* sx, const uint8_t* q4, const float* scale,
                        void* out, int M, int K, int N, int ng, int group, int splits,
                        cudaStream_t stream) {
  if (M == 0) return (int)cudaSuccess;
  if (!small_m_layout(K, ng, group) || reinterpret_cast<uintptr_t>(xq) % 4) return -1;
  const int groups = ng == 1 ? 1 : ng / 2;
  const int cg = K / 2 / sm::kChunk / groups;
  const int d = splits <= groups ? 1 : splits / groups;
  if (splits < 1 || splits > sm::kMaxPieces || (splits > groups && (splits % groups || d > cg)))
    return -1;
  const int tiles = sm::tiles_a_block(splits);
  const size_t smem =
      splits == 1 ? 0 : (size_t)tiles * groups * d * 2 * sm::kTileOut * sizeof(int);
  auto kernel = int4_matmul_w4a8_small_m_kernel<T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<small_m_grid(M, N, splits, 1), 32 * tiles * splits, smem, stream>>>(
      xq, sx, q4, scale, static_cast<T*>(out), M, K, N, ng, group, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x @ dequant(q4_i, s_i) -> out_i for i < nw (1 or 3), all (K/2, N) weights of
// one layout; dtype 0 = fp32, 1 = bf16 (x and outputs). design 0 runs design
// 1; design 1 design 2 (bf16 only) with tile_rows (128 or 96) rows of x a
// block; design 2 design 3 (bf16 only) in `splits` pieces. Returns
// cudaGetLastError() after the launch, or -1 for an unsupported dtype, nw,
// design, tile, split or layout.
int int4_matmul_launch(const void* x, const void* q0, const void* s0, void* o0,
                       const void* q1, const void* s1, void* o1, const void* q2,
                       const void* s2, void* o2, int dtype, int nw, int M, int K, int N,
                       int ng, int group, int design, int tile_rows, int splits,
                       void* stream) {
  Weights w;
  const void* qs[3] = {q0, q1, q2};
  const void* ss[3] = {s0, s1, s2};
  void* os[3] = {o0, o1, o2};
  for (int i = 0; i < 3; ++i) {
    w.q4[i] = static_cast<const uint8_t*>(qs[i]);
    w.scale[i] = static_cast<const float*>(ss[i]);
    w.out[i] = os[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 2) {
    if (dtype == 1 && nw == 1)
      return launch_w4a16_small_m<1>(x, w, M, K, N, ng, group, splits, st);
    if (dtype == 1 && nw == 3)
      return launch_w4a16_small_m<3>(x, w, M, K, N, ng, group, splits, st);
    return -1;
  }
  if (design == 1) {
    if (dtype == 1 && nw == 1) return launch_w4a16_tc<1>(x, w, M, K, N, ng, group, tile_rows, st);
    if (dtype == 1 && nw == 3) return launch_w4a16_tc<3>(x, w, M, K, N, ng, group, tile_rows, st);
    return -1;
  }
  if (design != 0) return -1;
  if (dtype == 0 && nw == 1) return launch_w4a16<float, 1>(x, w, M, K, N, ng, group, st);
  if (dtype == 0 && nw == 3) return launch_w4a16<float, 3>(x, w, M, K, N, ng, group, st);
  if (dtype == 1 && nw == 1) return launch_w4a16<__nv_bfloat16, 1>(x, w, M, K, N, ng, group, st);
  if (dtype == 1 && nw == 3) return launch_w4a16<__nv_bfloat16, 3>(x, w, M, K, N, ng, group, st);
  return -1;
}

// Per-row int8 xq (M, K) with fp32 row scales sx (M, 1) against q4/s ->
// out (M, N) in dtype (0 = fp32, 1 = bf16). Design 1 (design 0): K % 8 ==
// 0, and a group (or K/2 for one whole-K group) a multiple of 4 packed
// rows; design 2 (design 1): both multiples of 32 packed rows; design 3
// (design 2): the same, in `splits` pieces. Returns cudaGetLastError() after
// the launch, or -1 for an unsupported dtype, design, split or layout.
int int4_matmul_w4a8_launch(const void* xq, const void* sx, const void* q4, const void* s,
                            void* out, int dtype, int M, int K, int N, int ng, int group,
                            int design, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* rs = static_cast<const float*>(sx);
  const uint8_t* q = static_cast<const uint8_t*>(q4);
  const float* sc = static_cast<const float*>(s);
  if (design == 2) {
    if (dtype == 0)
      return launch_w4a8_small_m<float>(x, rs, q, sc, out, M, K, N, ng, group, splits, st);
    if (dtype == 1)
      return launch_w4a8_small_m<__nv_bfloat16>(x, rs, q, sc, out, M, K, N, ng, group, splits,
                                                st);
    return -1;
  }
  if (design == 1) {
    if (dtype == 0) return launch_w4a8_tc<float>(x, rs, q, sc, out, M, K, N, ng, group, st);
    if (dtype == 1) return launch_w4a8_tc<__nv_bfloat16>(x, rs, q, sc, out, M, K, N, ng, group, st);
    return -1;
  }
  if (design != 0) return -1;
  if (dtype == 0) return launch_w4a8<float>(x, rs, q, sc, out, M, K, N, ng, group, st);
  if (dtype == 1) return launch_w4a8<__nv_bfloat16>(x, rs, q, sc, out, M, K, N, ng, group, st);
  return -1;
}

}  // extern "C"
