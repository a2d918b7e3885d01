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

template <int NW, int BM>
__global__ void __launch_bounds__(kThreads, 2) int4_matmul_tc_kernel(
    const __nv_bfloat16* __restrict__ x, Weights w, int M, int K, int N, int ng, int group,
    int n_vec) {
  using namespace tc;
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
  w4a16_tile<BM>(acc, smem, x, q4, scale, M, K, N, ng, group, n_vec, m0, n0);

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
