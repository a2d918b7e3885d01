// Flash attention for Hopper (sm_90a), plain CUDA C++: forward, dK/dV, dQ.
//
// Replaces the three TPU kernels of learning_jax_sharding_tpu/ops/
// flash_attention.py: _fwd_kernel (launched by _fwd), _bwd_dkv_kernel and
// _bwd_dq_kernel (both launched by _bwd). Each computes what its TPU kernel
// computes, on the folded layout: q is (B*N_kv, S*group, H) rows, where row r
// is position r / group (the GQA group folds into the rows), and k, v, dk, dv
// are (B*N_kv, S_kv, H). Masks compare positions with key indices: causal
// keeps c <= pos, a window keeps c > pos - window. Masked scores are -1e30
// and their probabilities exactly 0.
//
//   flash_fwd      one block per (slab, 64-row q tile); loops over the k tiles
//                  from the tile's window start to its causal frontier (all
//                  of them when not causal), online softmax in fp32; writes
//                  out in the input dtype and lse = m + log(l) in fp32.
//   flash_bwd_dkv  one block per (slab, 64-key tile); loops over the q tiles
//                  that attend into it (from row c * group; to the window's
//                  end); recomputes p = exp(s * scale - lse); dv += p^T dO,
//                  dp = dO V^T, ds = p (dp - delta), dk += ds^T Q; writes
//                  dk * scale and dv. The group's rows are rows of the same
//                  sweep, so dk/dv sum over the group without atomics.
//   flash_bwd_dq   one block per (slab, 64-row q tile); loops over k tiles as
//                  the forward; dq += ds K; writes dq * scale.
//
// The two backward sweeps write disjoint outputs, so there are no atomics and
// the result is deterministic. As in the TPU kernels, products take the
// input-dtype values and accumulate in fp32; p (before p.V and p^T.dO) and ds
// (before ds^T.Q and ds.K) are rounded to the input dtype.
//
// Two designs. fp32 runs all three kernels on the CUDA cores, bf16 all three
// on the tensor cores. The wrapper (ops/flash_attention.py::_fwd_design,
// _bwd_design) picks each kernel's design by dtype alone: tensor cores take
// fp32 only as TF32 (a 10-bit mantissa), which would break the fp32
// semantics of the JAX kernels. Both designs replace the same three TPU
// kernels.
//
// Design 1, CUDA cores (flash_fwd_kernel<T, H>, flash_bwd_dkv_kernel<T, H>,
// flash_bwd_dq_kernel<T, H>; the bf16 instantiations stay reachable for
// holding one design against the other). The TPU kernels'
// sequential innermost grid axis and VMEM scratch
// become a loop inside one thread block of 256 threads, with the running
// max, sum and output rows in registers. Tiles are staged in shared memory
// as fp32, row-major with a leading dimension of H + 4 (or 64 + 4 for tiles
// stored transposed), which makes the float4 row reads of a warp
// conflict-free. Every product is "rows of A times rows of B" over a
// contiguous inner dimension: thread (ty, tx) = (tid / 16, tid % 16) owns
// output rows ty + 16 i and columns tx + 16 j, so a row of the score tile
// lives in the 16 lanes of one half-warp and its max and sum reduce with
// four shuffles. Operands that a product needs the other way round (V in
// the forward, Q and dO in dK/dV, K in dQ) are staged a second time,
// transposed. Keys past S_kv and rows past S*group (a partial last tile) are
// loaded as zeros, masked, and never written.
//
// Design 2, tensor cores (flash_fwd_tc_kernel<H, BK, min_blocks>,
// flash_bwd_dkv_tc_kernel<H>, flash_bwd_dq_tc_kernel<H, BK, held>; bf16, H
// 64 or 128). Blocks of 4 warps, each warp owning 16 q rows (forward, dQ)
// or 16 keys (dK/dV) of the block's 64; every product is
// mma.sync.m16n8k16 bf16 -> fp32 (tensor_core.cuh). The block's own Q
// (forward), Q and dO (dQ) or K and V (dK/dV) are loaded once; the other
// operands stream through a 2-stage cp.async ring in shared memory, rows
// padded by 16 bytes so that ldmatrix is conflict-free, partial tiles
// zero-filled by the copy and masked. The forward and dQ compute S = Q K^T
// (dQ also dP = dO V^T), dK/dV S^T = K Q^T and dP^T = V dO^T, with B read
// from the streamed tiles as they lie; p and ds then go from the fp32
// accumulators to bf16 A fragments in registers (two 8-column C tiles make
// one 16-deep A fragment, FlashAttention-2's register reuse, no trip
// through shared memory), which is exactly the bf16 rounding of p and ds
// above; O += P V, dV += P^T dO, dK += dS^T Q and dQ += dS K read B from
// the same tiles through ldmatrix.trans. The forward keeps its online
// softmax on the C fragments (the row max and sum reduce over the 4 lanes
// that share a row). Tiles wholly inside the mask skip it. Causal sweeps
// differ in length by up to 16x: block i takes tile i / bn of slab i % bn,
// dK/dV from the first key tile, the forward and dQ from the last q tile,
// so the longest sweeps start first and the tail is short. The tiles keep
// three blocks an SM (four for the forward) at H = 64 (see fwd_tc and
// dkv_tc below).
//
// Bound on this card at the 125M training shape (folded q (96, 1024, 64)
// bf16, causal: 524,800 (q, k) pairs per slab), from the H100 SXM data-sheet
// peaks (3.35 TB/s; 989 TFLOP/s dense bf16):
//   fwd      12.9 GFLOP (13.0 us) and 50.7 MB (15.1 us): 15.1 us, bytes;
//   dK/dV    25.8 GFLOP: 26.08 us, operations;
//   dQ       19.3 GFLOP: 19.56 us, operations.
// The forward's tensor-core grid there is 96 slabs x 16 q tiles = 1536
// blocks of 128 threads, four resident an SM (3 waves on 132 SMs), each
// sweeping 1-16 64-key tiles. The CUDA-core design reaches at most the 67
// TFLOP/s of fp32 FMA (about 18-21 TFLOP/s here); the tensor-core design
// moves the products to the bf16 tensor cores, where the forward's online
// softmax (exponentials, row max and sum, the accumulator's rescaling) is
// the larger share of its instructions. What it leaves for a later
// redesign: wgmma (warpgroup MMA from shared memory, the only way to the
// full bf16 rate; mma.sync reaches a part of it), TMA with mbarriers in
// place of cp.async, warp specialisation (a producer warp keeping loads in
// flight while consumer warpgroups multiply, and two consumer warpgroups
// taking turns between products and softmax), and a persistent grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // q rows / keys per tile
constexpr int kLdT = kTile + 4;    // leading dim of [*][64] tiles
constexpr float kNegInf = -1e30f;  // as the TPU kernels: keeps exp/max NaN-free

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

// x rounded to T and back: what the TPU kernels' .astype(input dtype) does
// to p and ds before a product.
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 bytes of row `row` at column `c` of a (rows, H) slab, as fp32; zeros
// for a row past `rows`.
template <typename T, int H>
__device__ __forceinline__ void load_chunk(float* vals, const T* slab, int row,
                                           int c, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  if (row < rows) {
    const uint4 raw = *reinterpret_cast<const uint4*>(slab + (size_t)row * H + c);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) vals[e] = to_float(t[e]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
  }
}

// Rows [row0, row0 + 64) of a (rows, H) slab into dst[r * (H + 4) + d].
template <typename T, int H>
__device__ __forceinline__ void load_rows(float* dst, const T* slab, int row0, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = H / kVec;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    float vals[kVec];
    load_chunk<T, H>(vals, slab, row0 + r, c, rows);
    float* out = dst + r * (H + 4) + c;
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(out + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

// The same rows, transposed: dst[d * kLdT + r]. Consecutive threads take
// consecutive rows, so the scalar shared-memory stores do not conflict.
template <typename T, int H>
__device__ __forceinline__ void load_rows_t(float* dst, const T* slab, int row0, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = H / kVec;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i % kTile, c = (i / kTile) * kVec;
    float vals[kVec];
    load_chunk<T, H>(vals, slab, row0 + r, c, rows);
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[(c + e) * kLdT + r] = vals[e];
  }
}

// acc[i][j] += sum_k A[(ty + 16 i) * LDA + k] * B[(tx + 16 j) * LDB + k].
template <int NI, int NJ, int K, int LDA, int LDB>
__device__ __forceinline__ void nt_product(float (&acc)[NI][NJ], const float* A,
                                           const float* B, int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[NI], b[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LDA + k);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LDB + k);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// Max / sum over the 16 lanes of a half-warp (one score row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Shape {
  int rows_q, s_kv, group, causal, window;  // window <= 0: none
  float scale;
  int tiles;                               // tiles per slab (grid = slabs * tiles)
};

// May row `row` (< rows_q) attend key `col`?
__device__ __forceinline__ bool keep(const Shape& sh, int row, int col) {
  if (row >= sh.rows_q || col >= sh.s_kv) return false;
  const int pos = row / sh.group;
  if (sh.causal && col > pos) return false;
  if (sh.window > 0 && col <= pos - sh.window) return false;
  return true;
}

// The k tiles a q tile must visit: from its first position's window start
// to its last position's causal frontier.
__device__ __forceinline__ void k_span(const Shape& sh, int row0, int* first, int* last) {
  const int last_row = min(row0 + kTile, sh.rows_q) - 1;
  const int last_col = sh.causal ? min(last_row / sh.group, sh.s_kv - 1) : sh.s_kv - 1;
  const int first_col = sh.window > 0 ? max(0, row0 / sh.group - (sh.window - 1)) : 0;
  *first = first_col / kTile;
  *last = last_col / kTile;
}

// ---------------------------------------------------------------- forward

template <int H>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * (H + 4) + H * kLdT + kTile * kLdT);
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, Shape sh) {
  constexpr int LD = H + 4;
  constexpr int NJ = H / 16;
  const int slab = blockIdx.x / sh.tiles;
  const int row0 = (blockIdx.x % sh.tiles) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [64][H + 4]
  float* k_s = q_s + kTile * LD;     // [64][H + 4]
  float* vt_s = k_s + kTile * LD;    // [H][kLdT], V transposed
  float* p_s = vt_s + H * kLdT;      // [64][kLdT]

  const T* q_slab = q + (size_t)slab * sh.rows_q * H;
  const T* k_slab = k + (size_t)slab * sh.s_kv * H;
  const T* v_slab = v + (size_t)slab * sh.s_kv * H;
  load_rows<T, H>(q_s, q_slab, row0, sh.rows_q);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int first, last;
  k_span(sh, row0, &first, &last);
  for (int kt = first; kt <= last; ++kt) {
    const int col0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, H>(k_s, k_slab, col0, sh.s_kv);
    load_rows_t<T, H>(vt_s, v_slab, col0, sh.s_kv);
    __syncthreads();

    float s[4][4] = {};
    nt_product<4, 4, H, LD, LD>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      bool kept[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kept[j] = keep(sh, row, col0 + tx + 16 * j);
        s[i][j] = kept[j] ? s[i][j] * sh.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = kept[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(ty + 16 * i) * kLdT + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = corr * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    nt_product<4, NJ, kTile, kLdT, kLdT>(acc, p_s, vt_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < sh.rows_q) {
      const float safe_l = l[i] == 0.f ? 1.f : l[i];
      const size_t base = ((size_t)slab * sh.rows_q + row);
#pragma unroll
      for (int j = 0; j < NJ; ++j) store(out + base * H + tx + 16 * j, acc[i][j] / safe_l);
      if (tx == 0) lse[base] = m[i] + logf(safe_l);
    }
  }
}

// ---------------------------------------------------------------- dK / dV

template <int H>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (H + 4) + 2 * H * kLdT + kTile * kLdT + 2 * kTile);
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  constexpr int LD = H + 4;
  constexpr int NJ = H / 16;
  const int slab = blockIdx.x / sh.tiles;
  const int col0 = (blockIdx.x % sh.tiles) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // [64][H + 4], this block's keys
  float* v_s = k_s + kTile * LD;     // [64][H + 4]
  float* q_s = v_s + kTile * LD;     // [64][H + 4], the current q tile
  float* do_s = q_s + kTile * LD;    // [64][H + 4]
  float* qt_s = do_s + kTile * LD;   // [H][kLdT], Q transposed
  float* dot_s = qt_s + H * kLdT;    // [H][kLdT], dO transposed
  float* buf = dot_s + H * kLdT;     // [64 keys][kLdT rows]: p^T, then ds^T
  float* lse_s = buf + kTile * kLdT;
  float* delta_s = lse_s + kTile;

  const size_t q_off = (size_t)slab * sh.rows_q;
  const T* q_slab = q + q_off * H;
  const T* do_slab = dout + q_off * H;
  const T* k_slab = k + (size_t)slab * sh.s_kv * H;
  const T* v_slab = v + (size_t)slab * sh.s_kv * H;
  load_rows<T, H>(k_s, k_slab, col0, sh.s_kv);
  load_rows<T, H>(v_s, v_slab, col0, sh.s_kv);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // The q rows attending into keys [col0, last_col]: from the first key's
  // causal start to the last key's window end.
  const int last_col = min(col0 + kTile, sh.s_kv) - 1;
  const int first_row = sh.causal ? col0 * sh.group : 0;
  const int last_row = sh.window > 0
      ? min(sh.rows_q - 1, (last_col + sh.window - 1) * sh.group + sh.group - 1)
      : sh.rows_q - 1;
  for (int qt = first_row / kTile; first_row < sh.rows_q && qt <= last_row / kTile; ++qt) {
    const int row0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, H>(q_s, q_slab, row0, sh.rows_q);
    load_rows<T, H>(do_s, do_slab, row0, sh.rows_q);
    load_rows_t<T, H>(qt_s, q_slab, row0, sh.rows_q);
    load_rows_t<T, H>(dot_s, do_slab, row0, sh.rows_q);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = row0 + r < sh.rows_q;
      lse_s[r] = in ? lse[q_off + row0 + r] : 0.f;
      delta_s[r] = in ? delta[q_off + row0 + r] : 0.f;
    }
    __syncthreads();

    // Transposed scores: rows are keys (ty + 16 i), columns q rows (tx + 16 j).
    float s[4][4] = {}, dp[4][4] = {};
    nt_product<4, 4, H, LD, LD>(s, k_s, q_s, ty, tx);
    nt_product<4, 4, H, LD, LD>(dp, v_s, do_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float p = keep(sh, row0 + r, col0 + ty + 16 * i)
            ? expf(s[i][j] * sh.scale - lse_s[r]) : 0.f;
        s[i][j] = p * (dp[i][j] - delta_s[r]);  // ds
        buf[(ty + 16 * i) * kLdT + r] = round_to<T>(p);
      }
    }
    __syncthreads();
    nt_product<4, NJ, kTile, kLdT, kLdT>(dv_acc, buf, dot_s, ty, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) buf[(ty + 16 * i) * kLdT + tx + 16 * j] = round_to<T>(s[i][j]);
    __syncthreads();
    nt_product<4, NJ, kTile, kLdT, kLdT>(dk_acc, buf, qt_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = col0 + ty + 16 * i;
    if (col < sh.s_kv) {
      const size_t base = ((size_t)slab * sh.s_kv + col) * H;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        store(dk + base + tx + 16 * j, dk_acc[i][j] * sh.scale);
        store(dv + base + tx + 16 * j, dv_acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------- dQ

template <int H>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (H + 4) + H * kLdT + kTile * kLdT + 2 * kTile);
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, Shape sh) {
  constexpr int LD = H + 4;
  constexpr int NJ = H / 16;
  const int slab = blockIdx.x / sh.tiles;
  const int row0 = (blockIdx.x % sh.tiles) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [64][H + 4], this block's q rows
  float* do_s = q_s + kTile * LD;    // [64][H + 4]
  float* k_s = do_s + kTile * LD;    // [64][H + 4], the current k tile
  float* v_s = k_s + kTile * LD;     // [64][H + 4]
  float* kt_s = v_s + kTile * LD;    // [H][kLdT], K transposed
  float* ds_s = kt_s + H * kLdT;     // [64][kLdT]
  float* lse_s = ds_s + kTile * kLdT;
  float* delta_s = lse_s + kTile;

  const size_t q_off = (size_t)slab * sh.rows_q;
  const T* k_slab = k + (size_t)slab * sh.s_kv * H;
  const T* v_slab = v + (size_t)slab * sh.s_kv * H;
  load_rows<T, H>(q_s, q + q_off * H, row0, sh.rows_q);
  load_rows<T, H>(do_s, dout + q_off * H, row0, sh.rows_q);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = row0 + r < sh.rows_q;
    lse_s[r] = in ? lse[q_off + row0 + r] : 0.f;
    delta_s[r] = in ? delta[q_off + row0 + r] : 0.f;
  }

  float dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;

  int first, last;
  k_span(sh, row0, &first, &last);
  for (int kt = first; kt <= last; ++kt) {
    const int col0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, H>(k_s, k_slab, col0, sh.s_kv);
    load_rows<T, H>(v_s, v_slab, col0, sh.s_kv);
    load_rows_t<T, H>(kt_s, k_slab, col0, sh.s_kv);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    nt_product<4, 4, H, LD, LD>(s, q_s, k_s, ty, tx);
    nt_product<4, 4, H, LD, LD>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep(sh, row0 + r, col0 + tx + 16 * j)
            ? expf(s[i][j] * sh.scale - lse_s[r]) : 0.f;
        ds_s[r * kLdT + tx + 16 * j] = round_to<T>(p * (dp[i][j] - delta_s[r]));
      }
    }
    __syncthreads();
    nt_product<4, NJ, kTile, kLdT, kLdT>(dq_acc, ds_s, kt_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < sh.rows_q) {
      const size_t base = (q_off + row) * H;
#pragma unroll
      for (int j = 0; j < NJ; ++j) store(dq + base + tx + 16 * j, dq_acc[i][j] * sh.scale);
    }
  }
}

// ---------------------------------------------------------------- tensor cores

namespace tcb {

using namespace tc_prims;
using namespace tc_tiles;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // keys of a dK/dV block, q rows of a dQ block
constexpr int kBQ = 32;              // q rows of a dK/dV stage
constexpr float kLog2e = 1.4426950408889634f;

// cp.async of rows [row0, row0 + n) of a (rows, H) bf16 slab into dst; rows
// past `rows` read as zeros.
template <int H>
__device__ __forceinline__ void load_tile(uint8_t* dst, const __nv_bfloat16* slab, int row0,
                                          int n, int rows) {
  for (int i = threadIdx.x; i < n * Tile<H>::kChunks; i += kThreads) {
    const int r = i / Tile<H>::kChunks, c = i % Tile<H>::kChunks;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * Tile<H>::kStride + c * 16,
               slab + (size_t)(in ? row0 + r : 0) * H + c * 8, in ? 16 : 0);
  }
}

// cp.async of floats [row0, row0 + n) of a row vector; zeros past `rows`.
__device__ __forceinline__ void load_vec(float* dst, const float* vec, int row0, int n,
                                         int rows) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const bool in = row0 + r < rows;
    cp_async4(dst + r, vec + (in ? row0 + r : 0), in ? 4 : 0);
  }
}

// Does every (row, col) of [r0, r1] x [c0, c1] pass keep()? Then the tile
// needs no mask.
__device__ __forceinline__ bool all_kept(const Shape& sh, int r0, int r1, int c0, int c1) {
  if (r1 >= sh.rows_q || c1 >= sh.s_kv) return false;
  if (sh.causal && c1 > r0 / sh.group) return false;
  if (sh.window > 0 && c0 <= r1 / sh.group - sh.window) return false;
  return true;
}

// p = exp(s * scale - lse), exactly 0 where masked (scale2 and lse2 carry a
// factor log2(e)); leaves p in s and returns ds = p (dp - delta).
__device__ __forceinline__ float grad_score(float& s, float dp, float lse2, float delta,
                                            float scale2, bool kept) {
  const float p = kept ? exp2f(fmaf(s, scale2, -lse2)) : 0.f;
  s = p;
  return p * (dp - delta);
}

template <int H>
constexpr size_t dkv_smem() {
  return 2 * kRows * Tile<H>::kStride + 2 * (2 * kBQ * Tile<H>::kStride + 2 * kBQ * sizeof(float));
}

// dK/dV: one block per (slab, 64-key tile); warp w owns keys col0 + 16 w ..
// + 15 and loops over the 32-row q tiles that attend into the block's keys,
// streamed through a 2-stage cp.async ring. S^T = K Q^T and dP^T = V dO^T
// take A from the block's K and V tiles in shared memory and B from the q
// and dO tiles as they lie; P^T and dS^T stay in registers as the A
// fragments of dV += P^T dO and dK += dS^T Q, which take B from the same
// tiles through ldmatrix.trans.
template <int H>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Shape sh) {
  constexpr int S = Tile<H>::kStride;
  constexpr int BQ = kBQ;
  constexpr int NT = BQ / 8;
  constexpr int kStage = 2 * BQ * S + 2 * BQ * sizeof(float);
  // Causal sweeps are longest for the first key tiles: blocks take the tiles
  // in order, every slab's tile 0 first, so the long sweeps start first.
  const int bn = gridDim.x / sh.tiles;
  const int slab = blockIdx.x % bn;
  const int col0 = (blockIdx.x / bn) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  extern __shared__ __align__(16) uint8_t smem_tc[];
  uint8_t* k_s = smem_tc;              // [64 keys][S]
  uint8_t* v_s = k_s + kRows * S;
  uint8_t* ring = v_s + kRows * S;     // 2 stages of q, dO [BQ][S], lse, delta [BQ]

  const size_t q_off = (size_t)slab * sh.rows_q;
  const __nv_bfloat16* q_slab = q + q_off * H;
  const __nv_bfloat16* do_slab = dout + q_off * H;

  // The q rows attending into keys [col0, last_col]: from the first key's
  // causal start to the last key's window end.
  const int last_col = min(col0 + kRows, sh.s_kv) - 1;
  const int first_row = sh.causal ? col0 * sh.group : 0;
  const int last_row = sh.window > 0
      ? min(sh.rows_q - 1, (last_col + sh.window - 1) * sh.group + sh.group - 1)
      : sh.rows_q - 1;
  const int first_qt = first_row / BQ;
  const int n_tiles = first_row < sh.rows_q ? last_row / BQ - first_qt + 1 : 0;

  auto fetch = [&](int i) {
    uint8_t* st = ring + (i % 2) * kStage;
    const int row0 = (first_qt + i) * BQ;
    load_tile<H>(st, q_slab, row0, BQ, sh.rows_q);
    load_tile<H>(st + BQ * S, do_slab, row0, BQ, sh.rows_q);
    float* vec = reinterpret_cast<float*>(st + 2 * BQ * S);
    load_vec(vec, lse + q_off, row0, BQ, sh.rows_q);
    load_vec(vec + BQ, delta + q_off, row0, BQ, sh.rows_q);
  };
  load_tile<H>(k_s, k + (size_t)slab * sh.s_kv * H, col0, kRows, sh.s_kv);
  load_tile<H>(v_s, v + (size_t)slab * sh.s_kv * H, col0, kRows, sh.s_kv);
  cp_async_commit();
  if (n_tiles > 0) fetch(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float dk_acc[H / 8][4] = {}, dv_acc[H / 8][4] = {};
  const float scale2 = sh.scale * kLog2e;
  const int key_lo = col0 + warp * 16 + g;   // this thread's keys: key_lo, key_lo + 8
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) fetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint8_t* q_t = ring + (i % 2) * kStage;
    const uint8_t* do_t = q_t + BQ * S;
    const float* lse_t = reinterpret_cast<const float*>(do_t + BQ * S);
    const float* delta_t = lse_t + BQ;
    const int row0 = (first_qt + i) * BQ;

    // Transposed scores: rows are this warp's 16 keys, columns the q rows.
    float s[NT][4] = {}, dp[NT][4] = {};
    product_nk<H, NT>(s, k_s, warp * 16, q_t);
    product_nk<H, NT>(dp, v_s, warp * 16, do_t);
    const bool full = all_kept(sh, row0, row0 + BQ - 1, col0 + warp * 16,
                               col0 + warp * 16 + 15);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t + (e & 1);
        const bool kept = full || keep(sh, row0 + r, key_lo + 8 * (e >> 1));
        dp[j][e] = grad_score(s[j][e], dp[j][e], lse_t[r] * kLog2e, delta_t[r], scale2, kept);
      }
    }
    product_kn<H, NT>(dv_acc, s, do_t);
    product_kn<H, NT>(dk_acc, dp, q_t);
    __syncthreads();   // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + 8 * half;
    if (key < sh.s_kv) {
      const size_t base = ((size_t)slab * sh.s_kv + key) * H;
#pragma unroll
      for (int n = 0; n < H / 8; ++n) {
        const int c = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(dk + base + c) =
            pack_bf16(dk_acc[n][2 * half] * sh.scale, dk_acc[n][2 * half + 1] * sh.scale);
        *reinterpret_cast<uint32_t*>(dv + base + c) =
            pack_bf16(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
      }
    }
  }
}

template <int H, int BK>
constexpr size_t dq_smem() {
  return 2 * kRows * Tile<H>::kStride + 2 * (2 * BK * Tile<H>::kStride);
}

// dQ: one block per (slab, 64-row q tile); warp w owns rows row0 + 16 w ..
// + 15 and loops over the BK-key tiles its block's rows attend, K and V
// streamed through a 2-stage cp.async ring. S = Q K^T and dP = dO V^T take B
// from the K and V tiles as they lie; dS stays in registers as the A
// fragment of dQ += dS K, which takes B from the K tile through
// ldmatrix.trans. kHeld: Q and dO stay in registers as A fragments.
template <int H, int BK, bool kHeld>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, Shape sh) {
  constexpr int S = Tile<H>::kStride;
  constexpr int NT = BK / 8;
  constexpr int kStage = 2 * BK * S;
  // Causal sweeps are longest for the last q tiles: blocks take the tiles
  // from the last, every slab's at once, so the long sweeps start first.
  const int bn = gridDim.x / sh.tiles;
  const int slab = blockIdx.x % bn;
  const int tile = sh.causal ? sh.tiles - 1 - blockIdx.x / bn : blockIdx.x / bn;
  const int row0 = tile * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  extern __shared__ __align__(16) uint8_t smem_tc[];
  uint8_t* q_s = smem_tc;              // [64 rows][S]
  uint8_t* do_s = q_s + kRows * S;
  uint8_t* ring = do_s + kRows * S;    // 2 stages of k, v [BK][S]

  const size_t q_off = (size_t)slab * sh.rows_q;
  const __nv_bfloat16* k_slab = k + (size_t)slab * sh.s_kv * H;
  const __nv_bfloat16* v_slab = v + (size_t)slab * sh.s_kv * H;

  // The keys this block's rows attend: from its first position's window
  // start to its last position's causal frontier.
  const int last_row = min(row0 + kRows, sh.rows_q) - 1;
  const int last_col = sh.causal ? min(last_row / sh.group, sh.s_kv - 1) : sh.s_kv - 1;
  const int first_col = sh.window > 0 ? max(0, row0 / sh.group - (sh.window - 1)) : 0;
  const int first_kt = first_col / BK;
  const int n_tiles = last_col / BK - first_kt + 1;

  auto fetch = [&](int i) {
    uint8_t* st = ring + (i % 2) * kStage;
    const int c0 = (first_kt + i) * BK;
    load_tile<H>(st, k_slab, c0, BK, sh.s_kv);
    load_tile<H>(st + BK * S, v_slab, c0, BK, sh.s_kv);
  };
  load_tile<H>(q_s, q + q_off * H, row0, kRows, sh.rows_q);
  load_tile<H>(do_s, dout + q_off * H, row0, kRows, sh.rows_q);
  cp_async_commit();
  if (n_tiles > 0) fetch(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[kHeld ? H / 16 : 1][4], dof[kHeld ? H / 16 : 1][4];
  if constexpr (kHeld) {
#pragma unroll
    for (int ks = 0; ks < H / 16; ++ks) {
      load_a<H>(qf[ks], q_s, warp * 16, ks * 16);
      load_a<H>(dof[ks], do_s, warp * 16, ks * 16);
    }
  }
  const int row_lo = row0 + warp * 16 + g;   // this thread's rows: row_lo, row_lo + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = row_lo + 8 * h < sh.rows_q;
    lse2[h] = in ? lse[q_off + row_lo + 8 * h] * kLog2e : 0.f;
    dlt[h] = in ? delta[q_off + row_lo + 8 * h] : 0.f;
  }

  float dq_acc[H / 8][4] = {};
  const float scale2 = sh.scale * kLog2e;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) fetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint8_t* k_t = ring + (i % 2) * kStage;
    const uint8_t* v_t = k_t + BK * S;
    const int c0 = (first_kt + i) * BK;

    float s[NT][4] = {}, dp[NT][4] = {};
    if constexpr (kHeld) {
      product_nk<H, NT>(s, qf, k_t);
      product_nk<H, NT>(dp, dof, v_t);
    } else {
      product_nk<H, NT>(s, q_s, warp * 16, k_t);
      product_nk<H, NT>(dp, do_s, warp * 16, v_t);
    }
    const bool full = all_kept(sh, row0 + warp * 16, row0 + warp * 16 + 15, c0, c0 + BK - 1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool kept = full || keep(sh, row_lo + 8 * h, c0 + 8 * j + 2 * t + (e & 1));
        s[j][e] = grad_score(s[j][e], dp[j][e], lse2[h], dlt[h], scale2, kept);
      }
    }
    product_kn<H, NT>(dq_acc, s, k_t);
    __syncthreads();   // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    if (row < sh.rows_q) {
      const size_t base = (q_off + row) * H;
#pragma unroll
      for (int n = 0; n < H / 8; ++n)
        *reinterpret_cast<uint32_t*>(dq + base + 8 * n + 2 * t) =
            pack_bf16(dq_acc[n][2 * h] * sh.scale, dq_acc[n][2 * h + 1] * sh.scale);
    }
  }
}

// Does no (row, col) of [r0, r1] x [c0, c1] pass keep()? Then the tile
// leaves the forward's m, l and acc exactly as they were.
__device__ __forceinline__ bool none_kept(const Shape& sh, int r0, int r1, int c0, int c1) {
  if (r0 >= sh.rows_q || c0 >= sh.s_kv) return true;
  if (sh.causal && c0 > min(r1, sh.rows_q - 1) / sh.group) return true;
  if (sh.window > 0 && c1 <= r0 / sh.group - sh.window) return true;
  return false;
}

// The keys row `row` attends, as keep() decides: lo <= col <= hi (none when
// hi < lo). One division per row, where keep() divides at every call.
__device__ __forceinline__ void key_bounds(const Shape& sh, int row, int& lo, int& hi) {
  const int pos = row / sh.group;
  hi = row < sh.rows_q ? (sh.causal ? min(pos, sh.s_kv - 1) : sh.s_kv - 1) : -1;
  lo = sh.window > 0 ? pos - sh.window + 1 : 0;
}

template <int H, int BK>
constexpr size_t fwd_smem() {
  return kRows * Tile<H>::kStride + 2 * (2 * BK * Tile<H>::kStride);
}

// Forward: one block per (slab, 64-row q tile); warp w owns rows row0 + 16 w
// .. + 15, with Q held in registers as A fragments, and loops over the
// BK-key tiles its block's rows attend, K and V streamed through a 2-stage
// cp.async ring. S = Q K^T takes B from the K tile as it lies. The online
// softmax runs on the C fragments in log2 units: a row's columns lie in the
// 4 lanes t of one g, so two shuffles reduce its max; m is the running max
// of s * scale2 (scale2 = |scale| log2(e), one FFMA per score, Q negated
// for a negative scale), l each thread's share of the row sum of the
// unrounded fp32 p. p then goes to bf16 A fragments in registers for O +=
// P V, which takes B from the V tile through ldmatrix.trans. The mask is
// keep()'s, from each row's key bounds, and only on tiles that all_kept
// does not clear; tiles none of a warp's rows attend are skipped (they
// would change nothing). kMinBlocks: blocks an SM that the registers must
// leave room for.
template <int H, int BK, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, Shape sh) {
  constexpr int S = Tile<H>::kStride;
  constexpr int NT = BK / 8;
  constexpr int kStage = 2 * BK * S;
  constexpr float kLn2 = 0.6931471805599453f;
  // Causal sweeps are longest for the last q tiles: blocks take the tiles
  // from the last, every slab's at once, so the long sweeps start first.
  const int bn = gridDim.x / sh.tiles;
  const int slab = blockIdx.x % bn;
  const int tile = sh.causal ? sh.tiles - 1 - blockIdx.x / bn : blockIdx.x / bn;
  const int row0 = tile * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  extern __shared__ __align__(16) uint8_t smem_tc[];
  uint8_t* q_s = smem_tc;              // [64 rows][S]
  uint8_t* ring = q_s + kRows * S;     // 2 stages of k, v [BK][S]

  const size_t q_off = (size_t)slab * sh.rows_q;
  const __nv_bfloat16* k_slab = k + (size_t)slab * sh.s_kv * H;
  const __nv_bfloat16* v_slab = v + (size_t)slab * sh.s_kv * H;

  // The keys this block's rows attend: from its first position's window
  // start to its last position's causal frontier.
  const int last_row = min(row0 + kRows, sh.rows_q) - 1;
  const int last_col = sh.causal ? min(last_row / sh.group, sh.s_kv - 1) : sh.s_kv - 1;
  const int first_col = sh.window > 0 ? max(0, row0 / sh.group - (sh.window - 1)) : 0;
  const int first_kt = first_col / BK;
  const int n_tiles = last_col / BK - first_kt + 1;

  auto fetch = [&](int i) {
    uint8_t* st = ring + (i % 2) * kStage;
    const int c0 = (first_kt + i) * BK;
    load_tile<H>(st, k_slab, c0, BK, sh.s_kv);
    load_tile<H>(st + BK * S, v_slab, c0, BK, sh.s_kv);
  };
  load_tile<H>(q_s, q + q_off * H, row0, kRows, sh.rows_q);
  cp_async_commit();
  if (n_tiles > 0) fetch(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[H / 16][4];
  const uint32_t sign = sh.scale < 0.f ? 0x80008000u : 0u;
#pragma unroll
  for (int ks = 0; ks < H / 16; ++ks) {
    load_a<H>(qf[ks], q_s, warp * 16, ks * 16);
#pragma unroll
    for (int r = 0; r < 4; ++r) qf[ks][r] ^= sign;
  }
  const float scale2 = fabsf(sh.scale) * kLog2e;

  // Thread (g, t) holds rows r0 + g and r0 + g + 8 (h = 0, 1).
  const int r0 = row0 + warp * 16;
  int lo[2], hi[2];
  key_bounds(sh, r0 + g, lo[0], hi[0]);
  key_bounds(sh, r0 + g + 8, lo[1], hi[1]);
  float acc[H / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) fetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint8_t* k_t = ring + (i % 2) * kStage;
    const uint8_t* v_t = k_t + BK * S;
    const int c0 = (first_kt + i) * BK;
    if (!none_kept(sh, r0, r0 + 15, c0, c0 + BK - 1)) {
      float s[NT][4] = {};
      product_nk<H, NT>(s, qf, k_t);
      auto softmax = [&](auto masked) {
        auto kept = [&](int j, int e) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          return !decltype(masked)::value || (col >= lo[e >> 1] && col <= hi[e >> 1]);
        };
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!kept(j, e)) s[j][e] = kNegInf;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        float corr[2], neg_m[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h] * scale2);
          corr[h] = ex2(m[h] - m_new);
          m[h] = m_new;
          neg_m[h] = -m_new;
          l[h] *= corr[h];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[j][e], scale2, neg_m[e >> 1]));
            s[j][e] = kept(j, e) ? p : 0.f;
            l[e >> 1] += s[j][e];
          }
#pragma unroll
        for (int n = 0; n < H / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      };
      if (all_kept(sh, r0, r0 + 15, c0, c0 + BK - 1)) {
        softmax(std::false_type{});
      } else {
        softmax(std::true_type{});
      }
      product_kn<H, NT>(acc, s, v_t);
    }
    __syncthreads();   // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = r0 + g + 8 * h;
    if (row < sh.rows_q) {
      const float safe_l = sum == 0.f ? 1.f : sum;
      const size_t base = (q_off + row) * H;
#pragma unroll
      for (int n = 0; n < H / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + base + 8 * n + 2 * t) =
            pack_bf16(acc[n][2 * h] / safe_l, acc[n][2 * h + 1] / safe_l);
      // Natural-log units, as the CUDA-core forward and the JAX kernel (the
      // backward multiplies by log2(e) itself); a row that attends no key
      // gets -1e30, as there.
      if (t == 0) lse[q_off + row] = sum == 0.f ? kNegInf : m[h] * kLn2 + logf(sum);
    }
  }
}

}  // namespace tcb

// ---------------------------------------------------------------- launches

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

Shape make_shape(int rows, int rows_q, int s_kv, int group, int causal, int window,
                 float scale) {
  return Shape{rows_q, s_kv, group, causal, window, scale, (rows + kTile - 1) / kTile};
}

template <typename T, int H>
int fwd(const void* q, const void* k, const void* v, void* out, float* lse, int bn,
        Shape sh, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, H>;
  cudaError_t err = prepare(kernel, fwd_smem<H>());
  if (err != cudaSuccess) return (int)err;
  kernel<<<bn * sh.tiles, kThreads, fwd_smem<H>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sh);
  return (int)cudaGetLastError();
}

template <typename T, int H>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, void* dk, void* dv, int bn, Shape sh, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, H>;
  cudaError_t err = prepare(kernel, dkv_smem<H>());
  if (err != cudaSuccess) return (int)err;
  kernel<<<bn * sh.tiles, kThreads, dkv_smem<H>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return (int)cudaGetLastError();
}

template <typename T, int H>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* delta, void* dq_out, int bn, Shape sh, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, H>;
  cudaError_t err = prepare(kernel, dq_smem<H>());
  if (err != cudaSuccess) return (int)err;
  kernel<<<bn * sh.tiles, kThreads, dq_smem<H>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq_out), sh);
  return (int)cudaGetLastError();
}

// The tensor-core design (bf16). Its tiles keep H = 64 at or under 168
// registers a thread, so that three blocks of 128 threads share an SM
// (65,536 registers): dK/dV streams 32-row q tiles and reads K and V from
// shared memory (held in registers, as FlashAttention-2 holds them, they
// take it past 168); dQ streams 32-key tiles and holds Q and dO in
// registers. H = 128, whose accumulators alone take 128 (dK/dV) or 64 (dQ)
// registers, reads every operand from shared memory.
template <int H>
int dkv_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dk, void* dv, int bn, Shape sh, cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto kernel = tcb::flash_bwd_dkv_tc_kernel<H>;
  constexpr size_t smem = tcb::dkv_smem<H>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bn * sh.tiles, tcb::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return (int)cudaGetLastError();
}

template <int H, int BK, bool kHeld>
int dq_tc(const void* q, const void* k, const void* v, const void* dout, const float* lse,
          const float* delta, void* dq_out, int bn, Shape sh, cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto kernel = tcb::flash_bwd_dq_tc_kernel<H, BK, kHeld>;
  constexpr size_t smem = tcb::dq_smem<H, BK>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bn * sh.tiles, tcb::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq_out), sh);
  return (int)cudaGetLastError();
}

// The tensor-core forward holds Q in registers at both head dims. A scratch
// probe of the tiles on the card found the fastest: H = 64 with 64-key
// tiles at 127 registers, four blocks an SM; H = 128 with 32-key tiles at
// 168 registers, three.
template <int H, int BK, int kMinBlocks>
int fwd_tc(const void* q, const void* k, const void* v, void* out, float* lse, int bn,
           Shape sh, cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto kernel = tcb::flash_fwd_tc_kernel<H, BK, kMinBlocks>;
  constexpr size_t smem = tcb::fwd_smem<H, BK>();
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bn * sh.tiles, tcb::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; H: 64 or 128; window <= 0: none. Tensors
// are contiguous on the folded layout (q, out, dq, lse, delta over
// bn x rows_q rows; k, v, dk, dv over bn x s_kv rows). Each returns
// cudaGetLastError() after its launch, or -1 for a dtype or head_dim it does
// not take.
#define DISPATCH(CALL)                                           \
  cudaStream_t st = static_cast<cudaStream_t>(stream);           \
  if (dtype == 0 && H == 64) return CALL(float, 64);             \
  if (dtype == 0 && H == 128) return CALL(float, 128);           \
  if (dtype == 1 && H == 64) return CALL(__nv_bfloat16, 64);     \
  if (dtype == 1 && H == 128) return CALL(__nv_bfloat16, 128);   \
  return -1

extern "C" {

int flash_fwd_launch(const void* q, const void* k, const void* v, void* out, float* lse,
                     int dtype, int bn, int rows_q, int s_kv, int H, int group,
                     int causal, int window, float scale, void* stream) {
  const Shape sh = make_shape(rows_q, rows_q, s_kv, group, causal, window, scale);
#define CALL(T, HD) fwd<T, HD>(q, k, v, out, lse, bn, sh, st)
  DISPATCH(CALL);
#undef CALL
}

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv,
                         int dtype, int bn, int rows_q, int s_kv, int H, int group,
                         int causal, int window, float scale, void* stream) {
  const Shape sh = make_shape(s_kv, rows_q, s_kv, group, causal, window, scale);
#define CALL(T, HD) dkv<T, HD>(q, k, v, dout, lse, delta, dk, dv, bn, sh, st)
  DISPATCH(CALL);
#undef CALL
}

int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq_out, int dtype,
                        int bn, int rows_q, int s_kv, int H, int group, int causal,
                        int window, float scale, void* stream) {
  const Shape sh = make_shape(rows_q, rows_q, s_kv, group, causal, window, scale);
#define CALL(T, HD) dq<T, HD>(q, k, v, dout, lse, delta, dq_out, bn, sh, st)
  DISPATCH(CALL);
#undef CALL
}

// The tensor-core design of the forward and the two backward kernels: bf16
// only (dtype 1), H 64 or 128; -1 for anything else.
int flash_fwd_tc_launch(const void* q, const void* k, const void* v, void* out, float* lse,
                        int dtype, int bn, int rows_q, int s_kv, int H, int group,
                        int causal, int window, float scale, void* stream) {
  const Shape sh = make_shape(rows_q, rows_q, s_kv, group, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && H == 64) return fwd_tc<64, 64, 4>(q, k, v, out, lse, bn, sh, st);
  if (dtype == 1 && H == 128) return fwd_tc<128, 32, 3>(q, k, v, out, lse, bn, sh, st);
  return -1;
}

int flash_bwd_dkv_tc_launch(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv,
                            int dtype, int bn, int rows_q, int s_kv, int H, int group,
                            int causal, int window, float scale, void* stream) {
  const Shape sh = make_shape(s_kv, rows_q, s_kv, group, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && H == 64)
    return dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, bn, sh, st);
  if (dtype == 1 && H == 128)
    return dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, bn, sh, st);
  return -1;
}

int flash_bwd_dq_tc_launch(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq_out, int dtype,
                           int bn, int rows_q, int s_kv, int H, int group, int causal,
                           int window, float scale, void* stream) {
  const Shape sh = make_shape(rows_q, rows_q, s_kv, group, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && H == 64)
    return dq_tc<64, 32, true>(q, k, v, dout, lse, delta, dq_out, bn, sh, st);
  if (dtype == 1 && H == 128)
    return dq_tc<128, 64, false>(q, k, v, dout, lse, delta, dq_out, bn, sh, st);
  return -1;
}

}  // extern "C"
