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
// Design. The TPU kernels' sequential innermost grid axis and VMEM scratch
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
// Bound on this card at the 125M training shape (folded q (96, 1024, 64)
// bf16, causal: 524,800 (q, k) pairs per slab), from the H100 SXM data-sheet
// peaks (3.35 TB/s; 989 TFLOP/s dense bf16):
//   fwd      12.9 GFLOP (13.0 us) and 50.7 MB (15.1 us): 15.1 us, bytes;
//   dK/dV    25.8 GFLOP: 26.1 us, operations;
//   dQ       19.3 GFLOP: 19.6 us, operations.
// What the simple design leaves for later: it runs on the CUDA cores (no
// wgmma, so at most the 67 TFLOP/s of fp32 FMA), stages tiles with plain
// loads (no TMA, no cp.async double buffering), has no warp specialisation,
// and splits the work into 96 x 16 = 1536 blocks of 64 rows, whose causal
// loops differ in length by up to 16x.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

}  // extern "C"
