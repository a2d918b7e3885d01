// Fused int4 dequant-matmul for Hopper (sm_90a), plain CUDA C++.
//
// Replaces three TPU kernels of learning_jax_sharding_tpu/ops/int4_matmul.py:
//   _kernel       (pallas_call in int4_matmul):   x @ dequant(q4, s), w4a16
//   _kernel3      (pallas_call in int4_matmul3):  the q/k/v triple, one launch
//   _kernel_w4a8  (pallas_call in int4_matmul):   int8 rows x int4 -> int32
// They compute what those kernels compute, on the split-half packed layout
// described in int4_common.cuh.
//
// w4a16 (int4_matmul_kernel<T, NW>): each dequantized weight (q - 8) * s is
// rounded to x's dtype T, products accumulate in fp32, the output is T. NW
// weights (1, or 3 for q/k/v) share one x: blockIdx.z picks the weight.
// w4a8 (int4_matmul_w4a8_kernel<T>): x arrives as per-row int8 (the wrapper's
// quantize_rows_int8) with fp32 row scales; each scale group's products are
// summed exactly in int32 (__dp4a over 4 contraction rows), converted to fp32,
// multiplied by the group scale, summed over the groups in order (low group g,
// then high group g), multiplied by the row scale and written in T.
//
// Design. A block owns 32 output columns and up to 8 rows of x, staged in
// shared memory. Its 256 threads are 8 column threads x 32 row slices: a
// thread reads one 32-bit word (4 neighbouring columns) of q4 per packed row,
// so 8 threads read 128 contiguous bytes of a row, and it walks the packed
// rows of its slice (int4_common.cuh, shared with int4_ff.cu). The TPU
// kernel's whole (K/2, block_n) tile in VMEM becomes 32 slices reduced in
// the block, by warp shuffles and then over the 8 warps in a fixed order
// (w4a8 reduces its int32 group partials, which is exact). Prefill tiles
// rows (8 per block) and masks a partial last tile.
//
// Bound on this card: at decode (8 rows) the packed weights and scales over
// 3.35 TB/s (0.31 MB for a 768 x 768 projection, 20.5 MB for the 125M
// lm_head); at prefill (1024 rows) the products, 2*M*K*N operations, over the
// bf16 (w4a16) or int8 (w4a8) tensor-core peak. What the simple design leaves
// for later: no tensor cores (the products run on the CUDA cores, fp32 FMA or
// dp4a), no TMA or cp.async pipelining, and every row tile re-reads and
// re-dequantizes its weights.

#include "int4_common.cuh"

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

}  // namespace

extern "C" {

// x @ dequant(q4_i, s_i) -> out_i for i < nw (1 or 3), all (K/2, N) weights of
// one layout; dtype 0 = fp32, 1 = bf16 (x and outputs). Returns
// cudaGetLastError() after the launch, or -1 for an unsupported dtype or nw.
int int4_matmul_launch(const void* x, const void* q0, const void* s0, void* o0,
                       const void* q1, const void* s1, void* o1, const void* q2,
                       const void* s2, void* o2, int dtype, int nw, int M, int K, int N,
                       int ng, int group, void* stream) {
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
  if (dtype == 0 && nw == 1) return launch_w4a16<float, 1>(x, w, M, K, N, ng, group, st);
  if (dtype == 0 && nw == 3) return launch_w4a16<float, 3>(x, w, M, K, N, ng, group, st);
  if (dtype == 1 && nw == 1) return launch_w4a16<__nv_bfloat16, 1>(x, w, M, K, N, ng, group, st);
  if (dtype == 1 && nw == 3) return launch_w4a16<__nv_bfloat16, 3>(x, w, M, K, N, ng, group, st);
  return -1;
}

// Per-row int8 xq (M, K) with fp32 row scales sx (M, 1) against q4/s ->
// out (M, N) in dtype (0 = fp32, 1 = bf16). K % 8 == 0, and a group (or K/2
// for one whole-K group) a multiple of 4 packed rows. Returns
// cudaGetLastError() after the launch, or -1 for an unsupported dtype.
int int4_matmul_w4a8_launch(const void* xq, const void* sx, const void* q4, const void* s,
                            void* out, int dtype, int M, int K, int N, int ng, int group,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* rs = static_cast<const float*>(sx);
  const uint8_t* q = static_cast<const uint8_t*>(q4);
  const float* sc = static_cast<const float*>(s);
  if (dtype == 0) return launch_w4a8<float>(x, rs, q, sc, out, M, K, N, ng, group, st);
  if (dtype == 1) return launch_w4a8<__nv_bfloat16>(x, rs, q, sc, out, M, K, N, ng, group, st);
  return -1;
}

}  // extern "C"
