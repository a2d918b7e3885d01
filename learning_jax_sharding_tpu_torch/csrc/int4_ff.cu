// Whole-FF fused int4 for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel learning_jax_sharding_tpu/ops/int4_ff.py::_kernel
// (pallas_call in int4_ff). It computes what that kernel computes:
// out = gelu_tanh(x @ W1) @ W2 with both weights int4, split-half packed
// (q_up (K/2, H) with s_up (K/g or 1, H); q_dn (H/2, K) with s_dn (H/g or 1,
// K)). Up weights (q - 8) * s round to x's dtype T; the hidden activation u
// and the GELU stay fp32; down weights stay fp32; the down product sums in
// fp32; the output is T.
//
// Design. The TPU kernel walks the hidden dimension as a sequential grid axis
// and carries an fp32 accumulator across it in VMEM. Here blocks run in
// parallel and nothing carries between them, so:
//  - a block owns P packed rows of W2, p0 .. p0+P-1 (P a multiple of 16), and
//    up to 8 rows of x. Packed row p holds hidden unit p (low nibble) and
//    p + H/2 (high nibble): the block's 2P hidden units are exactly what its
//    W2 rows need, which replaces the TPU kernel's paired-block index maps
//    and scale rearrangement. Hidden unit h's down scale is s_dn[h / g_dn].
//  - it computes u for its 2P hidden units (the up projection of
//    int4_common.cuh, shared with int4_matmul.cu: 8 column threads x 32 row
//    slices over 32 hidden columns at a time, reduced in the block), applies
//    the GELU and keeps u in shared memory: u never goes to device memory,
//    which is the TPU kernel's point;
//  - it multiplies u by its W2 rows into an fp32 partial (rows, K) of the
//    output, written to a scratch buffer (one slab per block of hidden units);
//  - a second kernel sums the slabs in block order and writes T. The partials
//    are deterministic and the order is fixed: no atomics, and one run
//    repeats another bit for bit.
//
// Bound on this card: at decode (8 rows) the two packed weights and their
// scales over 3.35 TB/s (2.51 MB for the 125M FF, 768 -> 3072 -> 768); at
// prefill (1024 rows) its 4*M*K*H operations over the bf16 tensor-core peak.
// The fp32 partials (H/(2P) slabs of rows x K) add traffic that stays in the
// 50 MB L2 at these sizes. Left for later: tensor cores, TMA, and the
// partial round trip (a cluster's distributed shared memory could reduce it).

#include "int4_common.cuh"

namespace {

using namespace int4_common;

// jax.nn.gelu's default (tanh) form.
__device__ __forceinline__ float gelu_tanh(float v) {
  const float kSqrt2OverPi = 0.7978845608028654f;
  return 0.5f * v * (1.f + tanhf(kSqrt2OverPi * (v + 0.044715f * v * v * v)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) int4_ff_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ q_up, const float* __restrict__ s_up,
    const uint8_t* __restrict__ q_dn, const float* __restrict__ s_dn,
    float* __restrict__ partial, int M, int K, int H, int ng_up, int g_up, int ng_dn,
    int g_dn, int P, int tile_m) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                                      // tile_m x K
  float* u = reinterpret_cast<float*>(smem + align16((size_t)tile_m * K * sizeof(T)));
  float* red = u + kMaxTileM * 2 * P;                                      // kWarps x 8 x 32

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * tile_m;
  const int p0 = blockIdx.x * P;
  const int h_half = H / 2;
  stage_rows(xs, x, m0, M, K, tile_m);
  __syncthreads();

  // Up projection, 32 hidden columns at a time, as int4_matmul.cu computes a
  // column tile: local hidden l < P is unit p0 + l, l >= P is h_half + p0 + l - P.
  const int cg = tid % kColThreads, slice = tid / kColThreads;
  for (int chunk = 0; chunk < 2 * P; chunk += kTileN) {
    const int l0 = chunk + cg * 4;
    const int h0 = l0 < P ? p0 + l0 : h_half + p0 + (l0 - P);
    float acc[kMaxTileM][4];
    zero(acc);
    w4a16_accumulate<T>(acc, xs, q_up, s_up, H, h0, K, ng_up, g_up, tile_m, slice);
    store_warp_sums(acc, red);
    __syncthreads();
    if (tid < tile_m * kTileN) {
      const int m = tid / kTileN, c = tid % kTileN;
      u[m * 2 * P + chunk + c] = gelu_tanh(warp_sum(red, m, c));
    }
    __syncthreads();   // u complete; red is rewritten by the next chunk
  }

  // Down projection of the block's P packed rows: thread t owns output
  // columns 4t .. 4t+3 (then 4(t + 256) ...), all tile rows.
  float* slab = partial + (size_t)blockIdx.x * M * K;
  for (int k0 = tid * 4; k0 < K; k0 += kThreads * 4) {
    float acc[kMaxTileM][4];
    zero(acc);
    for (int pl = 0; pl < P; ++pl) {
      const int p = p0 + pl;
      const uint32_t word = *reinterpret_cast<const uint32_t*>(q_dn + (size_t)p * K + k0);
      const int g_lo = ng_dn == 1 ? 0 : p / g_dn;
      const int g_hi = ng_dn == 1 ? 0 : (p + h_half) / g_dn;
      const float4 s_lo = *reinterpret_cast<const float4*>(s_dn + (size_t)g_lo * K + k0);
      const float4 s_hi = *reinterpret_cast<const float4*>(s_dn + (size_t)g_hi * K + k0);
      const float sl[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
      const float sh[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
      float wl[4], wh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int byte = (word >> (8 * j)) & 0xFF;
        wl[j] = __fmul_rn((float)((byte & 0xF) - 8), sl[j]);
        wh[j] = __fmul_rn((float)((byte >> 4) - 8), sh[j]);
      }
#pragma unroll
      for (int m = 0; m < kMaxTileM; ++m) {
        if (m < tile_m) {
          const float ul = u[m * 2 * P + pl];
          const float uh = u[m * 2 * P + P + pl];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[m][j] = fmaf(ul, wl[j], acc[m][j]);
            acc[m][j] = fmaf(uh, wh[j], acc[m][j]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxTileM; ++m) {
      if (m < tile_m && m0 + m < M) {
        const float4 v = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        *reinterpret_cast<float4*>(slab + (size_t)(m0 + m) * K + k0) = v;
      }
    }
  }
}

// out[i] = sum over slabs b = 0 .. nslab-1 of partial[b][i], in that order.
template <typename T>
__global__ void __launch_bounds__(kThreads) int4_ff_reduce_kernel(
    const float* __restrict__ partial, T* __restrict__ out, int nslab, size_t MK) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= MK) return;
  float v = 0.f;
  for (int b = 0; b < nslab; ++b) v += partial[(size_t)b * MK + i];
  out[i] = Num<T>::store(v);
}

template <typename T>
int launch(const void* x, const uint8_t* q_up, const float* s_up, const uint8_t* q_dn,
           const float* s_dn, float* partial, void* out, int M, int K, int H, int ng_up,
           int g_up, int ng_dn, int g_dn, int P, cudaStream_t stream) {
  if (M == 0) return (int)cudaSuccess;
  if (P % 16 || (H / 2) % P || K % 4) return -1;
  const int tile_m = M < kMaxTileM ? M : kMaxTileM;
  const size_t smem = ((size_t)tile_m * K * sizeof(T) + 15) / 16 * 16 +
                      (size_t)kMaxTileM * 2 * P * sizeof(float) +
                      (size_t)kWarps * kMaxTileM * kTileN * sizeof(float);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = int4_ff_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nslab = H / 2 / P;
  const dim3 grid(nslab, (M + tile_m - 1) / tile_m);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), q_up, s_up, q_dn, s_dn,
                                           partial, M, K, H, ng_up, g_up, ng_dn, g_dn, P,
                                           tile_m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t mk = (size_t)M * K;
  int4_ff_reduce_kernel<T><<<(unsigned)((mk + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      partial, static_cast<T*>(out), nslab, mk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gelu_tanh(x @ dequant(q_up, s_up)) @ dequant(q_dn, s_dn) -> out (M, K),
// dtype 0 = fp32, 1 = bf16 (x and out). partial is fp32 scratch of
// (H/2/P, M, K); P packed down rows per block, a multiple of 16 dividing H/2;
// K a multiple of 4. g_up / g_dn are the groups (min(group, K) / min(group,
// H)), ng_up / ng_dn the scale rows. Returns cudaGetLastError() after the
// launches, or -1 for an unsupported dtype or tiling.
int int4_ff_launch(const void* x, const void* q_up, const void* s_up, const void* q_dn,
                   const void* s_dn, void* partial, void* out, int dtype, int M, int K, int H,
                   int ng_up, int g_up, int ng_dn, int g_dn, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* qu = static_cast<const uint8_t*>(q_up);
  const uint8_t* qd = static_cast<const uint8_t*>(q_dn);
  const float* su = static_cast<const float*>(s_up);
  const float* sd = static_cast<const float*>(s_dn);
  float* part = static_cast<float*>(partial);
  if (dtype == 0)
    return launch<float>(x, qu, su, qd, sd, part, out, M, K, H, ng_up, g_up, ng_dn, g_dn, P, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, qu, su, qd, sd, part, out, M, K, H, ng_up, g_up, ng_dn,
                                 g_dn, P, st);
  return -1;
}

}  // extern "C"
