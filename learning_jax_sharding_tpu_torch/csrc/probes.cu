// The probe kernels for Hopper (sm_90a), plain CUDA C++: a one-block copy, a
// one-call matmul at decode rows, and the flash block's ablation.
//
// Replace the six Pallas launch sites of the TPU's probe scripts, three
// kernel bodies:
//
//   probe_copy_kernel     scripts/perf_call_floor.py copy_kernel (:26; the
//                         launches `noop` :31) and scripts/perf_launch_audit.py
//                         copy_kernel (:155; `noop` :160): an (8, 128) bf16
//                         copy in one small block, the price of a launch with
//                         no work. Bound: 4 KB of bytes, about a nanosecond;
//                         its time is the launch.
//   probe_matmul_kernel   scripts/perf_call_floor.py mm_kernel (:49; the
//                         launches `pmm` :56 and `four_calls` :77):
//                         x (M <= 8, K) @ w (K, N) bf16, fp32 sums, bf16 out.
//                         w and out are read and written with leading
//                         dimensions, so four calls on column slices of one w
//                         write column slices of one output with no copy.
//                         Bound at (8, 2048) x (2048, 8192): 33.7 MB of bytes,
//                         10.1 us at 3.35 TB/s; the 268 MFLOP take 0.27 us.
//   probe_ablate_kernel   scripts/perf_flash_ceiling.py _ablate_kernel (:116;
//                         launched :147) and scripts/perf_flash_ceiling2.py
//                         _ablate_kernel (:115; :146): per block of `block`
//                         rows, s = q k^T in fp32 with no scale; "full"
//                         p = softmax(s), "noexp" p = (s - m) / sum(s - m),
//                         "dots" p = s; then out = bf16(p) @ v in fp32, written
//                         in bf16. Bound at 16 blocks of 1024: the products,
//                         2 * 1024 * 1024 * h * 2 FLOP a block, 0.27 us (h =
//                         64) and 0.54 us (h = 128) at 989 TFLOP/s; the bytes
//                         (q, k, v, out) take 0.16 / 0.31 us.
//
// The TPU kernels are probes, not parts of the model: what matters is that
// each measures on this card what its TPU kernel measured there.
//
// probe_matmul_kernel<BN>: small-M design on mma.sync with the operands
// swapped (as int4_matmul's small-M design): a block owns BN (16 or 32)
// output columns, and its 8 warps split K into 8 pieces; w^T is A (16
// columns x 16 of depth, from shared memory through ldmatrix.trans), x^T is
// B (16 of depth x 8 rows, one 32-bit load of two neighbouring x values a
// register, read in place through the L1). Each warp streams its piece of w
// through its own 4-stage cp.async ring (32 rows a stage, rows padded by 16
// bytes so that ldmatrix is conflict-free), so a warp waits only on its own
// copies. The 8 partials meet in shared memory and are added in warp order:
// the result does not depend on timing. The wrapper picks BN so that the
// grid covers the SMs: 32 columns at N = 8192 (256 blocks, 88 KB each, two
// an SM), 16 at N = 2048 (128 blocks).
//
// probe_ablate_kernel<H, BK, min_blocks, mode>: the loop of the bf16 flash
// forward (flash_attention.cu, flash_fwd_tc_kernel: the same tile sizes,
// blocks an SM, mma.sync fragments, 2-stage cp.async ring of K and V
// tiles, Q held in registers, p rounded to bf16 A fragments in registers),
// with no mask: a block of 64 q rows sweeps the `block` keys of its
// ablation block in BK-key tiles. The mode is a template argument, so that
// each mode compiles to the flash loop minus what it knocks out:
//   full   the forward's online softmax at scale 1 (running max in log2
//          units, ex2, the accumulator rescaled by the max's correction),
//          out = acc / l: the flash forward's arithmetic exactly;
//   noexp  no exponential and no rescale: a row's max is still reduced
//          every tile, p = s - c with c the row's max over the first tile,
//          l = sum(p); at the end the moving max is corrected additively,
//          sum((s - m) v) = sum((s - c) v) - (m - c) sum(v), with sum(v)
//          over the block's keys from probe_colsum_kernel, a launch of its
//          own before it (timed apart: it is no part of the flash loop);
//   dots   no softmax at all: the two products and the loads.
// Their differences split the block's time between the softmax's parts and
// the products without a profiler. p is rounded to bf16 before the
// division (full, noexp), where the TPU kernel divides first:
// ops/probes.py::ablate_probe_online_reference computes this kernel's order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace tc_prims;
using namespace tc_tiles;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- copy

// Thread i copies 16-byte chunks i, i + stride, ...: one block of 128
// threads takes the (8, 128) probe in one pass.
__global__ void probe_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                                  int chunks) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < chunks; i += gridDim.x * blockDim.x)
    out[i] = x[i];
}

// ---------------------------------------------------------------- matmul

namespace mm {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;     // rows of w a stage
constexpr int kStages = 4;
constexpr int kRows = 8;       // rows of x: the mma's n

template <int BN>
struct Cfg {
  static constexpr int kStride = BN * 2 + 16;             // bytes a staged row of w
  static constexpr int kStageBytes = kChunk * kStride;
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kRingBytes = kWarps * kWarpBytes;
  static constexpr int kSmem = kRingBytes + kWarps * BN * kRows * (int)sizeof(float);
};

__device__ __forceinline__ uint32_t ldg_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// out (M, N; row stride ldo) = x (M, K; contiguous) @ w (K, N; row stride
// ldw). Block b owns columns [b * BN, b * BN + BN); warp w the rows
// [w * K / 8, (w + 1) * K / 8) of w.
template <int BN>
__global__ void __launch_bounds__(kThreads) probe_matmul_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out, int M,
    int K, int N, int ldw, int ldo) {
  using C = Cfg<BN>;
  constexpr int kPieces = kChunk * BN / 8;   // 16-byte copies a stage
  extern __shared__ __align__(16) uint8_t smem_mm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * BN;
  const int piece = K / kWarps, k_begin = warp * piece, chunks = piece / kChunk;
  uint8_t* ring = smem_mm + warp * C::kWarpBytes;

  auto fetch = [&](int c) {
    uint8_t* st = ring + (c % kStages) * C::kStageBytes;
    const bf16* src = w + (size_t)(k_begin + c * kChunk) * ldw + n0;
    for (int i = lane; i < kPieces; i += 32) {
      const int r = i / (BN / 8), col = (i % (BN / 8)) * 8;
      const bool in = n0 + col < N;
      cp_async16(st + r * C::kStride + col * 2, src + (size_t)r * ldw + (in ? col : 0),
                 in ? 16 : 0);
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) fetch(c);
    cp_async_commit();
  }

  const bool row_in = g < M;
  const bf16* xr = x + (size_t)(row_in ? g : 0) * K;
  float acc[BN / 16][4] = {};
  for (int c = 0; c < chunks; ++c) {
    if (c + kStages - 1 < chunks) fetch(c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint8_t* st = ring + (c % kStages) * C::kStageBytes;
    const int k0 = k_begin + c * kChunk;
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      // B = x^T: b0 holds x[g][k 2t, 2t + 1], b1 x[g][k 8 + 2t, 9 + 2t].
      const uint32_t b0 = row_in ? ldg_pair(xr + k0 + ks * 16 + 2 * t) : 0u;
      const uint32_t b1 = row_in ? ldg_pair(xr + k0 + ks * 16 + 8 + 2 * t) : 0u;
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        // A = w^T (16 columns x 16 of depth): matrix i of the x4 load holds
        // depth rows (i / 2) * 8 .. + 7 and columns (i % 2) * 8 .. + 7,
        // transposed so that lane (g, t) gets column g at depths 2t, 2t + 1.
        const int i = lane / 8;
        uint32_t a[4];
        ldmatrix_x4_trans(a, st + (ks * 16 + (i / 2) * 8 + lane % 8) * C::kStride +
                                 (j * 16 + (i % 2) * 8) * 2);
        mma_bf16(acc[j], a, b0, b1);
      }
    }
    __syncwarp();   // every lane is done with this stage before it is refilled
  }

  // C fragments: acc[j][e] is column n0 + 16 j + g + 8 (e / 2), row 2t + e % 2.
  float* part = reinterpret_cast<float*>(smem_mm + C::kRingBytes);   // [warp][BN][8]
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(warp * BN + 16 * j + g + 8 * (e / 2)) * kRows + 2 * t + e % 2] = acc[j][e];
  __syncthreads();
  for (int i = threadIdx.x; i < BN * kRows; i += kThreads) {
    const int col = i % BN, row = i / BN;
    if (row >= M || n0 + col >= N) continue;
    float sum = part[col * kRows + row];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) sum += part[(v * BN + col) * kRows + row];
    out[(size_t)row * ldo + n0 + col] = __float2bfloat16(sum);
  }
}

}  // namespace mm

// ---------------------------------------------------------------- ablation

namespace ab {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // q rows a block
constexpr float kLog2e = 1.4426950408889634f;
enum Mode { kFull = 0, kNoExp = 1, kDots = 2 };

// cp.async of n whole rows of a (rows, H) bf16 slab into a padded tile.
template <int H>
__device__ __forceinline__ void load_rows(uint8_t* dst, const bf16* src, int n) {
  for (int i = threadIdx.x; i < n * Tile<H>::kChunks; i += kThreads) {
    const int r = i / Tile<H>::kChunks, c = i % Tile<H>::kChunks;
    cp_async16(dst + r * Tile<H>::kStride + c * 16, src + (size_t)r * H + c * 8, 16);
  }
}

template <int H, int BK>
constexpr size_t smem_bytes() {
  return kRows * Tile<H>::kStride + 2 * (2 * BK * Tile<H>::kStride);
}

// One block per 64 q rows of an ablation block; warp w owns rows row0 +
// 16 w .. + 15 and sweeps the block's `block` keys. vsum: the block's
// column sums of v (noexp only).
template <int H, int BK, int kMinBlocks, int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks) probe_ablate_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ vsum, bf16* __restrict__ out, int block) {
  constexpr int S = Tile<H>::kStride;
  constexpr int NT = BK / 8;
  constexpr int kStage = 2 * BK * S;
  const int q_tiles = block / kRows;
  const int blk = blockIdx.x / q_tiles, row0 = (blockIdx.x % q_tiles) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  extern __shared__ __align__(16) uint8_t smem_ab[];
  uint8_t* q_s = smem_ab;              // [64 rows][S]
  uint8_t* ring = q_s + kRows * S;     // 2 stages of k, v [BK][S]
  const bf16* k_blk = k + (size_t)blk * block * H;
  const bf16* v_blk = v + (size_t)blk * block * H;
  const int n_tiles = block / BK;

  auto fetch = [&](int i) {
    uint8_t* st = ring + (i % 2) * kStage;
    load_rows<H>(st, k_blk + (size_t)i * BK * H, BK);
    load_rows<H>(st + BK * S, v_blk + (size_t)i * BK * H, BK);
  };
  load_rows<H>(q_s, q + ((size_t)blk * block + row0) * H, kRows);
  cp_async_commit();
  fetch(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[H / 16][4];
#pragma unroll
  for (int ks = 0; ks < H / 16; ++ks) load_a<H>(qf[ks], q_s, warp * 16, ks * 16);

  // Thread (g, t) holds rows r0 + g and r0 + g + 8 (h = 0, 1).
  float acc[H / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) fetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint8_t* k_t = ring + (i % 2) * kStage;
    const uint8_t* v_t = k_t + BK * S;
    float s[NT][4] = {};
    product_nk<H, NT>(s, qf, k_t);
    if constexpr (kMode != kDots) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
      if constexpr (kMode == kFull) {
        float corr[2], neg_m[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m_new = fmaxf(m[h], mx[h] * kLog2e);
          corr[h] = ex2(m[h] - m_new);
          m[h] = m_new;
          neg_m[h] = -m_new;
          l[h] *= corr[h];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = ex2(fmaf(s[j][e], kLog2e, neg_m[e >> 1]));
            l[e >> 1] += s[j][e];
          }
#pragma unroll
        for (int n = 0; n < H / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (i == 0) c[h] = mx[h];
          m[h] = fmaxf(m[h], mx[h]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] -= c[e >> 1];
            l[e >> 1] += s[j][e];
          }
      }
    }
    product_kn<H, NT>(acc, s, v_t);
    __syncthreads();   // this stage's readers are done before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + warp * 16 + g + 8 * h;
    const size_t base = ((size_t)blk * block + row) * H;
    const float dm = m[h] - c[h];
    const float denom = kMode == kFull ? sum : sum - (float)block * dm;
#pragma unroll
    for (int n = 0; n < H / 8; ++n) {
      const int col = 8 * n + 2 * t;
      float o0 = acc[n][2 * h], o1 = acc[n][2 * h + 1];
      if constexpr (kMode == kNoExp) {
        o0 -= dm * vsum[(size_t)blk * H + col];
        o1 -= dm * vsum[(size_t)blk * H + col + 1];
      }
      if constexpr (kMode != kDots) {
        o0 /= denom;
        o1 /= denom;
      }
      *reinterpret_cast<uint32_t*>(out + base + col) = pack_bf16(o0, o1);
    }
  }
}

// vsum (blocks, H) fp32: column sums of v over each block's `block` rows.
// Grid (blocks, H / 64) of 256 threads: 32 column pairs x 8 row groups, the
// groups' sums added in order.
__global__ void __launch_bounds__(256) probe_colsum_kernel(const bf16* __restrict__ v,
                                                           float* __restrict__ vsum, int block,
                                                           int H) {
  __shared__ float2 part[8][32];
  const int lane = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int pair = blockIdx.y * 32 + lane;
  const __nv_bfloat162* src =
      reinterpret_cast<const __nv_bfloat162*>(v + (size_t)blockIdx.x * block * H) + pair;
  float2 sum = make_float2(0.f, 0.f);
#pragma unroll 8
  for (int r = grp; r < block; r += 8) {
    const float2 f = __bfloat1622float2(src[(size_t)r * (H / 2)]);
    sum.x += f.x;
    sum.y += f.y;
  }
  part[grp][lane] = sum;
  __syncthreads();
  if (grp == 0) {
    float2 total = part[0][lane];
    for (int i = 1; i < 8; ++i) {
      total.x += part[i][lane].x;
      total.y += part[i][lane].y;
    }
    vsum[(size_t)blockIdx.x * H + 2 * pair] = total.x;
    vsum[(size_t)blockIdx.x * H + 2 * pair + 1] = total.y;
  }
}

}  // namespace ab

// ---------------------------------------------------------------- launches

// The dynamic shared memory a kernel takes past 48 KB. Each launch
// function below calls it once, into a function-local static of its own
// instantiation: no attribute call happens while a CUDA graph captures the
// launches (the floor's graph measurement).
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int BN>
int launch_matmul(const void* x, const void* w, void* out, int M, int K, int N, int ldw, int ldo,
                  cudaStream_t stream) {
  auto kernel = mm::probe_matmul_kernel<BN>;
  constexpr size_t smem = mm::Cfg<BN>::kSmem;
  static const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(N + BN - 1) / BN, mm::kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), M, K,
      N, ldw, ldo);
  return (int)cudaGetLastError();
}

// The flash forward's tiles: H = 64 with 64-key tiles at four blocks an
// SM, H = 128 with 32-key tiles at three (flash_attention.cu, fwd_tc).
template <int H, int BK, int kMinBlocks, int kMode>
int launch_ablate(const void* q, const void* k, const void* v, const float* vsum, void* out,
                  int blocks, int block, cudaStream_t stream) {
  auto kernel = ab::probe_ablate_kernel<H, BK, kMinBlocks, kMode>;
  constexpr size_t smem = ab::smem_bytes<H, BK>();
  static const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks * (block / ab::kRows), ab::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      vsum, static_cast<bf16*>(out), block);
  return (int)cudaGetLastError();
}

template <int kMode>
int dispatch_ablate(const void* q, const void* k, const void* v, const float* vsum, void* out,
                    int blocks, int block, int H, cudaStream_t stream) {
  if (H == 64 && block % 64 == 0)
    return launch_ablate<64, 64, 4, kMode>(q, k, v, vsum, out, blocks, block, stream);
  if (H == 128 && block % 64 == 0)
    return launch_ablate<128, 32, 3, kMode>(q, k, v, vsum, out, blocks, block, stream);
  return -1;
}

}  // namespace

extern "C" {

// x, out: `chunks` 16-byte chunks, 16-byte aligned.
int probe_copy_launch(const void* x, void* out, int chunks, void* stream) {
  if (chunks <= 0) return chunks == 0 ? 0 : -1;
  const int threads = 128;
  int blocks = (chunks + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  probe_copy_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), chunks);
  return (int)cudaGetLastError();
}

// x (M, K) contiguous, 4-byte aligned; w (K, N) with row stride ldw and out
// (M, N) with row stride ldo, in elements; 1 <= M <= 8, K a multiple of
// 256, N and ldw multiples of 8, w 16-byte aligned; bn 16 or 32 (columns a
// block). -1 for anything else.
int probe_matmul_launch(const void* x, const void* w, void* out, int M, int K, int N, int ldw,
                        int ldo, int bn, void* stream) {
  if (M < 1 || M > mm::kRows || K % (mm::kWarps * mm::kChunk) || N % 8 || ldw % 8 ||
      ldw < N || ldo < N || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 4)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 32) return launch_matmul<32>(x, w, out, M, K, N, ldw, ldo, st);
  if (bn == 16) return launch_matmul<16>(x, w, out, M, K, N, ldw, ldo, st);
  return -1;
}

// q, k, v, out: (blocks * block, H) bf16 contiguous, 16-byte aligned; H 64
// or 128, block a multiple of 64; mode 0 full, 1 noexp, 2 dots. noexp reads
// vsum ((blocks, H) fp32, from probe_colsum_launch); the other modes do not.
int probe_ablate_launch(const void* q, const void* k, const void* v, const float* vsum,
                        void* out, int blocks, int block, int H, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || block < 64 || (H != 64 && H != 128)) return -1;
  if (mode == ab::kFull) return dispatch_ablate<ab::kFull>(q, k, v, vsum, out, blocks, block, H, st);
  if (mode == ab::kNoExp)
    return dispatch_ablate<ab::kNoExp>(q, k, v, vsum, out, blocks, block, H, st);
  if (mode == ab::kDots) return dispatch_ablate<ab::kDots>(q, k, v, vsum, out, blocks, block, H, st);
  return -1;
}

// vsum (blocks, H) fp32 = the column sums of v ((blocks * block, H) bf16)
// over each block's rows; H 64 or 128.
int probe_colsum_launch(const void* v, float* vsum, int blocks, int block, int H, void* stream) {
  if (blocks < 1 || block < 1 || (H != 64 && H != 128)) return -1;
  ab::probe_colsum_kernel<<<dim3(blocks, H / 64), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(v), vsum, block, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
