// Whole-FF fused int4 for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel learning_jax_sharding_tpu/ops/int4_ff.py::_kernel
// (pallas_call in int4_ff). It computes what that kernel computes:
// out = gelu_tanh(x @ W1) @ W2 with both weights int4, split-half packed
// (q_up (K/2, H) with s_up (K/g or 1, H); q_dn (H/2, K) with s_dn (H/g or 1,
// K)). Up weights (q - 8) * s round to x's dtype T; the hidden activation u
// and the GELU (tanhf) stay fp32; down weights stay fp32, not rounded; the
// down product sums in fp32; the output is T. Packed down row p holds hidden
// unit p (low nibble) and p + H/2 (high); hidden unit h's down scale is
// s_dn[h / g_dn] (one row for a whole-H group).
//
// Three designs; ops/int4_ff.py::_design picks one by shape before the
// launch, and none gives way to another.
//
// The down product on the tensor cores, exact in fp32. The down weight is
// (q - 8) * s_dn[g(h), k], and q - 8 in [-8, 7] is exact in bf16, so the
// tensor cores take the integer as one operand. u is cut into three bf16
// parts, u = u1 + u2 + u3 exactly (each the bf16 rounding of what the parts
// before it leave: 8 + 8 + 8 bits carry fp32's 24), so every product
// ui * (q - 8) is exact and sums in an fp32 accumulator. Each scale group's
// sum stays in its own fragment (the low-nibble half's group and the high
// half's apart) until the group ends; then it is multiplied by s_dn[g, k]
// and added into the total, the low group before the high one. Three MMAs
// per tile of the down product where one bf16 product would be inexact.
//
// Design "small_m" (int4_ff_small_m_kernel<R>; bf16 x, up to 8R <= 16 rows:
// the token steps). A block owns kPairs = 16 packed down rows, so the 32
// hidden units its down rows need, and one warp per 32-row chunk of K/2.
// Up: the swapped-operand fragments of int4_matmul.cu's design 3 (A =
// dequantized W1^T built in registers from one 32-bit word of q4 a packed
// row, B = x's rows read in place); the warps' fp32 partials meet in shared
// memory in warp order, go through the GELU and are cut into u's three
// parts (shared memory, [part][row][unit]). The up product's C fragment
// (hidden units x rows) is not the down product's B layout (hidden units as
// depth x rows), hence that exchange through shared memory. Down: A = the
// integer nibbles of W2^T, built in registers from words of q_dn loaded
// before the up product starts, B = u's parts; a warp a 32-column tile of
// the output, the block's fp32 partial (rows x K) to shared memory. The
// cross-block sum stays in the launch: the blocks form clusters of up to 8,
// rank j of a cluster adds the partials of columns [jK/C, (j+1)K/C) over
// the cluster's blocks through distributed shared memory in rank order and
// writes that sum to a workspace (clusters x rows x K fp32: 295 KB at
// decode for the 125M FF instead of 2.36 MB of partial slabs); the last
// cluster to finish a slice, found by an integer counter a slice, adds the
// clusters' sums in cluster order and writes T. No float atomics: one
// launch repeats another bit for bit. Bound at decode (8 rows): the packed
// weights and scales, 2.51 MB for the 125M FF (768 -> 3072 -> 768), over
// 3.35 TB/s.
//
// Design "tensor_core" (int4_ff_up_tc_kernel<BM>, int4_ff_down_tc_kernel;
// bf16 x, the prefill and refill rows). Two launches. Up: int4_matmul.cu's
// design 2 tile product (w4a16_tile: 128- or 96-row tiles, a 3-stage
// cp.async ring, each W1 tile dequantized once a block, so each weight is
// read M/BM times) with an epilogue that applies the GELU and writes u's
// three parts, (M, H/32, 3, 32) bf16: 6 bytes a hidden unit, 18.9 MB at
// M = 1024 (12.6 MB in fp32; the split is made once a unit, not once per
// output tile, and fits in the 50 MB L2). Down: a 4-stage ring over packed
// rows of W2 (32 a stage) with the three parts of u beside each as one
// 192-byte row a 32-unit chunk, W2's tile turned into exact integer bf16
// tiles once a block; 32 rows x 128 columns a block, two blocks an SM; the
// scale groups cut into pieces of whole groups where the grid would leave
// SMs idle, the pieces' fp32 totals added in piece order by the last piece
// of a tile (ops/int4_ff.py::_down_splits). Bound at prefill: the products,
// 4*M*K*H operations, over the bf16 tensor-core peak (989 TFLOP/s); the
// design's own floor, with three MMAs a down tile, (2 + 6)*M*K*H
// operations.
//
// Design "cuda_core" (int4_ff_kernel<T> + int4_ff_reduce_kernel<T>; fp32 x
// and the layouts neither other design takes): a block owns P packed W2 rows
// and up to 8 rows of x, computes u for its 2P hidden units on the CUDA
// cores (int4_common.cuh's up chunk), keeps it in shared memory, multiplies
// it by its W2 rows into an fp32 partial (one slab a block in a scratch
// buffer) that a second kernel sums in block order.
//
// Left for later: wgmma and TMA in place of mma.sync and cp.async; a
// persistent prefill grid; the tensor-core design in one launch with u kept
// on chip (a block then needs all of K's outputs for its rows: registers
// and shared memory allow 32 rows, too few blocks at these sizes).

#include <cooperative_groups.h>

#include "int4_common.cuh"

namespace {

using namespace int4_common;
namespace cg = cooperative_groups;

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


// ---------------------------------------------------------------------------
// What the tensor-core designs share: u's three parts and the integer down
// operand.

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a = p[0] + p[1] + p[2] exactly, each part the bf16 rounding of what the
// parts before it leave (each difference is exact in fp32); the same for b,
// packed beside a in the high halves.
__device__ __forceinline__ void split3(float a, float b, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    p[i] = bits(h);
    a = __fsub_rn(a, __low2float(h));
    b = __fsub_rn(b, __high2float(h));
  }
}

// The bf16 pair (v0 - 8, v1 - 8), exact, of nibbles v0 in bits 0-3 and v1 in
// bits 16-19 of m (every other bit zero): 0x4300 | v is bf16 128 + v.
__device__ __forceinline__ uint32_t centered_pair(uint32_t m) {
  const uint32_t biased = m | 0x43004300u;
  const uint32_t k136 = 0x43084308u;
  return bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                      *reinterpret_cast<const __nv_bfloat162*>(&k136)));
}

// ---------------------------------------------------------------------------
// Design "small_m".

namespace ffsm {

constexpr int kPairs = 16;         // packed down rows a block
constexpr int kUnits = 2 * kPairs; // hidden units a block: the up product's 32 columns
constexpr int kUStride = 40;       // bf16 a row of a part of u (80 bytes: B reads conflict-free)
constexpr int kMaxWarps = 16;      // warps a block: one a 32-row chunk of K/2, at most this
constexpr int kMaxCluster = 8;     // blocks a cluster (the portable limit)
constexpr int kHeld = 2;           // output column tiles a warp holds W2 words of at once

// The shared memory of a block of `warps` warps and `rows` rows of x: the
// up partials ([warp][row][unit] fp32), later the down partial ([row][K + 4]
// fp32, padded so the float4 stores of a warp's lanes hit distinct banks),
// then u's parts ([part][row][kUStride] bf16).
__host__ __device__ __forceinline__ size_t partial_bytes(int warps, int rows, int K) {
  const size_t up = (size_t)warps * rows * kUnits * sizeof(float);
  const size_t down = (size_t)rows * (K + 4) * sizeof(float);
  return up > down ? up : down;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int warps, int rows, int K) {
  return partial_bytes(warps, rows, K) + 3 * (size_t)rows * kUStride * sizeof(__nv_bfloat16);
}

// A warp's W2 words and down scales for one 32-column output tile: lane
// (g, t) holds packed rows p0 + 2t, 2t + 1, 8 + 2t, 9 + 2t at its 4 columns
// ct * 32 + 4g .. + 3, and those columns' scales of the block's low and high
// groups.
struct DownTile {
  uint32_t w[4];
  float sl[sm::kLaneCols], sh[sm::kLaneCols];
};

}  // namespace ffsm

// Lane (g, t) of a warp. Up: its 4 hidden columns are units p0 + 4g .. + 3
// (g < 4) or H/2 + p0 + 4(g - 4) .. (g >= 4), the block's local units 4g ..
// 4g + 3 (0 .. 15 low, 16 .. 31 high); its C fragment holds units 4g + 2nt
// (c0, c1) and 4g + 2nt + 1 (c2, c3) of x rows 2t (c0, c2) and 2t + 1 (c1,
// c3). Down, column tile ct: A rows g and g + 8 of MMA tile nt are output
// columns ct*32 + 4g + 2nt and + 1; depth slots 2t, 2t + 1, 8 + 2t, 9 + 2t
// are packed rows p0 + 2t, ... (their low nibbles in the low step, high
// nibbles in the high step), so B's slots are u's local units 2t, 2t + 1,
// 8 + 2t, 9 + 2t (low step) or 16 + those (high step) of x row g.
template <int R>
__global__ void __launch_bounds__(32 * ffsm::kMaxWarps) int4_ff_small_m_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q_up,
    const float* __restrict__ s_up, const uint8_t* __restrict__ q_dn,
    const float* __restrict__ s_dn, float* __restrict__ ws, int* __restrict__ counters,
    __nv_bfloat16* __restrict__ out, int M, int K, int H, int ng_up, int g_up, int ng_dn,
    int g_dn) {
  using namespace ffsm;
  using namespace tc_prims;
  constexpr int kRowsX = 8 * R;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k_half = K / 2, h_half = H / 2, ks = K + 4;
  float* red = reinterpret_cast<float*>(smem);   // up partials, then the down partial
  __nv_bfloat16* us =
      reinterpret_cast<__nv_bfloat16*>(smem + partial_bytes(warps, kRowsX, K));
  const int p0 = blockIdx.x * kPairs;
  const int tiles = K / sm::kCols;

  // The W2 words and scales of the warp's first output tiles, loaded before
  // the up product so that they arrive while it runs.
  const int g_lo = ng_dn == 1 ? 0 : p0 / g_dn;
  const int g_hi = ng_dn == 1 ? 0 : (h_half + p0) / g_dn;
  auto fetch_down = [&](DownTile& d, int ct) {
    const int col = ct * sm::kCols + sm::kLaneCols * g;
    const int r[4] = {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t};
#pragma unroll
    for (int i = 0; i < 4; ++i) d.w[i] = sm::load_cols(q_dn + (size_t)(p0 + r[i]) * K, col, K);
    sm::load_scales(d.sl, s_dn + (size_t)g_lo * K, col, K);
    sm::load_scales(d.sh, s_dn + (size_t)g_hi * K, col, K);
  };
  DownTile held[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j)
    if (warp + j * warps < tiles) fetch_down(held[j], warp + j * warps);

  // Up: the warp's chunks of packed rows, as int4_matmul_small_m_kernel.
  const int col_u = g < 4 ? p0 + 4 * g : h_half + p0 + 4 * (g - 4);
  const int chunks = k_half / sm::kChunk;
  float acc[R][sm::kTiles][4];
#pragma unroll
  for (int rt = 0; rt < R; ++rt)
#pragma unroll
    for (int nt = 0; nt < sm::kTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][nt][e] = 0.f;
  for (int c = warp * chunks / warps; c < (warp + 1) * chunks / warps; ++c) {
    const int r0 = c * sm::kChunk;
    uint32_t q[8], b[R][4][2];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        q[2 * s + e] = sm::load_cols(q_up + (size_t)(r0 + 8 * s + 2 * t + e) * H, col_u, H);
#pragma unroll
    for (int rt = 0; rt < R; ++rt) {
      const int m = rt * 8 + g;
      const uint32_t* __restrict__ xrow =
          reinterpret_cast<const uint32_t*>(x + (size_t)(m < M ? m : 0) * K);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = r0 + 8 * s + 2 * t;
        b[rt][s][0] = m < M ? __ldg(xrow + k / 2) : 0u;
        b[rt][s][1] = m < M ? __ldg(xrow + (k_half + k) / 2) : 0u;
      }
    }
    const int gi = ng_up == 1 ? 0 : r0 / g_up;
    float sl[sm::kLaneCols], sh[sm::kLaneCols];
    sm::load_scales(sl, s_up + (size_t)gi * H, col_u, H);
    sm::load_scales(sh, s_up + (size_t)(ng_up == 1 ? 0 : ng_up / 2 + gi) * H, col_u, H);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float lo0[sm::kLaneCols], lo1[sm::kLaneCols], hi0[sm::kLaneCols], hi1[sm::kLaneCols];
      sm::dequant_row<false>(lo0, q[2 * s], sl);
      sm::dequant_row<false>(lo1, q[2 * s + 1], sl);
      sm::dequant_row<true>(hi0, q[2 * s], sh);
      sm::dequant_row<true>(hi1, q[2 * s + 1], sh);
#pragma unroll
      for (int nt = 0; nt < sm::kTiles; ++nt) {
        const uint32_t a[4] = {pack_bf16(lo0[2 * nt], lo1[2 * nt]),
                               pack_bf16(lo0[2 * nt + 1], lo1[2 * nt + 1]),
                               pack_bf16(hi0[2 * nt], hi1[2 * nt]),
                               pack_bf16(hi0[2 * nt + 1], hi1[2 * nt + 1])};
#pragma unroll
        for (int rt = 0; rt < R; ++rt) mma_bf16(acc[rt][nt], a, b[rt][s][0], b[rt][s][1]);
      }
    }
  }
#pragma unroll
  for (int rt = 0; rt < R; ++rt)
#pragma unroll
    for (int nt = 0; nt < sm::kTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * kRowsX + rt * 8 + 2 * t + e % 2) * kUnits + 4 * g + 2 * nt + e / 2] =
            acc[rt][nt][e];
  __syncthreads();

  // u = gelu(the warps' partials added in warp order), as three bf16 parts;
  // a thread two neighbouring units.
  for (int i = 2 * threadIdx.x; i < kRowsX * kUnits; i += 2 * blockDim.x) {
    float v0 = red[i], v1 = red[i + 1];
    for (int w = 1; w < warps; ++w) {
      v0 = __fadd_rn(v0, red[w * kRowsX * kUnits + i]);
      v1 = __fadd_rn(v1, red[w * kRowsX * kUnits + i + 1]);
    }
    uint32_t p[3];
    split3(gelu_tanh(v0), gelu_tanh(v1), p);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      *reinterpret_cast<uint32_t*>(us + (j * kRowsX + i / kUnits) * kUStride + i % kUnits) = p[j];
  }
  __syncthreads();

  // Down: the warp's output tiles, their partials to shared memory.
  auto down = [&](const DownTile& d, int ct) {
    float lo[R][sm::kTiles][4], hi[R][sm::kTiles][4];
#pragma unroll
    for (int rt = 0; rt < R; ++rt)
#pragma unroll
      for (int nt = 0; nt < sm::kTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) lo[rt][nt][e] = hi[rt][nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < sm::kTiles; ++nt) {
      // Bytes 2nt and 2nt + 1 (the tile's two columns) of rows 2t, 2t + 1
      // and of rows 8 + 2t, 9 + 2t, one row a 16-bit half.
      const uint32_t sel = nt ? 0x7632u : 0x5410u;
      const uint32_t r01 = __byte_perm(d.w[0], d.w[1], sel);
      const uint32_t r89 = __byte_perm(d.w[2], d.w[3], sel);
      const uint32_t a_lo[4] = {centered_pair(r01 & 0x000F000Fu),
                                centered_pair((r01 >> 8) & 0x000F000Fu),
                                centered_pair(r89 & 0x000F000Fu),
                                centered_pair((r89 >> 8) & 0x000F000Fu)};
      const uint32_t a_hi[4] = {centered_pair((r01 >> 4) & 0x000F000Fu),
                                centered_pair((r01 >> 12) & 0x000F000Fu),
                                centered_pair((r89 >> 4) & 0x000F000Fu),
                                centered_pair((r89 >> 12) & 0x000F000Fu)};
#pragma unroll
      for (int rt = 0; rt < R; ++rt)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const __nv_bfloat16* row = us + (j * kRowsX + rt * 8 + g) * kUStride + 2 * t;
          const uint32_t* u32 = reinterpret_cast<const uint32_t*>(row);
          mma_bf16(lo[rt][nt], a_lo, u32[0], u32[4]);    // units 2t.., 8 + 2t..
          mma_bf16(hi[rt][nt], a_hi, u32[8], u32[12]);   // units 16 + 2t.., 24 + 2t..
        }
    }
    // The block's partial: each group's sum times its scale, low then high.
    const int col = ct * sm::kCols + sm::kLaneCols * g;
#pragma unroll
    for (int rt = 0; rt < R; ++rt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nt = j / 2, i = 2 * (j % 2) + e;
          v[j] = __fadd_rn(__fmul_rn(lo[rt][nt][i], d.sl[j]), __fmul_rn(hi[rt][nt][i], d.sh[j]));
        }
        *reinterpret_cast<float4*>(red + (size_t)(rt * 8 + 2 * t + e) * ks + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
  };
  for (int ct0 = warp; ct0 < tiles; ct0 += kHeld * warps) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j)
      if (ct0 + j * warps < tiles) down(held[j], ct0 + j * warps);
#pragma unroll
    for (int j = 0; j < kHeld; ++j)
      if (ct0 + (kHeld + j) * warps < tiles) fetch_down(held[j], ct0 + (kHeld + j) * warps);
  }

  // Rank j of the cluster adds columns [j K/C, (j+1) K/C) of its blocks'
  // partials in rank order; then the last cluster to finish that slice adds
  // the clusters' sums in cluster order.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int csize = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int clusters = gridDim.x / csize, cl = blockIdx.x / csize;
  const int width = K / csize, quads = width / 4, c_lo = rank * width;
  for (int i = threadIdx.x; i < M * quads; i += blockDim.x) {
    const int m = i / quads, c = c_lo + 4 * (i % quads);
    float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, 0) +
                                                (size_t)m * ks + c);
    for (int r = 1; r < csize; ++r) {
      const float4 o = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r) +
                                                        (size_t)m * ks + c);
      v = make_float4(__fadd_rn(v.x, o.x), __fadd_rn(v.y, o.y), __fadd_rn(v.z, o.z),
                      __fadd_rn(v.w, o.w));
    }
    if (clusters == 1) {
      *reinterpret_cast<uint2*>(out + (size_t)m * K + c) =
          make_uint2(bits(__floats2bfloat162_rn(v.x, v.y)), bits(__floats2bfloat162_rn(v.z, v.w)));
    } else {
      *reinterpret_cast<float4*>(ws + ((size_t)cl * M + m) * K + c) = v;
    }
  }
  // This block is done reading the others' partials: it tells the cluster
  // so and goes on, and waits before it exits, so that no block leaves
  // while another still reads its partial.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (clusters > 1) {
    __threadfence();   // the slice's sum visible before the counter moves
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counters + rank, 1) == clusters - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int i = threadIdx.x; i < M * quads; i += blockDim.x) {
        const int m = i / quads, c = c_lo + 4 * (i % quads);
        float4 v = __ldcg(reinterpret_cast<const float4*>(ws + (size_t)m * K + c));
        for (int j = 1; j < clusters; ++j) {
          const float4 o =
              __ldcg(reinterpret_cast<const float4*>(ws + ((size_t)j * M + m) * K + c));
          v = make_float4(__fadd_rn(v.x, o.x), __fadd_rn(v.y, o.y), __fadd_rn(v.z, o.z),
                          __fadd_rn(v.w, o.w));
        }
        *reinterpret_cast<uint2*>(out + (size_t)m * K + c) = make_uint2(
            bits(__floats2bfloat162_rn(v.x, v.y)), bits(__floats2bfloat162_rn(v.z, v.w)));
      }
      if (threadIdx.x == 0) counters[rank] = 0;   // ready for the next launch
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Design "tensor_core".

namespace fftc {

constexpr int kPartBytes = 6;   // u's three bf16 parts of one hidden unit
constexpr int kChunk = 32;      // hidden units a run of each part in u's layout
constexpr int kDownRows = 32;   // rows of x a down block: two blocks an SM
constexpr int kDownRing = 4;    // stages of the down launch's ring: three in flight

// Where part j of u[row, h] lies in u's (M, H/32, 3, 32) layout, in bf16.
__device__ __forceinline__ size_t part_index(int row, int h, int H, int j) {
  return (size_t)row * 3 * H + (h / kChunk) * 3 * kChunk + j * kChunk + h % kChunk;
}

// The thread's share of one stage's integer weight tiles: packed rows 4w ..
// 4w + 3 (w its warp) at columns 4 lane .. + 3 into wl/wh[k][n] = bf16
// (q - 8) of the low/high nibbles, exact; one row a row(i) call, as
// tc::DequantBf16 without the scale.
struct DequantInt {
  const uint8_t* qs;
  uint8_t* wl;
  uint8_t* wh;

  __device__ __forceinline__ void row(int i) const {
    const int c = 4 * (threadIdx.x % 32), r = (threadIdx.x / 32) * 4 + i;
    const uint32_t word = *reinterpret_cast<const uint32_t*>(qs + r * tc::kBN + c);
    const uint32_t lo = word & 0x0F0F0F0Fu, hi = (word >> 4) & 0x0F0F0F0Fu;
    *reinterpret_cast<uint2*>(wl + r * tc::kW16Stride + 2 * c) =
        make_uint2(centered_pair(__byte_perm(lo, 0u, 0x4140u)),
                   centered_pair(__byte_perm(lo, 0u, 0x4342u)));
    *reinterpret_cast<uint2*>(wh + r * tc::kW16Stride + 2 * c) =
        make_uint2(centered_pair(__byte_perm(hi, 0u, 0x4140u)),
                   centered_pair(__byte_perm(hi, 0u, 0x4342u)));
  }
};

// tc::k_loop over stages [s0, s1) through a ring of L::kRing stages: the
// copies of stage kt + kRing - 1 start in iteration kt, so kRing - 1 stages
// are in flight (the down launch's ring is deeper than the up launch's).
template <typename L, int BM, int ES, typename Dequant, typename Stage>
__device__ __forceinline__ void ring_loop(uint8_t* smem, const uint8_t* __restrict__ q4,
                                          const uint8_t* __restrict__ x, int M, int K, int N,
                                          int m0, int n0, bool n_vec, Dequant dequant,
                                          Stage stage, int s0, int s1) {
  constexpr int kRing = L::kRing;
  auto load = [&](int s) {
    if (s < s1)
      tc::load_stage<BM, ES>(L::q(smem, s), L::xl(smem, s), L::xh(smem, s), q4, x, M, K, N, m0,
                             n0, s * tc::kBK, n_vec);
    tc_prims::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i + 1 < kRing; ++i) load(s0 + i);
  tc_prims::cp_async_wait<kRing - 2>();
  __syncthreads();
  dequant(s0);
  for (int kt = s0; kt < s1; ++kt) {
    tc_prims::cp_async_wait<kRing - 3>();
    __syncthreads();   // stage kt+1 landed, stage kt's weights whole, stage kt-1 done
    stage(kt, kt + 1 < s1, [&] { load(kt + kRing - 1); });
  }
}

}  // namespace fftc

// u = gelu(x @ dequant(q_up, s_up)) as three bf16 parts: rows [m0, m0 + BM)
// x hidden units [n0, n0 + 128) a block.
template <int BM>
__global__ void __launch_bounds__(kThreads, 2) int4_ff_up_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q_up,
    const float* __restrict__ s_up, __nv_bfloat16* __restrict__ u, int M, int K, int H,
    int ng_up, int g_up, int n_vec) {
  using namespace tc;
  constexpr int MT = BM / 32;
  extern __shared__ __align__(16) unsigned char smem[];
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
  w4a16_tile<BM>(acc, smem, x, q_up, s_up, M, K, H, ng_up, g_up, n_vec, m0, n0);

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn0 + nt * 8 + 2 * (lane % 4);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + wm0 + mt * 16 + lane / 4 + 8 * hr;
        if (row >= M || col >= H) continue;   // H is even: col < H covers col + 1
        uint32_t p[3];
        split3(gelu_tanh(acc[mt][nt][2 * hr]), gelu_tanh(acc[mt][nt][2 * hr + 1]), p);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          *reinterpret_cast<uint32_t*>(u + fftc::part_index(row, col, H, j)) = p[j];
      }
    }
}

// out = sum over the scale groups of s_dn[g] * (u's parts @ the integer
// nibbles of the group's packed rows): rows [m0, m0 + kDownRows) x output
// columns [n0, n0 + 128) a block, warps 2 x 4 of 16 x 32; blockIdx.z the
// piece of the groups (pieces of whole groups, `splits` of them). A stage is
// 32 packed rows of W2 and the three parts of the 32 low and the 32 high
// hidden units they hold; the low half's products go to `lo`, the high
// half's to `hi`, folded into `total` at each group's end (a stage lies in
// one group of each half: groups are multiples of 32 packed rows). One
// piece writes T; more write their fp32 totals to ws (splits x M x K), and
// the last piece of a tile to finish, found by an integer counter a tile,
// adds them in piece order and writes T.
__global__ void __launch_bounds__(kThreads, 2) int4_ff_down_tc_kernel(
    const __nv_bfloat16* __restrict__ u, const uint8_t* __restrict__ q_dn,
    const float* __restrict__ s_dn, float* __restrict__ ws, int* __restrict__ counters,
    __nv_bfloat16* __restrict__ out, int M, int K, int H, int ng_dn, int g_dn, int n_vec) {
  using namespace tc;
  using L = Layout<fftc::kDownRows, fftc::kPartBytes, kW16Bytes, fftc::kDownRing>;
  constexpr int MT = fftc::kDownRows / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int m0 = blockIdx.x * fftc::kDownRows, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / 4) * (fftc::kDownRows / 2), wn0 = (warp % 4) * 32;
  const int group_stages = (ng_dn == 1 ? H / 2 : g_dn) / kBK;
  const int groups = H / 2 / kBK / group_stages, splits = gridDim.z;
  const int s0 = blockIdx.z * groups / splits * group_stages;
  const int s1 = (blockIdx.z + 1) * groups / splits * group_stages;
  float lo[MT][4][4], hi[MT][4][4], total[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[i][j][e] = hi[i][j][e] = total[i][j][e] = 0.f;

  auto fold = [&](int kt) {
    if ((kt + 1) % group_stages) return;
    const int gi = kt / group_stages;
    const float* __restrict__ sl = s_dn + (size_t)(ng_dn == 1 ? 0 : gi) * K;
    const float* __restrict__ sh = s_dn + (size_t)(ng_dn == 1 ? 0 : ng_dn / 2 + gi) * K;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + wn0 + nt * 8 + 2 * (lane % 4) + e;
        const int cc = col < K ? col : K - 1;
        const float a = __ldg(sl + cc), b = __ldg(sh + cc);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 2 * hr + e;
            total[mt][nt][i] = __fadd_rn(total[mt][nt][i], __fmul_rn(lo[mt][nt][i], a));
            total[mt][nt][i] = __fadd_rn(total[mt][nt][i], __fmul_rn(hi[mt][nt][i], b));
            lo[mt][nt][i] = hi[mt][nt][i] = 0.f;
          }
      }
  };
  // The three parts' products of one half at depth k0 .. k0 + 15.
  auto products = [&](float (&acc)[MT][4][4], const uint8_t* xs, const uint8_t* wt, int k0) {
    uint32_t b[4][2];
    load_b_bf16(b, wt, wn0, k0);
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        load_a<fftc::kPartBytes>(a, xs, wm0 + mt * 16, j * 2 * kBK + 2 * k0);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
  };
  auto dequant = [&](int s) {
    return fftc::DequantInt{L::q(smem, s), L::wl(smem, s), L::wh(smem, s)};
  };
  auto stage = [&](int kt, bool next, auto fetch) {
    const fftc::DequantInt d = dequant(kt + 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k0 = (j % 2) * 16;
      if (j < 2)
        products(lo, L::xl(smem, kt), L::wl(smem, kt), k0);
      else
        products(hi, L::xh(smem, kt), L::wh(smem, kt), k0);
      if (j == 0) fetch();
      if (next) d.row(j);
    }
    fold(kt);
  };
  fftc::ring_loop<L, fftc::kDownRows, fftc::kPartBytes>(
      smem, q_dn, reinterpret_cast<const uint8_t*>(u), M, H, K, m0, n0, n_vec,
      [&](int s) {
        const fftc::DequantInt d = dequant(s);
#pragma unroll
        for (int i = 0; i < 4; ++i) d.row(i);
      },
      stage, s0, s1);

  // Accumulator (mt, nt): rows lane/4 (+8), columns 2*(lane%4) + {0, 1}.
  auto each = [&](auto&& fn) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + wm0 + mt * 16 + lane / 4 + 8 * hr;
          const int col = n0 + wn0 + nt * 8 + 2 * (lane % 4);
          if (row < M && col < K)   // K is even: col < K covers col + 1
            fn(row, col, total[mt][nt][2 * hr], total[mt][nt][2 * hr + 1]);
        }
  };
  auto store = [&](int row, int col, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * K + col) =
        __floats2bfloat162_rn(a, b);
  };
  if (splits == 1) {
    each(store);
    return;
  }
  each([&](int row, int col, float a, float b) {
    *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.z * M + row) * K + col) = make_float2(a, b);
  });
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.x * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) last = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  each([&](int row, int col, float, float) {
    float2 v = __ldcg(reinterpret_cast<const float2*>(ws + (size_t)row * K + col));
    for (int z = 1; z < splits; ++z) {
      const float2 o = __ldcg(reinterpret_cast<const float2*>(ws + ((size_t)z * M + row) * K + col));
      v = make_float2(__fadd_rn(v.x, o.x), __fadd_rn(v.y, o.y));
    }
    store(row, col, v.x, v.y);
  });
  if (threadIdx.x == 0) counters[tile] = 0;   // ready for the next launch
}

template <typename Fn>
cudaError_t set_smem(Fn kernel, size_t bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_cuda_core(const void* x, const uint8_t* q_up, const float* s_up, const uint8_t* q_dn,
                     const float* s_dn, float* partial, void* out, int M, int K, int H, int ng_up,
                     int g_up, int ng_dn, int g_dn, int P, cudaStream_t stream) {
  if (M == 0) return (int)cudaSuccess;
  if (P % 16 || (H / 2) % P || K % 4) return -1;
  const int tile_m = M < kMaxTileM ? M : kMaxTileM;
  const size_t smem = ((size_t)tile_m * K * sizeof(T) + 15) / 16 * 16 +
                      (size_t)kMaxTileM * 2 * P * sizeof(float) +
                      (size_t)kWarps * kMaxTileM * kTileN * sizeof(float);
  auto kernel = int4_ff_kernel<T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int nslab = H / 2 / P;
  const dim3 grid(nslab, (M + tile_m - 1) / tile_m);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), q_up, s_up, q_dn, s_dn,
                                           partial, M, K, H, ng_up, g_up, ng_dn, g_dn, P,
                                           tile_m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t mk = (size_t)M * K;
  int4_ff_reduce_kernel<T><<<(unsigned)((mk + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      partial, static_cast<T*>(out), nslab, mk);
  return (int)cudaGetLastError();
}

// Design "small_m": K/2 in whole 32-row chunks (each within one up group),
// H/2 in whole blocks of kPairs rows (each within one down group of each
// half), up to 8R rows; `cluster` blocks a cluster dividing the grid and
// K/4; ws (grid / cluster, M, K) fp32, counters `cluster` ints that are zero.
template <int R>
int launch_small_m(const __nv_bfloat16* x, const uint8_t* q_up, const float* s_up,
                   const uint8_t* q_dn, const float* s_dn, float* ws, int* counters,
                   __nv_bfloat16* out, int M, int K, int H, int ng_up, int g_up, int ng_dn,
                   int g_dn, int cluster, cudaStream_t stream) {
  using namespace ffsm;
  const int chunks = K / 2 / sm::kChunk, blocks = H / 2 / kPairs;
  if (M < 1 || M > 8 * R || K % (2 * sm::kChunk) || (ng_up != 1 && g_up % sm::kChunk) ||
      (H / 2) % kPairs || (ng_dn != 1 && g_dn % kPairs) || cluster < 1 ||
      cluster > kMaxCluster || blocks % cluster || (K / cluster) % 4 ||
      reinterpret_cast<uintptr_t>(x) % 4)
    return -1;
  const int warps = chunks < kMaxWarps ? chunks : kMaxWarps;
  const size_t smem = smem_bytes(warps, 8 * R, K);
  auto kernel = int4_ff_small_m_kernel<R>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(32 * warps);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, x, q_up, s_up, q_dn, s_dn, ws, counters, out, M, K,
                           H, ng_up, g_up, ng_dn, g_dn);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BM>
int launch_up_tc(const __nv_bfloat16* x, const uint8_t* q_up, const float* s_up,
                 __nv_bfloat16* u, int M, int K, int H, int ng_up, int g_up,
                 cudaStream_t stream) {
  using L = tc::Layout<BM, 2, tc::kW16Bytes>;
  auto kernel = int4_ff_up_tc_kernel<BM>;
  cudaError_t err = set_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const bool n_vec = H % 16 == 0 && reinterpret_cast<uintptr_t>(q_up) % 16 == 0;
  const dim3 grid((M + BM - 1) / BM, (H + tc::kBN - 1) / tc::kBN);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(x, q_up, s_up, u, M, K, H, ng_up, g_up, n_vec);
  return (int)cudaGetLastError();
}

int launch_down_tc(const __nv_bfloat16* u, const uint8_t* q_dn, const float* s_dn, float* ws,
                   int* counters, __nv_bfloat16* out, int M, int K, int H, int ng_dn, int g_dn,
                   int splits, cudaStream_t stream) {
  using L = tc::Layout<fftc::kDownRows, fftc::kPartBytes, tc::kW16Bytes, fftc::kDownRing>;
  const int groups = ng_dn == 1 ? 1 : ng_dn / 2;
  if (splits < 1 || groups % splits) return -1;
  auto kernel = int4_ff_down_tc_kernel;
  cudaError_t err = set_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const bool n_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(q_dn) % 16 == 0;
  const dim3 grid((M + fftc::kDownRows - 1) / fftc::kDownRows, (K + tc::kBN - 1) / tc::kBN,
                  splits);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(u, q_dn, s_dn, ws, counters, out, M, K, H,
                                                ng_dn, g_dn, n_vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Design "cuda_core": gelu_tanh(x @ dequant(q_up, s_up)) @ dequant(q_dn,
// s_dn) -> out (M, K), dtype 0 = fp32, 1 = bf16 (x and out). partial is fp32
// scratch of (H/2/P, M, K); P packed down rows per block, a multiple of 16
// dividing H/2; K a multiple of 4. g_up / g_dn are the groups (min(group,
// K) / min(group, H)), ng_up / ng_dn the scale rows. Returns
// cudaGetLastError() after the launches, or -1 for an unsupported dtype or
// tiling.
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
    return launch_cuda_core<float>(x, qu, su, qd, sd, part, out, M, K, H, ng_up, g_up, ng_dn,
                                   g_dn, P, st);
  if (dtype == 1)
    return launch_cuda_core<__nv_bfloat16>(x, qu, su, qd, sd, part, out, M, K, H, ng_up, g_up,
                                           ng_dn, g_dn, P, st);
  return -1;
}

// Design "small_m", bf16 x and out (M <= 16 rows): ws is fp32 scratch of
// (H/2/16/cluster, M, K), counters `cluster` int32 zeros (left zero).
int int4_ff_small_m_launch(const void* x, const void* q_up, const void* s_up, const void* q_dn,
                           const void* s_dn, void* ws, void* counters, void* out, int M, int K,
                           int H, int ng_up, int g_up, int ng_dn, int g_dn, int cluster,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qu = static_cast<const uint8_t*>(q_up);
  const auto* qd = static_cast<const uint8_t*>(q_dn);
  const auto* su = static_cast<const float*>(s_up);
  const auto* sd = static_cast<const float*>(s_dn);
  auto* w = static_cast<float*>(ws);
  auto* c = static_cast<int*>(counters);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (M == 0) return (int)cudaSuccess;
  if (M <= 8)
    return launch_small_m<1>(xb, qu, su, qd, sd, w, c, o, M, K, H, ng_up, g_up, ng_dn, g_dn,
                             cluster, st);
  return launch_small_m<2>(xb, qu, su, qd, sd, w, c, o, M, K, H, ng_up, g_up, ng_dn, g_dn,
                           cluster, st);
}

// Design "tensor_core", bf16 x and out: the up launch (up_rows = 128 or 96
// rows of x a block) writes u's parts to `u` ((M, 3H) bf16 scratch), the
// down launch reads them in `splits` pieces of the scale groups (dividing
// them); past one piece ws is fp32 scratch of (splits, M, K) and counters
// ceil(M/32) * ceil(K/128) int32 zeros (left zero). K/2 and H/2 multiples
// of 32; g_dn (or H/2 for one whole-H group) a multiple of 32 packed rows;
// x 16-byte aligned.
int int4_ff_tc_launch(const void* x, const void* q_up, const void* s_up, const void* q_dn,
                      const void* s_dn, void* u, void* ws, void* counters, void* out, int M,
                      int K, int H, int ng_up, int g_up, int ng_dn, int g_dn, int up_rows,
                      int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qu = static_cast<const uint8_t*>(q_up);
  const auto* qd = static_cast<const uint8_t*>(q_dn);
  const auto* su = static_cast<const float*>(s_up);
  const auto* sd = static_cast<const float*>(s_dn);
  auto* ub = static_cast<__nv_bfloat16*>(u);
  if (M == 0) return (int)cudaSuccess;
  if ((K / 2) % tc::kBK || (H / 2) % tc::kBK || (ng_dn != 1 && g_dn % tc::kBK) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(u) % 16)
    return -1;
  int err;
  if (up_rows == tc::kBM16)
    err = launch_up_tc<tc::kBM16>(xb, qu, su, ub, M, K, H, ng_up, g_up, st);
  else if (up_rows == tc::kBM16Small)
    err = launch_up_tc<tc::kBM16Small>(xb, qu, su, ub, M, K, H, ng_up, g_up, st);
  else
    return -1;
  if (err != 0) return err;
  return launch_down_tc(ub, qd, sd, static_cast<float*>(ws), static_cast<int*>(counters),
                        static_cast<__nv_bfloat16*>(out), M, K, H, ng_dn, g_dn, splits, st);
}

}  // extern "C"
