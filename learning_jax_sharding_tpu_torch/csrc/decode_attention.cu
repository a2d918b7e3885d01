// Length-aware KV-cache attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel learning_jax_sharding_tpu/ops/decode_attention.py
// ::_kernel (launched by decode_attention there). It computes what that
// kernel computes, for float and int8 caches: the queries of a chunk attend
// to the valid prefix of a (B, N_kv, L, H) cache, per row, with the GQA group
// folded into the query rows, an optional causal sliding window, and an
// optional folded write of the new token's k/v (S = 1) gated per row by
// write_enable. An int8 cache carries fp32 per-(token, head) scales
// (B, N_kv, L): each score column is multiplied by its k scale after the q.k
// contraction, and each probability column by its v scale after the row
// sum l has taken it unscaled; the folded write merges the new token's scales
// too. (The paged block table is not ported yet.)
//
// Design. One thread block per (q tile, kv head, batch row). The TPU kernel's
// sequential k grid axis is a loop inside the block, from the row's first
// needed cache tile (the window start) to the tile holding the tile's causal
// frontier, both computed here from the device index: per-row traffic scales
// with the valid prefix, not with L, and nothing is synchronised to the host.
// Per 64-slot cache tile: K and V are staged in shared memory as fp32, the
// block computes fp32 scores for its rows, masks with -1e30 (causal and
// window), and runs an online softmax (m, l, acc in fp32). At the end l == 0
// is guarded to 1 and the output is written in q's dtype, in the (B, S, N, H)
// layout of q. The folded write lands in global memory before the first read
// of the block's own (b, kv head) cache row; __syncthreads makes it visible.
//
// Bound on this card: the bytes of the valid K/V prefix (int8: one byte a
// value plus 4 bytes of scale per token and head) plus q and out at 3.35 TB/s
// (H100 SXM); the arithmetic is far below the tensor-core line.
// What the simple design leaves for later: no tensor cores (scores and P.V
// run on the CUDA cores), no TMA or cp.async pipelining of the tiles, and only
// B * N_kv * (q tiles) blocks -- 96 at the 125M decode shape (b = 8, 12 heads)
// against 132 SMs -- so a split over the cache length (split-K) would fill
// the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 64;        // cache slots per shared-memory tile
constexpr int kMaxRows = 128;     // query rows (query x head-in-group) per block
constexpr float kNegInf = -1e30f; // as the TPU kernel: keeps exp/max NaN-free

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

template <typename C> struct Int8Cache { static constexpr bool value = false; };
template <> struct Int8Cache<int8_t> { static constexpr bool value = true; };

__device__ __forceinline__ void from_float(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

// Copy rows [row0, row0 + kTileK) of one (b, kv head) cache slab into shared
// memory as fp32, zero-filling rows at or past `length`. 16-byte loads.
template <typename T, int H, int LD>
__device__ __forceinline__ void load_tile(
    float* dst, const T* slab, int row0, int length) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = H / kVec;
  for (int i = threadIdx.x; i < kTileK * kVecsPerRow; i += kThreads) {
    const int r = i / kVecsPerRow;
    const int c = (i % kVecsPerRow) * kVec;
    float* out = dst + r * LD + c;
    if (row0 + r < length) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(slab + (size_t)(row0 + r) * H + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = to_float(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = 0.f;
    }
  }
}

// Scales of cache slots [row0, row0 + kTileK) of one (b, kv head) row, 0 past
// `length` (those columns are masked).
__device__ __forceinline__ void load_scales(float* dst, const float* row, int row0, int length) {
  for (int c = threadIdx.x; c < kTileK; c += kThreads)
    dst[c] = row0 + c < length ? row[row0 + c] : 0.f;
}

// T: q and out (fp32 or bf16). C: the caches and the new token's k/v, T or
// int8_t; int8 caches come with the scale pointers.
template <typename T, typename C, int H>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, C* k_cache, C* v_cache,
    const int* __restrict__ index, const C* __restrict__ k_new,
    const C* __restrict__ v_new, const int* __restrict__ write_enable,
    float* k_scale, float* v_scale, const float* __restrict__ ks_new,
    const float* __restrict__ vs_new, T* __restrict__ out, int S, int N, int n_kv,
    int length, int window, float scale, int tile_rows) {
  constexpr bool kInt8 = Int8Cache<C>::value;
  constexpr int kLdK = H + 1;                        // pad: conflict-free score reads
  constexpr int kRowStep = kThreads / H;             // rows apart in one thread's acc
  constexpr int kAccPerThread = kMaxRows / kRowStep;

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = N / n_kv;
  const int total_rows = S * group;
  const int row0 = tile * tile_rows;
  const int rows = min(tile_rows, total_rows - row0);
  const int idx = index[b];

  extern __shared__ float smem[];
  float* q_s = smem;                                 // rows x H
  float* k_s = q_s + tile_rows * H;                  // kTileK x (H + 1)
  float* v_s = k_s + kTileK * kLdK;                  // kTileK x H
  float* p_s = v_s + kTileK * H;                     // rows x kTileK
  float* m_s = p_s + tile_rows * kTileK;             // rows
  float* l_s = m_s + tile_rows;                      // rows
  float* corr_s = l_s + tile_rows;                   // rows
  float* ks_s = corr_s + tile_rows;                  // kTileK (int8 only)
  float* vs_s = ks_s + kTileK;                       // kTileK (int8 only)

  const size_t head = (size_t)b * n_kv + kvh;
  const size_t slab = head * (size_t)length * H;
  C* k_slab = k_cache + slab;
  C* v_slab = v_cache + slab;

  // Folded write: the new token's k/v (and scales) into slot idx of this
  // block's own cache row, before anything reads it. S == 1, so one block per
  // (b, kv head).
  if (k_new != nullptr && (write_enable == nullptr || write_enable[b] != 0) &&
      idx >= 0 && idx < length) {
    const size_t src = head * H;
    for (int d = threadIdx.x; d < H; d += kThreads) {
      k_slab[(size_t)idx * H + d] = k_new[src + d];
      v_slab[(size_t)idx * H + d] = v_new[src + d];
    }
    if (kInt8 && threadIdx.x == 0) {
      k_scale[head * length + idx] = ks_new[head];
      v_scale[head * length + idx] = vs_new[head];
    }
  }

  // Query rows of this tile: row g = query (g / group), head (kvh * group +
  // g % group) -- q head n belongs to kv head n / group.
  for (int i = threadIdx.x; i < rows * H; i += kThreads) {
    const int r = i / H, d = i % H;
    const int g = row0 + r;
    const int n = kvh * group + g % group;
    const size_t off = (((size_t)b * S + g / group) * N + n) * H + d;
    q_s[r * H + d] = to_float(q[off]) * scale;
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;
  const int d_own = threadIdx.x % H;
  const int r_own = threadIdx.x / H;

  // Cache span this tile needs: from the first query's window start to the
  // last query's causal frontier (never past the buffer).
  const int last_col = min(idx + (row0 + rows - 1) / group, length - 1);
  const int first_col = window > 0 ? max(0, idx - (window - 1)) : 0;
  __syncthreads();

  for (int kt = first_col / kTileK; kt <= last_col / kTileK; ++kt) {
    const int col0 = kt * kTileK;
    load_tile<C, H, kLdK>(k_s, k_slab, col0, length);
    load_tile<C, H, H>(v_s, v_slab, col0, length);
    if (kInt8) {
      load_scales(ks_s, k_scale + head * length, col0, length);
      load_scales(vs_s, v_scale + head * length, col0, length);
    }
    __syncthreads();

    // Scores: thread owns column c of rows r, r + kThreads / kTileK, ...
    for (int i = threadIdx.x; i < rows * kTileK; i += kThreads) {
      const int r = i / kTileK, c = i % kTileK;
      const float* qr = q_s + r * H;
      const float* kc = k_s + c * kLdK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < H; ++d) s += qr[d] * kc[d];
      if (kInt8) s *= ks_s[c];                       // k scale: the score column
      const int qpos = idx + (row0 + r) / group;
      const int col = col0 + c;
      bool keep = col <= qpos && col < length;
      if (window > 0) keep = keep && col > qpos - window;
      p_s[r * kTileK + c] = keep ? s : kNegInf;
    }
    __syncthreads();

    // Online softmax, one warp per row.
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* pr = p_s + r * kTileK;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      // l (below) sums the unscaled p; the v scales weight P.V only.
      pr[lane] = kInt8 ? p0 * vs_s[lane] : p0;
      pr[lane + 32] = kInt8 ? p1 * vs_s[lane + 32] : p1;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[r] = corr;
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r, d] = acc * corr[r] + sum_c p[r, c] * v[c, d].
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int r = r_own + i * kRowStep;
      if (r < rows) {
        const float* pr = p_s + r * kTileK;
        float a = acc[i] * corr_s[r];
#pragma unroll 16
        for (int c = 0; c < kTileK; ++c) a += pr[c] * v_s[c * H + d_own];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int r = r_own + i * kRowStep;
    if (r < rows) {
      const float l = l_s[r];
      const float o = acc[i] / (l == 0.f ? 1.f : l);
      const int g = row0 + r;
      const int n = kvh * group + g % group;
      const size_t off = (((size_t)b * S + g / group) * N + n) * H + d_own;
      from_float(out + off, o);
    }
  }
}

size_t smem_bytes(int tile_rows, int h) {
  return sizeof(float) * ((size_t)tile_rows * h + (size_t)kTileK * (h + 1) +
                          (size_t)kTileK * h + (size_t)tile_rows * kTileK +
                          3 * (size_t)tile_rows + 2 * (size_t)kTileK);
}

template <typename T, typename C, int H>
int launch(const void* q, void* k_cache, void* v_cache, const int* index,
           const void* k_new, const void* v_new, const int* write_enable,
           float* k_scale, float* v_scale, const float* ks_new, const float* vs_new,
           void* out, int B, int S, int N, int n_kv, int length, int window,
           float scale, int tile_rows, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, C, H>;
  static bool attribute_set = false;
  const size_t smem = smem_bytes(kMaxRows, H);
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const int tiles = (S * (N / n_kv) + tile_rows - 1) / tile_rows;
  dim3 grid(tiles, n_kv, B);
  kernel<<<grid, kThreads, smem_bytes(tile_rows, H), stream>>>(
      static_cast<const T*>(q), static_cast<C*>(k_cache),
      static_cast<C*>(v_cache), index, static_cast<const C*>(k_new),
      static_cast<const C*>(v_new), write_enable, k_scale, v_scale, ks_new,
      vs_new, static_cast<T*>(out), S, N, n_kv, length, window, scale, tile_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (q, out): 0 = float32, 1 = bfloat16. quantized: the caches and k_new
// / v_new are int8 and the four scale pointers are given (ks_new / vs_new with
// the folded write); otherwise the caches are in dtype and the scales null.
// window <= 0: no window. k_new / v_new / write_enable may be null. Returns
// cudaGetLastError() after the launch; -1 for a head_dim, dtype or tile size
// this kernel does not take.
int decode_attention_launch(
    const void* q, void* k_cache, void* v_cache, const int* index,
    const void* k_new, const void* v_new, const int* write_enable, float* k_scale,
    float* v_scale, const float* ks_new, const float* vs_new, void* out,
    int dtype, int quantized, int B, int S, int N, int n_kv, int length, int H,
    int window, float scale, int tile_rows, void* stream) {
  if (tile_rows < 1 || tile_rows > kMaxRows) return -1;
  if (quantized && (k_scale == nullptr || v_scale == nullptr ||
               (k_new != nullptr && (ks_new == nullptr || vs_new == nullptr))))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, C, HD)                                                         \
  return launch<T, C, HD>(q, k_cache, v_cache, index, k_new, v_new,              \
                          write_enable, k_scale, v_scale, ks_new, vs_new, out,   \
                          B, S, N, n_kv, length, window, scale, tile_rows, st)
  if (dtype == 0 && !quantized && H == 64) LAUNCH(float, float, 64);
  if (dtype == 0 && !quantized && H == 128) LAUNCH(float, float, 128);
  if (dtype == 1 && !quantized && H == 64) LAUNCH(__nv_bfloat16, __nv_bfloat16, 64);
  if (dtype == 1 && !quantized && H == 128) LAUNCH(__nv_bfloat16, __nv_bfloat16, 128);
  if (dtype == 0 && quantized && H == 64) LAUNCH(float, int8_t, 64);
  if (dtype == 0 && quantized && H == 128) LAUNCH(float, int8_t, 128);
  if (dtype == 1 && quantized && H == 64) LAUNCH(__nv_bfloat16, int8_t, 64);
  if (dtype == 1 && quantized && H == 128) LAUNCH(__nv_bfloat16, int8_t, 128);
#undef LAUNCH
  return -1;
}

}  // extern "C"
