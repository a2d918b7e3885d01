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
// too.
//
// Paged mode (block_table non-null): the caches are (P, N_kv, page, H) pools
// shared by every row, scales (P, N_kv, page), and row b's logical cache slot
// r lives at pool row (table[b * T + r / page] * N_kv + kv head) * page +
// r % page. The TPU kernel sends each logical block through the table in its
// index maps; here each logical row is translated on its own (RowMap), so any
// page size works. Everything else -- tiling, pieces, masks, frontier,
// arithmetic -- is logical and the same in both modes, so a paged launch
// gives the bits of a contiguous launch over the same values, in every
// design. The folded write lands at the row's mapped page and slot. Pages may
// be shared read-only between rows (a prefix cache): a block writes only its
// own row's write slot, which the caller keeps on a private page.
//
// Every block serves one (q tile, kv head, batch row) and one piece of the
// cache span its rows attend: from the first row's window start to the last
// row's causal frontier, both computed on the device from the index (no host
// sync; per-row traffic scales with the valid prefix, not with L). The TPU
// kernel's sequential k grid axis is a loop inside the block over 64-slot
// tiles (kTileK).
//
// Split over the cache length (flash-decoding). The grid is (splits x q
// tiles, N_kv, B); the host picks `splits` from the grid and the capacity
// alone. Each block cuts its span's tiles into `splits` pieces of whole
// 64-slot tiles (piece_tiles), on the device. With splits = 1 a block writes
// `out` itself. Otherwise each block writes its rows' partials (m in log2
// units, l, the unnormalised fp32 acc) to a workspace, an empty piece m =
// -1e30 and l = 0, and decode_attention_combine_kernel merges the pieces in
// fixed order and writes `out` in q's dtype: deterministic, and paged still
// equals contiguous.
//
// The folded write (S = 1) needs no ordering between blocks: slot idx_b lies
// in exactly one piece of a (q tile, kv head, batch row), that piece's block
// writes it before its own first read (a __syncthreads between), and no
// other block reads slot idx_b. Several q tiles (a GQA group of more than a
// tile's rows) each write the same values to the slot before reading it, so
// every read sees those values.
//
// Three kernels compute a piece:
//   * decode_attention_tc_kernel<C, H, BK> (the tensor-core design; bf16 q,
//     bf16 or int8 cache): chunk rows (S * group >= 16: the engine's refill,
//     the prompt's prefill). 4 warps x 16 folded rows, Q held in registers as
//     mma.sync.m16n8k16 A fragments, K/V through a 2-stage cp.async ring
//     (int8 bytes staged, then widened to bf16 in shared memory, exactly),
//     scores and P.V on the tensor cores in fp32, the online softmax on the
//     C fragments in log2 units, masks from per-row key bounds on edge tiles
//     only.
//   * decode_attention_rows_kernel<T, C, H, R> (the CUDA-core design split,
//     at most 4 folded rows: the token step): K/V read straight from device
//     memory, 8 values (16 bytes of bf16) a lane, H / 8 lanes a key row, so a
//     warp step takes 4 keys at H = 64; every load of a 64-slot tile is in
//     flight before the first product; warp-shuffle dot products, the online
//     softmax in registers, no staging tile.
//   * decode_attention_kernel<T, C, H> (the CUDA-core design, the first
//     design of this port): fp32 K/V tiles in shared memory, scores and P.V
//     as fp32 FMAs; any rows; with splits = 1, today's schedule.
//
// Bound on this card: the bytes of the valid K/V prefix (int8: one byte a
// value plus 4 bytes of scale per token and head) plus q and out at 3.35 TB/s
// (H100 SXM); the products are far below the tensor-core line. The split
// fills the card's 132 SMs where B * N_kv * (q tiles) would not (96 blocks at
// the 125M shapes), at the price of the partials' bytes and a second launch.
// Left for later: wgmma and TMA for the chunk design, and a persistent
// schedule that would fold the combine into the same launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 64;        // cache slots per tile; pieces are whole tiles
constexpr int kMaxRows = 128;     // query rows (query x head-in-group) per block
constexpr int kMaxSplits = 16;   // MAX_SPLITS in ops/decode_attention.py
constexpr float kNegInf = -1e30f; // as the TPU kernel: keeps exp/max NaN-free
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

template <typename C> struct Int8Cache { static constexpr bool value = false; };
template <> struct Int8Cache<int8_t> { static constexpr bool value = true; };

__device__ __forceinline__ void from_float(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

// One launch: the caller's pointers and shapes. T is q's type, C the caches'.
struct Problem {
  const void* q;
  void* k_cache;
  void* v_cache;
  const int* index;
  const void* k_new;
  const void* v_new;
  const int* write_enable;
  float* k_scale;
  float* v_scale;
  const float* ks_new;
  const float* vs_new;
  void* out;
  float* part_ml;    // splits > 1: (splits, B, N_kv, S * group) x (m, l)
  float* part_acc;   // splits > 1: (splits, B, N_kv, S * group, H)
  const int* block_table;
  int B, S, N, n_kv, length, window, tile_rows, tiles, splits, T_blocks, page;
  float scale;
};

// Where the logical cache slots of one (b, kv head) live: the index of slot
// r's row of H values in the cache (or pool) array, which is also the index
// of its scale in the scale array.
struct RowMap {
  const int* table;  // this row's T block-table entries; null: contiguous
  unsigned base;     // contiguous: (b * n_kv + kvh) * length; paged: kvh
  int n_kv, page;
  __device__ __forceinline__ unsigned operator()(int r) const {
    if (table == nullptr) return base + r;
    return ((unsigned)table[r / page] * n_kv + base) * page + r % page;
  }
};

__device__ __forceinline__ RowMap row_map(const Problem& p, int b, int kvh) {
  if (p.block_table == nullptr)
    return RowMap{nullptr, (unsigned)(((size_t)b * p.n_kv + kvh) * p.length), p.n_kv, p.page};
  return RowMap{p.block_table + (size_t)b * p.T_blocks, (unsigned)kvh, p.n_kv, p.page};
}

// The cache slots folded row `row` attends: lo <= col <= hi, from the row's
// position idx + row / group (causal frontier, clipped to the cache; window
// start). Rows past the last take the last row's bounds.
struct RowBounds {
  int idx, group, total, length, window;
  __device__ __forceinline__ void operator()(int row, int& lo, int& hi) const {
    const int qpos = idx + min(row, total - 1) / group;
    hi = min(qpos, length - 1);
    lo = window > 0 ? max(0, qpos - window + 1) : 0;
  }
};

// Piece `piece` of `splits` over the tiles of [first_col, last_col]: tiles
// [kt0, kt1), the span's n tiles cut as evenly as whole tiles allow (empty
// when kt0 == kt1). ops/decode_attention.py::split_ranges is its plain twin.
__device__ __forceinline__ void piece_tiles(int first_col, int last_col, int splits, int piece,
                                            int& kt0, int& kt1) {
  const int first_kt = first_col / kTileK;
  const int n = last_col >= first_col ? last_col / kTileK - first_kt + 1 : 0;
  kt0 = first_kt + piece * n / splits;
  kt1 = first_kt + (piece + 1) * n / splits;
}

// Offset of folded row g's H values in q and out, (B, S, N, H).
template <int H>
__device__ __forceinline__ size_t q_offset(const Problem& p, int b, int kvh, int g) {
  const int group = p.N / p.n_kv;
  return (((size_t)b * p.S + g / group) * p.N + kvh * group + g % group) * H;
}

// Index of folded row g's partial for piece `piece`.
__device__ __forceinline__ size_t part_index(const Problem& p, int piece, int b, int kvh, int g) {
  const int total = p.S * (p.N / p.n_kv);
  return (((size_t)piece * p.B + b) * p.n_kv + kvh) * total + g;
}

// Programmatic dependent launch (Hopper). The split's kernels are launched
// with it, so each may be scheduled while the kernel before it in the
// stream drains: it waits for that grid's completion and memory at
// wait_prior_grid, before its first global access. A piece kernel calls
// allow_next_grid once its block has written its results, so the combine
// is launched as the last blocks finish, not after the grid has retired.
// (A profiler's duration of such a kernel includes its wait.)
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The folded write: the new token's k/v (and int8 scales) into slot idx of
// (b, kv head), by the block whose piece [kt0, kt1) holds the slot, before
// anything in the block reads it (the caller's __syncthreads follows).
template <typename C, int H>
__device__ __forceinline__ void fold_write(const Problem& p, const RowMap& slots, int b, int kvh,
                                           int idx, int kt0, int kt1) {
  if (p.k_new == nullptr || (p.write_enable != nullptr && p.write_enable[b] == 0) || idx < 0 ||
      idx >= p.length || idx / kTileK < kt0 || idx / kTileK >= kt1)
    return;
  const size_t head = (size_t)b * p.n_kv + kvh;
  const size_t dst = slots(idx);   // a row index: its values start at dst * H
  C* k_cache = static_cast<C*>(p.k_cache);
  C* v_cache = static_cast<C*>(p.v_cache);
  const C* k_new = static_cast<const C*>(p.k_new);
  const C* v_new = static_cast<const C*>(p.v_new);
  for (int d = threadIdx.x; d < H; d += blockDim.x) {
    k_cache[dst * H + d] = k_new[head * H + d];
    v_cache[dst * H + d] = v_new[head * H + d];
  }
  if (Int8Cache<C>::value && threadIdx.x == 0) {
    p.k_scale[dst] = p.ks_new[head];
    p.v_scale[dst] = p.vs_new[head];
  }
}

// ------------------------------------------------ CUDA cores, staged tiles

// Copy logical slots [row0, row0 + kTileK) of one (b, kv head) cache into
// shared memory as fp32, zero-filling slots at or past `length`; `rows` holds
// the tile's row indices (RowMap). 16-byte loads.
template <typename T, int H, int LD>
__device__ __forceinline__ void load_tile(
    float* dst, const T* cache, const unsigned* rows, int row0, int length) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = H / kVec;
  for (int i = threadIdx.x; i < kTileK * kVecsPerRow; i += kThreads) {
    const int r = i / kVecsPerRow;
    const int c = (i % kVecsPerRow) * kVec;
    float* out = dst + r * LD + c;
    if (row0 + r < length) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(cache + (size_t)rows[r] * H + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = to_float(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = 0.f;
    }
  }
}

// Scales of cache slots [row0, row0 + kTileK) of one (b, kv head), 0 past
// `length` (those columns are masked).
__device__ __forceinline__ void load_scales(float* dst, const float* scales,
                                            const unsigned* rows, int row0, int length) {
  for (int c = threadIdx.x; c < kTileK; c += kThreads)
    dst[c] = row0 + c < length ? scales[rows[c]] : 0.f;
}

// The first design: one block per (q tile of tile_rows rows, kv head, batch
// row, piece). Per 64-slot cache tile: K and V are staged in shared memory as
// fp32, the block computes fp32 scores for its rows, masks with -1e30 (causal
// and window), and runs an online softmax (m, l, acc in fp32). With one piece
// it guards l == 0 to 1 at the end and writes the output in q's dtype, in the
// (B, S, N, H) layout of q; with more it writes its partials.
template <typename T, typename C, int H>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Problem p) {
  constexpr bool kInt8 = Int8Cache<C>::value;
  constexpr int kLdK = H + 1;                        // pad: conflict-free score reads
  constexpr int kRowStep = kThreads / H;             // rows apart in one thread's acc
  constexpr int kAccPerThread = kMaxRows / kRowStep;
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const C* k_cache = static_cast<const C*>(p.k_cache);
  const C* v_cache = static_cast<const C*>(p.v_cache);

  const int tile = blockIdx.x % p.tiles;
  const int piece = blockIdx.x / p.tiles;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.N / p.n_kv;
  const int total_rows = p.S * group;
  const int tile_rows = p.tile_rows;
  const int row0 = tile * tile_rows;
  const int rows = min(tile_rows, total_rows - row0);
  const int idx = p.index[b];
  const RowBounds bounds{idx, group, total_rows, p.length, p.window};

  extern __shared__ float smem[];
  unsigned* row_s = reinterpret_cast<unsigned*>(smem);  // kTileK cache rows
  float* q_s = smem + kTileK;                        // rows x H
  float* k_s = q_s + tile_rows * H;                  // kTileK x (H + 1)
  float* v_s = k_s + kTileK * kLdK;                  // kTileK x H
  float* p_s = v_s + kTileK * H;                     // rows x kTileK
  float* m_s = p_s + tile_rows * kTileK;             // rows
  float* l_s = m_s + tile_rows;                      // rows
  float* corr_s = l_s + tile_rows;                   // rows
  float* ks_s = corr_s + tile_rows;                  // kTileK (int8 only)
  float* vs_s = ks_s + kTileK;                       // kTileK (int8 only)

  const RowMap slots = row_map(p, b, kvh);
  // Cache span this tile needs: from the first query's window start to the
  // last query's causal frontier (never past the buffer); this block's piece.
  int first_col, last_col, unused;
  bounds(row0, first_col, unused);
  bounds(row0 + rows - 1, unused, last_col);
  int kt0, kt1;
  piece_tiles(first_col, last_col, p.splits, piece, kt0, kt1);
  fold_write<C, H>(p, slots, b, kvh, idx, kt0, kt1);

  // Query rows of this tile: row g = query (g / group), head (kvh * group +
  // g % group) -- q head n belongs to kv head n / group.
  for (int i = threadIdx.x; i < rows * H; i += kThreads) {
    const int r = i / H, d = i % H;
    q_s[r * H + d] = to_float(q[q_offset<H>(p, b, kvh, row0 + r) + d]) * p.scale;
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
  __syncthreads();

  for (int kt = kt0; kt < kt1; ++kt) {
    const int col0 = kt * kTileK;
    // The tile's cache rows, translated once (the previous iteration's last
    // __syncthreads has retired every read of row_s).
    for (int r = threadIdx.x; r < kTileK; r += kThreads)
      row_s[r] = col0 + r < p.length ? slots(col0 + r) : 0u;
    __syncthreads();
    load_tile<C, H, kLdK>(k_s, k_cache, row_s, col0, p.length);
    load_tile<C, H, H>(v_s, v_cache, row_s, col0, p.length);
    if (kInt8) {
      load_scales(ks_s, p.k_scale, row_s, col0, p.length);
      load_scales(vs_s, p.v_scale, row_s, col0, p.length);
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
      int lo, hi;
      bounds(row0 + r, lo, hi);
      const int col = col0 + c;
      p_s[r * kTileK + c] = col >= lo && col <= hi ? s : kNegInf;
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
      if (p.splits == 1) {
        const float l = l_s[r];
        from_float(static_cast<T*>(p.out) + q_offset<H>(p, b, kvh, row0 + r) + d_own,
                   acc[i] / (l == 0.f ? 1.f : l));
      } else {
        const size_t at = part_index(p, piece, b, kvh, row0 + r);
        p.part_acc[at * H + d_own] = acc[i];
        if (d_own == 0) {
          p.part_ml[2 * at] = m_s[r] * kLog2e;
          p.part_ml[2 * at + 1] = l_s[r];
        }
      }
    }
  }
}

size_t smem_bytes(int tile_rows, int h) {
  return sizeof(float) * ((size_t)kTileK + (size_t)tile_rows * h + (size_t)kTileK * (h + 1) +
                          (size_t)kTileK * h + (size_t)tile_rows * kTileK +
                          3 * (size_t)tile_rows + 2 * (size_t)kTileK);
}

// ------------------------------------------- CUDA cores, rows in registers

constexpr int kRowsThreads = 128;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kRowsMax = 4;       // folded rows the rows kernel takes

// Eight consecutive cache values: one 16-byte load of bf16, 8 bytes of int8,
// two 16-byte loads of fp32.
template <typename C>
struct alignas(sizeof(C) * 8 < 16 ? sizeof(C) * 8 : 16) Vec8 {
  C v[8];
};

// The token step's split: one block per (kv head, batch row, piece) of at
// most R folded rows. Lane (key, j) of a warp holds dims 8j .. 8j + 7 of one
// key row (H / 8 lanes a row, 32 / (H / 8) keys a warp step); each warp takes
// 16 keys of every 64-slot tile, and issues all their K and V loads before
// the first product. Scores: 8 FMAs a lane and a shuffle sum over the row's
// lanes, in log2 units (q carries scale * log2 e). Each key lane group keeps
// its own online softmax (m, l, acc) in registers; at the end the groups
// merge by shuffles, the warps through shared memory, and the block writes
// its partials.
template <typename T, typename C, int H, int R>
__global__ void __launch_bounds__(kRowsThreads) decode_attention_rows_kernel(const Problem p) {
  constexpr bool kInt8 = Int8Cache<C>::value;
  constexpr int kLanes = H / 8;                  // lanes a key row
  constexpr int kKeys = 32 / kLanes;             // keys a warp step
  constexpr int kWarpKeys = kTileK / kRowsWarps; // keys of a tile a warp takes
  constexpr int kSteps = kWarpKeys / kKeys;
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const C* k_cache = static_cast<const C*>(p.k_cache);
  const C* v_cache = static_cast<const C*>(p.v_cache);

  const int piece = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.N / p.n_kv, total = p.S * group;
  wait_prior_grid();
  const int idx = p.index[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = lane / kLanes, j = lane % kLanes;
  const RowBounds bounds{idx, group, total, p.length, p.window};

  int lo[R], hi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) bounds(r, lo[r], hi[r]);
  const int last_col = hi[R - 1];
  int kt0, kt1;
  piece_tiles(lo[0], last_col, p.splits, piece, kt0, kt1);
  const RowMap slots = row_map(p, b, kvh);
  fold_write<C, H>(p, slots, b, kvh, idx, kt0, kt1);
  __syncthreads();

  const float qscale = p.scale * kLog2e;
  float qv[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t off = r < total ? q_offset<H>(p, b, kvh, r) + 8 * j : 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[r][e] = r < total ? to_float(q[off + e]) * qscale : 0.f;
  }
  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int c_base = kt * kTileK + warp * kWarpKeys + key;
    Vec8<C> kr[kSteps], vr[kSteps];
    float ksc[kSteps], vsc[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int col = c_base + st * kKeys;
      if (col <= last_col) {
        const size_t row = slots(col);
        kr[st] = *reinterpret_cast<const Vec8<C>*>(k_cache + row * H + 8 * j);
        vr[st] = *reinterpret_cast<const Vec8<C>*>(v_cache + row * H + 8 * j);
        if (kInt8) {
          ksc[st] = p.k_scale[row];
          vsc[st] = p.v_scale[row];
        }
      } else {
        kr[st] = Vec8<C>{};
        vr[st] = Vec8<C>{};
        ksc[st] = vsc[st] = 0.f;
      }
    }
    float s[kSteps][R];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qv[r][e], to_float(kr[st].v[e]), d);
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[st][r] = kInt8 ? d * ksc[st] : d;          // k scale: the score column
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int col = c_base + st * kKeys;
        if (col < lo[r] || col > hi[r]) s[st][r] = kNegInf;
        mx = fmaxf(mx, s[st][r]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int col = c_base + st * kKeys;
        float pr = col >= lo[r] && col <= hi[r] ? exp2f(s[st][r] - m_new) : 0.f;
        l[r] += pr;                                  // l sums the unscaled p
        if (kInt8) pr *= vsc[st];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pr, to_float(vr[st].v[e]), acc[r][e]);
      }
    }
  }

  // Merge the warp's key lane groups, then the warps.
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float m_new = fmaxf(m[r], m_o);
      const float a = exp2f(m[r] - m_new), c = exp2f(m_o - m_new);
      l[r] = l[r] * a + l_o * c;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] = acc[r][e] * a + __shfl_xor_sync(0xffffffffu, acc[r][e], o) * c;
      m[r] = m_new;
    }
  }
  __shared__ float red_m[kRowsWarps][R], red_l[kRowsWarps][R], red_acc[kRowsWarps][R][H];
  if (key == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red_acc[warp][r][8 * j + e] = acc[r][e];
      if (j == 0) {
        red_m[warp][r] = m[r];
        red_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < min(total, R) * H; x += kRowsThreads) {
    const int r = x / H, d = x % H;
    float m_all = kNegInf;
#pragma unroll
    for (int w = 0; w < kRowsWarps; ++w) m_all = fmaxf(m_all, red_m[w][r]);
    float l_all = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kRowsWarps; ++w) {
      const float c = exp2f(red_m[w][r] - m_all);
      l_all += red_l[w][r] * c;
      a += red_acc[w][r][d] * c;
    }
    const size_t at = part_index(p, piece, b, kvh, r);
    p.part_acc[at * H + d] = a;
    if (d == 0) {
      p.part_ml[2 * at] = m_all;
      p.part_ml[2 * at + 1] = l_all;
    }
  }
  allow_next_grid();
}

// -------------------------------------------------------------- tensor cores

namespace tcd {

using namespace tc_prims;
using namespace tc_tiles;

constexpr int kWarps = 4;
constexpr int kTcThreads = 32 * kWarps;
constexpr int kTcRows = 16 * kWarps;   // folded q rows of a block

// Shared memory of the tensor-core design: the Q tile, then two stages of
// K and V -- bf16 tiles of BK rows as Tile<H> lays them out, or for int8
// caches the raw BK x H bytes of each and their BK k and v scales -- and,
// for int8, the K and V tiles widened to bf16.
template <typename C, int H, int BK>
struct TcLayout {
  static constexpr bool kInt8 = Int8Cache<C>::value;
  static constexpr int kSt = Tile<H>::kStride;
  static constexpr int kQ = kTcRows * kSt;
  static constexpr int kStage = kInt8 ? 2 * BK * H + 2 * BK * (int)sizeof(float) : 2 * BK * kSt;
  static constexpr int kWide = kInt8 ? 2 * BK * kSt : 0;
  static constexpr size_t kBytes = (size_t)kQ + 2 * kStage + kWide;
};

// Chunk rows on the tensor cores: one block per (64-row q tile, kv head,
// batch row, piece); warp w owns folded rows row0 + 16 w .. + 15, Q held in
// registers as A fragments (negated for a negative scale), and loops over
// the BK-slot tiles of its piece with K and V streamed through a 2-stage
// cp.async ring (slots past the span's last read as zeros; paged rows each
// through the table). S = Q K^T takes B from the K tile as it lies; int8: the
// score columns times their k scales. The online softmax runs on the C
// fragments in log2 units (flash_fwd_tc_kernel's): a row's columns lie in
// the 4 lanes t of one g. p is kept unrounded in l, times its v scale for
// int8, then rounded to bf16 A fragments for O += P V, which takes B from
// the V tile through ldmatrix.trans. Tiles none of a warp's rows attend are
// skipped, and the mask runs only on tiles that some row attends in part.
template <typename C, int H, int BK>
__global__ void __launch_bounds__(kTcThreads) decode_attention_tc_kernel(const Problem p) {
  using L = TcLayout<C, H, BK>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int St = L::kSt;
  constexpr int NT = BK / 8;
  constexpr int kSub = kTileK / BK;   // BK tiles a 64-slot tile
  const __nv_bfloat16* __restrict__ q = static_cast<const __nv_bfloat16*>(p.q);
  const C* k_cache = static_cast<const C*>(p.k_cache);
  const C* v_cache = static_cast<const C*>(p.v_cache);

  const int tile = blockIdx.x % p.tiles, piece = blockIdx.x / p.tiles;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.N / p.n_kv, total = p.S * group;
  const int row0 = tile * kTcRows;
  wait_prior_grid();
  const int idx = p.index[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const RowBounds bounds{idx, group, total, p.length, p.window};

  int first_col, last_col, unused;
  bounds(row0, first_col, unused);
  bounds(min(row0 + kTcRows, total) - 1, unused, last_col);
  int kt0, kt1;
  piece_tiles(first_col, last_col, p.splits, piece, kt0, kt1);
  const int n_sub = (kt1 - kt0) * kSub;
  const int c_first = kt0 * kTileK;

  extern __shared__ __align__(16) uint8_t smem_tc[];
  uint8_t* q_s = smem_tc;
  uint8_t* ring = q_s + L::kQ;
  uint8_t* wide = ring + 2 * L::kStage;

  const RowMap slots = row_map(p, b, kvh);
  fold_write<C, H>(p, slots, b, kvh, idx, kt0, kt1);
  __syncthreads();

  auto fetch = [&](int i) {
    uint8_t* st = ring + (i % 2) * L::kStage;
    const int c0 = c_first + i * BK;
    constexpr int kChunks = H * (int)sizeof(C) / 16;   // 16-byte copies a row
    for (int x = threadIdx.x; x < BK * kChunks; x += kTcThreads) {
      const int r = x / kChunks, c = x % kChunks;
      const bool in = c0 + r <= last_col;
      const size_t src = (size_t)(in ? slots(c0 + r) : 0u) * H + c * (16 / sizeof(C));
      if (kInt8) {
        cp_async16(st + r * H + c * 16, k_cache + src, in ? 16 : 0);
        cp_async16(st + (BK + r) * H + c * 16, v_cache + src, in ? 16 : 0);
      } else {
        cp_async16(st + r * St + c * 16, k_cache + src, in ? 16 : 0);
        cp_async16(st + (BK + r) * St + c * 16, v_cache + src, in ? 16 : 0);
      }
    }
    if (kInt8) {
      float* sc = reinterpret_cast<float*>(st + 2 * BK * H);
      for (int r = threadIdx.x; r < BK; r += kTcThreads) {
        const bool in = c0 + r <= last_col;
        const unsigned row = in ? slots(c0 + r) : 0u;
        cp_async4(sc + r, p.k_scale + row, in ? 4 : 0);
        cp_async4(sc + BK + r, p.v_scale + row, in ? 4 : 0);
      }
    }
  };
  for (int x = threadIdx.x; x < kTcRows * (H / 8); x += kTcThreads) {
    const int r = x / (H / 8), c = x % (H / 8);
    const bool in = row0 + r < total;
    cp_async16(q_s + r * St + c * 16, q + (in ? q_offset<H>(p, b, kvh, row0 + r) : 0) + c * 8,
               in ? 16 : 0);
  }
  cp_async_commit();
  if (n_sub > 0) fetch(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[H / 16][4];
  const uint32_t sign = p.scale < 0.f ? 0x80008000u : 0u;
#pragma unroll
  for (int ks = 0; ks < H / 16; ++ks) {
    load_a<H>(qf[ks], q_s, warp * 16, ks * 16);
#pragma unroll
    for (int r = 0; r < 4; ++r) qf[ks][r] ^= sign;
  }
  const float scale2 = fabsf(p.scale) * kLog2e;

  // Thread (g, t) holds rows r0 + g and r0 + g + 8 (h = 0, 1); the warp's
  // first and last rows bound which of its tiles need a mask.
  const int r0 = row0 + warp * 16;
  const bool live = r0 < total;
  int lo[2], hi[2], lo_first, hi_first, lo_last, hi_last;
  bounds(r0 + g, lo[0], hi[0]);
  bounds(r0 + g + 8, lo[1], hi[1]);
  bounds(r0, lo_first, hi_first);
  bounds(r0 + 15, lo_last, hi_last);
  float acc[H / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int i = 0; i < n_sub; ++i) {
    if (i + 1 < n_sub) fetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint8_t* st = ring + (i % 2) * L::kStage;
    const uint8_t* k_t = st;
    const float* ks_t = nullptr;
    const float* vs_t = nullptr;
    if constexpr (kInt8) {
      // Widen the stage's int8 K and V to bf16 tiles (|v| <= 127: exact).
      for (int x = threadIdx.x; x < 2 * BK * (H / 8); x += kTcThreads) {
        const int r = x / (H / 8), c = x % (H / 8);
        const uint2 raw = *reinterpret_cast<const uint2*>(st + r * H + c * 8);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&raw);
        const uint4 packed = {pack_bf16(v8[0], v8[1]), pack_bf16(v8[2], v8[3]),
                              pack_bf16(v8[4], v8[5]), pack_bf16(v8[6], v8[7])};
        *reinterpret_cast<uint4*>(wide + r * St + c * 16) = packed;
      }
      __syncthreads();
      k_t = wide;
      ks_t = reinterpret_cast<const float*>(st + 2 * BK * H);
      vs_t = ks_t + BK;
    }
    const uint8_t* v_t = k_t + BK * St;
    const int c0 = c_first + i * BK;
    if (live && c0 <= hi_last && c0 + BK - 1 >= lo_first) {
      float s[NT][4] = {};
      product_nk<H, NT>(s, qf, k_t);
      if constexpr (kInt8) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= ks_t[8 * j + 2 * t + (e & 1)];
      }
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
            const float pr = ex2(fmaf(s[j][e], scale2, neg_m[e >> 1]));
            s[j][e] = kept(j, e) ? pr : 0.f;
            l[e >> 1] += s[j][e];
          }
#pragma unroll
        for (int n = 0; n < H / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      };
      if (c0 >= lo_last && c0 + BK - 1 <= hi_first) {
        softmax(std::false_type{});
      } else {
        softmax(std::true_type{});
      }
      if constexpr (kInt8) {   // v scales weight P.V after l took p unscaled
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= vs_t[8 * j + 2 * t + (e & 1)];
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
    if (row < total) {
      if (p.splits == 1) {
        const float safe_l = sum == 0.f ? 1.f : sum;
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + q_offset<H>(p, b, kvh, row);
#pragma unroll
        for (int n = 0; n < H / 8; ++n)
          *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * t) =
              pack_bf16(acc[n][2 * h] / safe_l, acc[n][2 * h + 1] / safe_l);
      } else {
        const size_t at = part_index(p, piece, b, kvh, row);
#pragma unroll
        for (int n = 0; n < H / 8; ++n)
          *reinterpret_cast<float2*>(p.part_acc + at * H + 8 * n + 2 * t) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
        if (t == 0) {
          p.part_ml[2 * at] = m[h];
          p.part_ml[2 * at + 1] = sum;
        }
      }
    }
  }
  allow_next_grid();
}

}  // namespace tcd

// ------------------------------------------------------------------ combine

// Merge the pieces of each folded row in piece order: m the largest m of the
// pieces that saw a key (l > 0), l and acc their sums weighted by 2^(m_s -
// m); out = acc / l (l == 0 guarded to 1) in q's dtype, (B, S, N, H). One
// warp a row, lanes over H. Every piece writes its acc (zeros when empty),
// so all the pieces' loads are issued at once, before the first weight.
template <typename T, int H>
__global__ void __launch_bounds__(128) decode_attention_combine_kernel(const Problem p) {
  constexpr int kPerLane = H / 32;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int total = p.S * (p.N / p.n_kv);
  const int g = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  wait_prior_grid();
  if (g >= total) return;
  float m_s[kMaxSplits], l_s[kMaxSplits], a_s[kMaxSplits][kPerLane];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < p.splits) {
      const size_t at = part_index(p, s, b, kvh, g);
      m_s[s] = p.part_ml[2 * at];
      l_s[s] = p.part_ml[2 * at + 1];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) a_s[s][i] = p.part_acc[at * H + lane + 32 * i];
    }
  }
  float m_max = kNegInf;
  bool any = false;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < p.splits && l_s[s] > 0.f) {
      m_max = any ? fmaxf(m_max, m_s[s]) : m_s[s];
      any = true;
    }
  }
  float l = 0.f, acc[kPerLane] = {};
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < p.splits && l_s[s] > 0.f) {
      const float w = exp2f(m_s[s] - m_max);
      l += l_s[s] * w;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[i] += a_s[s][i] * w;
    }
  }
  T* o = static_cast<T*>(p.out) + q_offset<H>(p, b, kvh, g);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) from_float(o + lane + 32 * i, acc[i] / (l == 0.f ? 1.f : l));
}

// ------------------------------------------------------------------ launches

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Launch with programmatic stream serialization (see wait_prior_grid).
int launch_pdl(void (*kernel)(const Problem), dim3 grid, int threads, size_t smem,
               cudaStream_t stream, const Problem& p) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T, typename C, int H>
int launch_cuda_core(const Problem& p, cudaStream_t stream) {
  if (p.splits > 1 && p.S * (p.N / p.n_kv) <= kRowsMax) {
    dim3 grid(p.splits, p.n_kv, p.B);
    if (p.S * (p.N / p.n_kv) == 1)
      return launch_pdl(decode_attention_rows_kernel<T, C, H, 1>, grid, kRowsThreads, 0,
                        stream, p);
    return launch_pdl(decode_attention_rows_kernel<T, C, H, kRowsMax>, grid, kRowsThreads, 0,
                      stream, p);
  }
  auto kernel = decode_attention_kernel<T, C, H>;
  cudaError_t err = allow_smem(kernel, smem_bytes(kMaxRows, H));
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.splits * p.tiles, p.n_kv, p.B);
  kernel<<<grid, kThreads, smem_bytes(p.tile_rows, H), stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename C, int H>
int launch_tensor_core(const Problem& p, cudaStream_t stream) {
  constexpr int BK = H == 64 ? 64 : 32;
  auto kernel = tcd::decode_attention_tc_kernel<C, H, BK>;
  constexpr size_t smem = tcd::TcLayout<C, H, BK>::kBytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return launch_pdl(kernel, dim3(p.splits * p.tiles, p.n_kv, p.B), tcd::kTcThreads, smem,
                    stream, p);
}

template <typename T, int H>
int launch_combine(const Problem& p, cudaStream_t stream) {
  return launch_pdl(decode_attention_combine_kernel<T, H>,
                    dim3((p.S * (p.N / p.n_kv) + 3) / 4, p.n_kv, p.B), 128, 0, stream, p);
}

template <typename T, typename C, int H>
int launch(Problem p, int design, cudaStream_t stream) {
  const int total = p.S * (p.N / p.n_kv);
  int err;
  if (design == 1) {
    if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
      return -1;
    } else {
      p.tile_rows = tcd::kTcRows;
      p.tiles = (total + tcd::kTcRows - 1) / tcd::kTcRows;
      err = launch_tensor_core<C, H>(p, stream);
    }
  } else {
    p.tiles = (total + p.tile_rows - 1) / p.tile_rows;
    err = launch_cuda_core<T, C, H>(p, stream);
  }
  if (err != 0 || p.splits == 1) return err;
  return launch_combine<T, H>(p, stream);
}

}  // namespace

extern "C" {

// dtype (q, out): 0 = float32, 1 = bfloat16. quantized: the caches and k_new
// / v_new are int8 and the four scale pointers are given (ks_new / vs_new with
// the folded write); otherwise the caches are in dtype and the scales null.
// window <= 0: no window. k_new / v_new / write_enable may be null.
// block_table: null for per-row (B, N_kv, length, H) caches; otherwise the
// (B, T_blocks) int32 table over (P, N_kv, page, H) pools, with length =
// T_blocks * page the logical capacity. design: 0 = CUDA cores (tile_rows
// rows a q tile), 1 = tensor cores (bf16 q only, 64-row q tiles). splits:
// pieces of the cache span; above 1, `workspace` holds splits * B * N_kv *
// S * (N / N_kv) * (H + 2) floats of partials, and a second kernel merges
// them into `out`. Returns cudaGetLastError() after the launches; -1 for a
// head_dim, dtype, design, split, tile size or table this kernel does not
// take.
int decode_attention_launch(
    const void* q, void* k_cache, void* v_cache, const int* index,
    const void* k_new, const void* v_new, const int* write_enable, float* k_scale,
    float* v_scale, const float* ks_new, const float* vs_new, void* out,
    const int* block_table, float* workspace, int dtype, int quantized, int B, int S, int N,
    int n_kv, int length, int H, int window, float scale, int tile_rows, int T_blocks,
    int page, int design, int splits, void* stream) {
  if (tile_rows < 1 || tile_rows > kMaxRows) return -1;
  if (design != 0 && design != 1) return -1;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && workspace == nullptr)) return -1;
  if (block_table != nullptr && (page < 1 || T_blocks < 1 || length != T_blocks * page))
    return -1;
  if (quantized && (k_scale == nullptr || v_scale == nullptr ||
               (k_new != nullptr && (ks_new == nullptr || vs_new == nullptr))))
    return -1;
  const size_t parts = (size_t)splits * B * n_kv * S * (N / n_kv);
  const Problem p{q, k_cache, v_cache, index, k_new, v_new, write_enable, k_scale, v_scale,
                  ks_new, vs_new, out, workspace, workspace + 2 * parts, block_table,
                  B, S, N, n_kv, length, window > 0 ? window : 0, tile_rows, 1, splits,
                  T_blocks, page, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, C, HD) return launch<T, C, HD>(p, design, st)
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
