// Fused residual add + LayerNorm / RMSNorm for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernels learning_jax_sharding_tpu/ops/fused_norm.py
// ::_fwd_kernel (launched by _fwd there) and ::_bwd_kernel (launched by _bwd).
//
// Forward, per row of M features: s = x + resid in fp32; the new residual is
// s rounded to x's dtype; LayerNorm (centred two-pass variance: the mean
// first, then the mean of (s - mean)^2) or RMSNorm normalises the UNROUNDED
// fp32 s; y = xhat * gamma [+ beta] in fp32, written in x's dtype; optionally
// the fp32 mean (LayerNorm) and rstd of the row for the backward.
//
// Backward, per row: xhat is recomputed from the ROUNDED residual and the
// saved fp32 mean/rstd; dxhat = dy * gamma; c2 = mean(dxhat * xhat), c1 =
// mean(dxhat) (LayerNorm only); dx = rstd * (dxhat - c1 - xhat * c2), written
// in dy's dtype, then (when the residual output has a gradient) dx + dr in
// that dtype, as the JAX custom VJP adds them. dgamma = sum over rows of
// dy * xhat and dbeta = sum of dy, in fp32, cast to gamma's dtype.
//
// Bound on this card: bytes. At the 125M train shape (8192 x 768, bf16) the
// forward with a residual reads x and resid and writes y and the residual,
// 50.3 MB, about 15 us at 3.35 TB/s (H100 SXM); without one half of that.
// The backward reads dy and the residual and writes dx, 37.7 MB (50.3 with
// dr), about 11.3 us. At a decode step (8 rows) the bound is 0.01-0.02 us:
// there the time is one launch and one chain of dependent latencies.
//
// Two designs, picked before the launch (ops/fused_norm.py::_design).
//
// Design "row_group" (the public path). A row belongs to a row group of
// `threads` threads (a multiple of 32, at most 512); thread t of a group
// holds NV loads of VW elements: load c covers columns [(c * threads + t) *
// VW, + VW). VW is 16 bytes of T where M is a multiple of that (every row
// then starts 16-byte aligned), else one element (a row of odd width starts
// anywhere, and a per-row head would move each thread's columns from row to
// row). Either way a thread owns the same columns in every row, so it keeps
// its gamma, beta and column sums in its own slots of shared memory, which
// need no barrier (registers are what limits the blocks an SM holds). Row
// sums are warp shuffles (xor butterflies: every lane gets the same bits),
// then, past one warp, the warps' totals added in warp order through
// shared memory, double-buffered so that one barrier a sum suffices.
//
//   Forward: a block is one row group; the grid is min(rows, SMs x the
//   blocks an SM holds by the occupancy API), block b takes rows b, b +
//   grid, ...: the 8 rows of a decode step run on 8 SMs, the 8192 rows of a
//   train step stream through every resident block. A block's first row
//   loads are issued before gamma's and beta's, all as 16-byte vectors.
//   Where a thread holds at most kFwdHeld values, gamma and beta go to its
//   shared-memory slots once, and the next row's x and resid (without a
//   residual: the x of the next two rows) are in flight during this row's
//   sums; wider rows load their row where they use it and gamma/beta at the
//   output, from L2. The statistics are 8 bytes a row, written by thread 0:
//   neighbouring rows belong to neighbouring blocks and meet in the same L2
//   sector.
//
//   Backward, one launch: dx, dgamma and dbeta. A block holds `groups` row
//   groups (each with its own named barrier); group j of block b takes rows
//   b * groups + j, + grid * groups, ... and adds its columns' dy * xhat and
//   dy to its own fp32 column sums in shared memory. Where a thread holds at
//   most kBwdHeld values, gamma is in its slots, the next row's dy, r and dr
//   are in flight during this one, and the kernel keeps to 64 registers (two
//   blocks an SM); xhat and dxhat are recomputed after the row's sums rather
//   than kept (the same operations, the same bits). Then: the block adds its
//   groups' sums in group order; the blocks form clusters of up to 8 and
//   rank j of a cluster adds slice j of the columns over the cluster's
//   blocks through distributed shared memory in rank order, into a
//   workspace (clusters x 2M fp32); the last cluster to finish slice j (an
//   int32 counter a slice, one acquire-release add, left zero for the next
//   launch) adds the clusters' sums in cluster order, in contiguous runs
//   each summed in order and then the runs in order, and writes dgamma and
//   dbeta. The order is fixed by index, never by arrival: two launches on
//   the same inputs give the same bits. No float atomics.
//
// Rows past one pass of the widest row group (past 16384 features) take the
// wide kernels of the same design: the row in segments of that geometry,
// re-read once a pass; the backward's column sums split by segment over the
// grid's second dimension (see fused_norm_fwd_wide_kernel).
//
// Design "warp_row" (the first design, kept so that the two are checked and
// timed on the same inputs): one warp a row, up to 32 values a lane (M a
// multiple of 8 up to 1024), rows strided over a grid of up to 8 blocks an
// SM; the backward writes one fp32 partial row a block (a block an SM) and
// one or two more launches of fused_norm_warp_row_reduce_kernel sum them in
// a fixed order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename Fn>
cudaError_t set_smem(Fn kernel, size_t bytes) {
  // Up to 48 KB, less the kernels' static shared memory (under 1 KB), needs
  // no attribute.
  if (bytes <= 47 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// Design "row_group".

namespace rg {

constexpr int kMaxThreads = 512;       // threads a block
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxGroups = 8;          // row groups a backward block (named barriers 1-8)
constexpr int kMaxCluster = 8;         // blocks a cluster (the portable limit)
constexpr int kMaxM = 16384;           // one pass (the backward: 2M fp32 sums in shared
                                       // memory); wider rows take the wide kernels
constexpr int kFwdHeld = 16;           // forward: gamma/beta slots and prefetch up to this
constexpr int kBwdHeld = 8;            // backward: gamma slots and prefetch up to this
constexpr int kSmemLimit = 227 * 1024;

// VW elements of T as loaded: one 16-byte vector, or one element.
template <typename T, int VW>
struct Pack {
  static constexpr bool kVector = VW * sizeof(T) == 16;
  static_assert(kVector || VW == 1, "a load is 16 bytes or one element");
  using Word = typename std::conditional<kVector, uint4, T>::type;
  Word w;
  __device__ __forceinline__ void load(const T* p) {
    w = __ldg(reinterpret_cast<const Word*>(p));
  }
  __device__ __forceinline__ float operator[](int e) const {
    return to_float(reinterpret_cast<const T*>(&w)[e]);
  }
};

template <typename T, int VW>
__device__ __forceinline__ void store(T* p, const float* v) {
  using Word = typename Pack<T, VW>::Word;
  Word w;
  T* vals = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int e = 0; e < VW; ++e) vals[e] = from_float<T>(v[e]);
  *reinterpret_cast<Word*>(p) = w;
}

// The parameters of columns [col, col + VW) in fp32, from bf16 or fp32
// (bf16 != 0), in loads of up to 16 bytes.
template <int VW>
__device__ __forceinline__ void load_params(float* out, const void* src, bool bf16, int col) {
  if (bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(src) + col;
    if constexpr (VW == 8) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(v[e]);
    } else if constexpr (VW == 4) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = __bfloat162float(v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) out[e] = __bfloat162float(__ldg(p + e));
    }
  } else {
    const float* p = static_cast<const float*>(src) + col;
    if constexpr (VW % 4 == 0) {
#pragma unroll
      for (int q = 0; q < VW / 4; ++q) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(p) + q);
        out[4 * q] = w.x, out[4 * q + 1] = w.y, out[4 * q + 2] = w.z, out[4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) out[e] = __ldg(p + e);
    }
  }
}

// A thread's own parameters, kept in shared memory rather than registers
// (registers are what limits the blocks an SM holds): the VW values of its
// load c in 16-byte pieces, neighbouring threads on neighbouring pieces
// (piece (c * VW / 4 + q) * threads + t), or one float (c * threads + t).
// Only the thread that writes a slot reads it: no barrier.
template <int VW>
__device__ __forceinline__ void put_slot(float* s, int c, int t, int threads, const float* v) {
  if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VW / 4; ++q)
      reinterpret_cast<float4*>(s)[(c * (VW / 4) + q) * threads + t] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
    s[c * threads + t] = v[0];
  }
}

template <int VW>
__device__ __forceinline__ void get_slot(const float* s, int c, int t, int threads, float* v) {
  if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VW / 4; ++q) {
      const float4 w = reinterpret_cast<const float4*>(s)[(c * (VW / 4) + q) * threads + t];
      v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z, v[4 * q + 3] = w.w;
    }
  } else {
    v[0] = s[c * threads + t];
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// p[e] += v[e] for e < VW, in 16-byte pieces where VW allows (a thread's
// own columns: no other thread touches them while it adds).
template <int VW>
__device__ __forceinline__ void add_cols(float* p, const float* v) {
  if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VW / 4; ++q) {
      float4* at = reinterpret_cast<float4*>(p) + q;
      *at = add4(*at, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) p[e] = __fadd_rn(p[e], v[e]);
  }
}

__device__ __forceinline__ void group_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The sums of a (and b, kTwo) over a row group of `warps` warps: warp
// shuffles, then the warps' totals in warp order through `red` (the group's
// 2 x kMaxWarps float2; the half alternates with `parity`, so a warp that
// writes the next sum cannot overwrite what a slower warp still reads).
// Every thread of the group gets the same bits.
template <bool kTwo>
__device__ __forceinline__ float2 group_sum(float a, float b, float2* red, int& parity, int lane,
                                            int warp, int warps, int bar, int count) {
  a = warp_sum(a);
  if (kTwo) b = warp_sum(b);
  if (warps == 1) return make_float2(a, b);
  float2* half = red + parity * kMaxWarps;
  parity ^= 1;
  if (lane == 0) half[warp] = make_float2(a, b);
  group_barrier(bar, count);
  float2 s = half[0];
  for (int w = 1; w < warps; ++w) {
    const float2 o = half[w];
    s.x = __fadd_rn(s.x, o.x);
    if (kTwo) s.y = __fadd_rn(s.y, o.y);
  }
  return s;
}

template <typename T, int VW, int NV>
__global__ void __launch_bounds__(kMaxThreads) fused_norm_fwd_kernel(
    const void* __restrict__ x_, const void* __restrict__ resid_, const void* __restrict__ gamma,
    const void* __restrict__ beta, void* __restrict__ y_, void* __restrict__ r_out_,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows, int M, float eps,
    int layernorm, int param_bf16) {
  constexpr int N = VW * NV;
  constexpr bool kHeld = N <= kFwdHeld;
  const T* x = static_cast<const T*>(x_);
  const T* resid = static_cast<const T*>(resid_);
  T* y = static_cast<T*>(y_);
  T* r_out = static_cast<T*>(r_out_);
  __shared__ float2 red[2 * kMaxWarps];
  extern __shared__ float4 slots[];   // held: the threads' gamma, then beta
  const int t = threadIdx.x, threads = blockDim.x;
  const int lane = t % 32, warp = t / 32, warps = threads / 32;
  const bool pbf = param_bf16 != 0, has_res = resid != nullptr, has_beta = beta != nullptr;
  const float m = (float)M;
  float* gs = reinterpret_cast<float*>(slots);
  float* bs = gs + threads * N;
  int parity = 0;

  // xs: this row's x; rs: its residual, or (held, no residual) the x of the
  // row after the next, so that two rows are in flight either way.
  Pack<T, VW> xs[NV], rs[NV];
  auto fetch = [&](Pack<T, VW>* dst, const T* src, int row) {
    const size_t off = (size_t)row * M;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * threads + t) * VW;
      if (col < M) dst[c].load(src + off + col);
    }
  };

  // The first rows' loads go out before gamma's and beta's, whose trip to
  // shared memory then overlaps them.
  int row = blockIdx.x;
  if (kHeld && row < rows) {
    fetch(xs, x, row);
    if (has_res) fetch(rs, resid, row);
    else if (row + (int)gridDim.x < rows) fetch(rs, x, row + gridDim.x);
  }
  if constexpr (kHeld) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * threads + t) * VW;
      if (col < M) {
        float p[VW];
        load_params<VW>(p, gamma, pbf, col);
        put_slot<VW>(gs, c, t, threads, p);
        if (has_beta) {
          load_params<VW>(p, beta, pbf, col);
          put_slot<VW>(bs, c, t, threads, p);
        }
      }
    }
  }
  for (; row < rows; row += gridDim.x) {
    const size_t off = (size_t)row * M;
    if constexpr (!kHeld) {
      fetch(xs, x, row);
      if (has_res) fetch(rs, resid, row);
    }
    float v[N];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * threads + t) * VW;
#pragma unroll
      for (int e = 0; e < VW; ++e) v[c * VW + e] = col < M ? xs[c][e] : 0.f;
      if (has_res && col < M) {
#pragma unroll
        for (int e = 0; e < VW; ++e) v[c * VW + e] = __fadd_rn(v[c * VW + e], rs[c][e]);
        store<T, VW>(r_out + off + col, v + c * VW);   // rounded once
      }
    }
    const int next = row + gridDim.x;
    if constexpr (kHeld) {
      if (has_res) {
        if (next < rows) fetch(xs, x, next), fetch(rs, resid, next);
      } else {
#pragma unroll
        for (int c = 0; c < NV; ++c) xs[c] = rs[c];
        if (next + (int)gridDim.x < rows) fetch(rs, x, next + gridDim.x);
      }
    }
    // Statistics of the unrounded fp32 sum (zeros past M add nothing).
    float mean = 0.f;
    if (layernorm) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) s = __fadd_rn(s, v[i]);
      mean = __fdiv_rn(group_sum<false>(s, 0.f, red, parity, lane, warp, warps, 1, threads).x, m);
    }
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if ((c * threads + t) * VW < M) {
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float d = __fsub_rn(v[c * VW + e], mean);
          sq = __fadd_rn(sq, __fmul_rn(d, d));
        }
      }
    }
    const float var = group_sum<false>(sq, 0.f, red, parity, lane, warp, warps, 1, threads).x;
    const float rstd = 1.f / sqrtf(__fadd_rn(__fdiv_rn(var, m), eps));
    if (rstd_out != nullptr && t == 0) {
      if (layernorm) mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * threads + t) * VW;
      if (col < M) {
        float gc[VW], bc[VW], out[VW];
        if constexpr (kHeld) {
          get_slot<VW>(gs, c, t, threads, gc);
          if (has_beta) get_slot<VW>(bs, c, t, threads, bc);
        } else {
          load_params<VW>(gc, gamma, pbf, col);
          if (has_beta) load_params<VW>(bc, beta, pbf, col);
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float tt = __fmul_rn(__fmul_rn(__fsub_rn(v[c * VW + e], mean), rstd), gc[e]);
          out[e] = has_beta ? __fadd_rn(tt, bc[e]) : tt;
        }
        store<T, VW>(y + off + col, out);
      }
    }
  }
}

// Dynamic shared memory of a forward block: the held parameters.
__host__ __device__ inline size_t fwd_smem(int vec, int nv, int threads) {
  return vec * nv <= kFwdHeld ? (size_t)2 * threads * vec * nv * 4 : 0;
}

// Entries [i, i + 4) of the column sums [dgamma | dbeta | padding], written
// in the parameters' dtype.
__device__ __forceinline__ void write_sums(void* dgamma, void* dbeta, bool bf16, int M, int i,
                                           float4 v) {
  const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int j = i + e;
    void* dst = dgamma;
    if (j >= M) j -= M, dst = dbeta;
    if (dst == nullptr || j >= M) continue;
    if (bf16) static_cast<__nv_bfloat16*>(dst)[j] = __float2bfloat16(s[e]);
    else static_cast<float*>(dst)[j] = s[e];
  }
}

// Shared memory of a backward block: the groups' column sums (groups x A
// fp32, A = 2M rounded up to 32), the reduction halves (groups x 2 x
// kMaxWarps float2), the last cluster's runs (one float4 a thread) and,
// held, the threads' gamma (vec x nv floats a thread).
__host__ __device__ inline size_t bwd_smem(int M, int vec, int nv, int threads, int groups) {
  const size_t A = (size_t)(2 * M + 31) / 32 * 32, block = (size_t)groups * threads;
  return groups * A * 4 + (size_t)groups * 2 * kMaxWarps * 8 + block * 16 +
         (vec * nv <= kBwdHeld ? block * vec * nv * 4 : 0);
}

// The block's column sums acc ([dgamma | dbeta] of M columns, A floats)
// into dgamma / dbeta across the grid: rank j of the cluster adds slice j
// over the cluster's blocks in rank order; the last cluster to finish the
// slice adds the clusters' sums (ws: clusters x A) in cluster order. Called
// by every thread of the block after its sums are in acc.
__device__ __forceinline__ void reduce_column_sums(float* acc, int A, int M, float* __restrict__ ws,
                                                   int* __restrict__ counters, void* dgamma,
                                                   void* dbeta, bool pbf, float4* runs_out,
                                                   int& last) {
  // Rank j of the cluster adds slice j of [dgamma | dbeta] over its blocks
  // in rank order; the last cluster to finish the slice adds the clusters'
  // sums in cluster order.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int csize = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int clusters = gridDim.x / csize, cl = blockIdx.x / csize;
  const int width = A / csize, quads = width / 4, lo = rank * width;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const int i = lo + 4 * q;
    float4 o[kMaxCluster];   // every rank's load issued before the first add
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < csize) o[j] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(acc, j) + i);
    float4 v = o[0];
#pragma unroll
    for (int j = 1; j < kMaxCluster; ++j)
      if (j < csize) v = add4(v, o[j]);
    if (clusters == 1) write_sums(dgamma, dbeta, pbf, M, i, v);
    else *reinterpret_cast<float4*>(ws + (size_t)cl * A + i) = v;
  }
  // Done reading the others' sums: tell the cluster, go on, and wait before
  // exiting, so that no block leaves while another still reads its sums.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (clusters > 1) {
    // The block's slice sums, then one acquire-release add by thread 0:
    // cumulative over the writes the barrier ordered before it, and the last
    // cluster's thread 0 then sees every cluster's sums, as its block does
    // after the next barrier.
    __syncthreads();
    if (threadIdx.x == 0) {
      int ticket;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
                   : "=r"(ticket) : "l"(counters + rank), "r"(1) : "memory");
      last = ticket == clusters - 1;
    }
    __syncthreads();
    if (last) {
      const int nruns = max(1, min(clusters, (int)blockDim.x / quads));
      const int per = (clusters + nruns - 1) / nruns;
      // Clusters j0 .. j1 - 1 in order, loaded kMaxCluster at a time.
      auto run_sum = [&](int q, int j0, int j1) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = j0; j < j1; j += kMaxCluster) {
          float4 o[kMaxCluster];
#pragma unroll
          for (int k = 0; k < kMaxCluster; ++k)
            if (j + k < j1)
              o[k] = __ldcg(reinterpret_cast<const float4*>(ws + (size_t)(j + k) * A + lo) + q);
#pragma unroll
          for (int k = 0; k < kMaxCluster; ++k)
            if (j + k < j1) v = j + k == j0 ? o[k] : add4(v, o[k]);
        }
        return v;
      };
      if (nruns == 1) {
        for (int q = threadIdx.x; q < quads; q += blockDim.x)
          write_sums(dgamma, dbeta, pbf, M, lo + 4 * q, run_sum(q, 0, clusters));
      } else {
        const int k = threadIdx.x;
        if (k < nruns * quads) {
          const int run = k / quads, q = k % quads;
          runs_out[k] = run_sum(q, run * per, min(clusters, (run + 1) * per));
        }
        __syncthreads();
        if (k < quads) {
          float4 v = runs_out[k];
          for (int run = 1; run < nruns; ++run) v = add4(v, runs_out[run * quads + k]);
          write_sums(dgamma, dbeta, pbf, M, lo + 4 * k, v);
        }
      }
      if (threadIdx.x == 0) counters[rank] = 0;   // ready for the next launch
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int VW, int NV>
__global__ void __launch_bounds__(kMaxThreads, VW * NV <= kBwdHeld ? 2 : 1) fused_norm_bwd_kernel(
    const void* __restrict__ dy_, const void* __restrict__ r_, const void* __restrict__ gamma,
    const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
    const void* __restrict__ dr_, void* __restrict__ dx_, float* __restrict__ ws,
    int* __restrict__ counters, void* __restrict__ dgamma, void* __restrict__ dbeta, int rows,
    int M, int threads, int layernorm, int param_bf16) {
  constexpr int N = VW * NV;
  constexpr bool kHeld = N <= kBwdHeld;
  const T* dy = static_cast<const T*>(dy_);
  const T* r = static_cast<const T*>(r_);
  const T* dr = static_cast<const T*>(dr_);
  T* dx = static_cast<T*>(dx_);
  extern __shared__ float4 smem[];
  __shared__ int last;
  const int A = (2 * M + 31) / 32 * 32;
  const int groups = blockDim.x / threads;
  const int grp = threadIdx.x / threads, t = threadIdx.x % threads;
  const int lane = t % 32, warp = t / 32, warps = threads / 32;
  float* acc = reinterpret_cast<float*>(smem);                                 // groups x A
  float2* red = reinterpret_cast<float2*>(acc + (size_t)groups * A) + grp * 2 * kMaxWarps;
  float4* runs_out = reinterpret_cast<float4*>(
      reinterpret_cast<float2*>(acc + (size_t)groups * A) + groups * 2 * kMaxWarps);
  float* gs = reinterpret_cast<float*>(runs_out + blockDim.x) + (size_t)grp * threads * N;
  const bool pbf = param_bf16 != 0, has_dr = dr != nullptr;
  const float m = (float)M;
  int parity = 0;

  // Held: this row's dy / r / dr as loaded, and the next row's, in flight
  // during this one. Otherwise the loads are issued where they are used
  // (twice a row: the second from L1 or L2), which keeps wide rows' values
  // out of registers. Either way xhat and dxhat are recomputed after the
  // row's sums rather than kept: the same operations, the same bits, and
  // fewer registers (held: at most 64, two blocks an SM).
  constexpr int H = kHeld ? NV : 1;
  Pack<T, VW> cur_dy[H], cur_r[H], cur_dr[H], nxt_dy[H], nxt_r[H], nxt_dr[H];
  float cur_mu = 0.f, cur_rs = 0.f, nxt_mu = 0.f, nxt_rs = 0.f;
  auto fetch = [&](Pack<T, VW>* pdy, Pack<T, VW>* pr, Pack<T, VW>* pdr, float& pmu,
                   float& prs, int row) {
    const size_t off = (size_t)row * M;
#pragma unroll
    for (int c = 0; c < H; ++c) {
      const int col = (c * threads + t) * VW;
      if (col < M) {
        pdy[c].load(dy + off + col);
        pr[c].load(r + off + col);
        if (has_dr) pdr[c].load(dr + off + col);
      }
    }
    prs = __ldg(rstd_in + row);
    if (layernorm) pmu = __ldg(mean_in + row);
  };
  // Load c of this row: dy and r as floats (from the held loads, or now).
  auto raw = [&](int c, size_t off, int col, float* dyv, float* rv) {
    if constexpr (kHeld) {
#pragma unroll
      for (int e = 0; e < VW; ++e) dyv[e] = cur_dy[c][e], rv[e] = cur_r[c][e];
    } else {
      Pack<T, VW> a, b;
      a.load(dy + off + col);
      b.load(r + off + col);
#pragma unroll
      for (int e = 0; e < VW; ++e) dyv[e] = a[e], rv[e] = b[e];
    }
  };

  // The first row's loads go out before gamma's, then the sums are zeroed.
  const int step = gridDim.x * groups;
  int row = blockIdx.x * groups + grp;
  if (kHeld && row < rows) fetch(cur_dy, cur_r, cur_dr, cur_mu, cur_rs, row);
  if constexpr (kHeld) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * threads + t) * VW;
      if (col < M) {
        float p[VW];
        load_params<VW>(p, gamma, pbf, col);
        put_slot<VW>(gs, c, t, threads, p);
      }
    }
  }
  for (int i = threadIdx.x; i < groups * A; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  float* mine = acc + (size_t)grp * A;   // this group's [dgamma | dbeta] sums
  for (; row < rows; row += step) {
    const size_t off = (size_t)row * M;
    float mean, rstd;
    if constexpr (kHeld) {
      mean = cur_mu, rstd = cur_rs;
      if (row + step < rows) fetch(nxt_dy, nxt_r, nxt_dr, nxt_mu, nxt_rs, row + step);
    } else {
      rstd = __ldg(rstd_in + row);
      mean = layernorm ? __ldg(mean_in + row) : 0.f;
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * threads + t) * VW;
      if (col < M) {
        float dyv[VW], rv[VW], gc[VW], pg[VW];
        raw(c, off, col, dyv, rv);
        if constexpr (kHeld) get_slot<VW>(gs, c, t, threads, gc);
        else load_params<VW>(gc, gamma, pbf, col);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xh = __fmul_rn(__fsub_rn(rv[e], mean), rstd);
          const float dxh = __fmul_rn(dyv[e], gc[e]);
          pg[e] = __fmul_rn(dyv[e], xh);
          s1 = __fadd_rn(s1, dxh);
          s2 = __fadd_rn(s2, __fmul_rn(dxh, xh));
        }
        add_cols<VW>(mine + col, pg);
        add_cols<VW>(mine + M + col, dyv);
      }
    }
    const float2 sums = group_sum<true>(s1, s2, red, parity, lane, warp, warps, 1 + grp, threads);
    const float c1 = layernorm ? __fdiv_rn(sums.x, m) : 0.f;
    const float c2 = __fdiv_rn(sums.y, m);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * threads + t) * VW;
      if (col < M) {
        float dyv[VW], rv[VW], gc[VW], drv[VW], out[VW];
        raw(c, off, col, dyv, rv);
        if constexpr (kHeld) get_slot<VW>(gs, c, t, threads, gc);
        else load_params<VW>(gc, gamma, pbf, col);
        if (has_dr) {
          if constexpr (kHeld) {
#pragma unroll
            for (int e = 0; e < VW; ++e) drv[e] = cur_dr[c][e];
          } else {
            Pack<T, VW> a;
            a.load(dr + off + col);
#pragma unroll
            for (int e = 0; e < VW; ++e) drv[e] = a[e];
          }
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xh = __fmul_rn(__fsub_rn(rv[e], mean), rstd);
          const float dxh = __fmul_rn(dyv[e], gc[e]);
          const float tt = __fsub_rn(__fsub_rn(dxh, c1), __fmul_rn(xh, c2));
          out[e] = to_float(from_float<T>(__fmul_rn(rstd, tt)));   // dx in dy's dtype
          if (has_dr) out[e] = __fadd_rn(out[e], drv[e]);
        }
        store<T, VW>(dx + off + col, out);
      }
    }
    if constexpr (kHeld) {
#pragma unroll
      for (int c = 0; c < H; ++c) cur_dy[c] = nxt_dy[c], cur_r[c] = nxt_r[c], cur_dr[c] = nxt_dr[c];
      cur_mu = nxt_mu, cur_rs = nxt_rs;
    }
  }

  // The block's sums: its groups' in group order, into group 0's.
  __syncthreads();
  if (groups > 1) {
    for (int i = threadIdx.x; i < A; i += blockDim.x) {
      float s = acc[i];
      for (int j = 1; j < groups; ++j) s = __fadd_rn(s, acc[(size_t)j * A + i]);
      acc[i] = s;
    }
  }

  reduce_column_sums(acc, A, M, ws, counters, dgamma, dbeta, pbf, runs_out, last);
}

// Rows wider than one pass of a row group (M past kMaxM, or one-element
// loads past 512 x 32): the widest geometry (512 threads, the most loads a
// thread) covers a segment of seg = threads x VW x NV columns, and a row is
// `passes` segments. Nothing is held: every pass loads where it uses.
//
// Forward: three passes over the row, each recomputing s = x + resid from
// the loads (the same operations, the same bits): the sum (and the rounded
// residual, written once), the centred squares, the output.
template <typename T, int VW, int NV>
__global__ void __launch_bounds__(kMaxThreads) fused_norm_fwd_wide_kernel(
    const void* __restrict__ x_, const void* __restrict__ resid_, const void* __restrict__ gamma,
    const void* __restrict__ beta, void* __restrict__ y_, void* __restrict__ r_out_,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows, int M, float eps,
    int layernorm, int param_bf16, int passes) {
  const T* x = static_cast<const T*>(x_);
  const T* resid = static_cast<const T*>(resid_);
  T* y = static_cast<T*>(y_);
  T* r_out = static_cast<T*>(r_out_);
  __shared__ float2 red[2 * kMaxWarps];
  const int t = threadIdx.x, threads = blockDim.x;
  const int lane = t % 32, warp = t / 32, warps = threads / 32;
  const int seg = threads * VW * NV;
  const bool pbf = param_bf16 != 0, has_res = resid != nullptr, has_beta = beta != nullptr;
  const float m = (float)M;
  int parity = 0;
  // s = x + resid of the VW columns at col, in fp32.
  auto sum_at = [&](size_t off, int col, float* v) {
    Pack<T, VW> a;
    a.load(x + off + col);
#pragma unroll
    for (int e = 0; e < VW; ++e) v[e] = a[e];
    if (has_res) {
      Pack<T, VW> b;
      b.load(resid + off + col);
#pragma unroll
      for (int e = 0; e < VW; ++e) v[e] = __fadd_rn(v[e], b[e]);
    }
  };
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = (size_t)row * M;
    float s = 0.f;
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = p * seg + (c * threads + t) * VW;
        if (col < M) {
          float v[VW];
          sum_at(off, col, v);
          if (has_res) store<T, VW>(r_out + off + col, v);   // rounded once
#pragma unroll
          for (int e = 0; e < VW; ++e) s = __fadd_rn(s, v[e]);
        }
      }
    }
    float mean = 0.f;
    if (layernorm)
      mean = __fdiv_rn(group_sum<false>(s, 0.f, red, parity, lane, warp, warps, 1, threads).x, m);
    float sq = 0.f;
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = p * seg + (c * threads + t) * VW;
        if (col < M) {
          float v[VW];
          sum_at(off, col, v);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const float d = __fsub_rn(v[e], mean);
            sq = __fadd_rn(sq, __fmul_rn(d, d));
          }
        }
      }
    }
    const float var = group_sum<false>(sq, 0.f, red, parity, lane, warp, warps, 1, threads).x;
    const float rstd = 1.f / sqrtf(__fadd_rn(__fdiv_rn(var, m), eps));
    if (rstd_out != nullptr && t == 0) {
      if (layernorm) mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = p * seg + (c * threads + t) * VW;
        if (col < M) {
          float v[VW], gc[VW], bc[VW], out[VW];
          sum_at(off, col, v);
          load_params<VW>(gc, gamma, pbf, col);
          if (has_beta) load_params<VW>(bc, beta, pbf, col);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const float tt = __fmul_rn(__fmul_rn(__fsub_rn(v[e], mean), rstd), gc[e]);
            out[e] = has_beta ? __fadd_rn(tt, bc[e]) : tt;
          }
          store<T, VW>(y + off + col, out);
        }
      }
    }
  }
}

// Shared memory of a wide backward block: one segment's column sums (A =
// 2 seg rounded up to 32), the reduction halves and the last cluster's runs.
__host__ __device__ inline size_t bwd_wide_smem(int seg, int threads) {
  return (size_t)(2 * seg + 31) / 32 * 32 * 4 + 2 * kMaxWarps * 8 + (size_t)threads * 16;
}

// Backward: the grid's second dimension takes the column slices, one
// segment each (slice y: columns [y seg, (y + 1) seg)). A block of slice y
// takes rows blockIdx.x, + gridDim.x, ...: for each it sums dxhat and dxhat
// * xhat over the whole row (every pass), then writes dx of its slice's
// columns and adds their dy * xhat and dy to its shared-memory sums; the
// slice's sums then meet across the blocks of its row (clusters along x) as
// in the one-pass kernel, into its own part of ws and its own counters.
template <typename T, int VW, int NV>
__global__ void __launch_bounds__(kMaxThreads) fused_norm_bwd_wide_kernel(
    const void* __restrict__ dy_, const void* __restrict__ r_, const void* __restrict__ gamma,
    const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
    const void* __restrict__ dr_, void* __restrict__ dx_, float* __restrict__ ws,
    int* __restrict__ counters, void* __restrict__ dgamma, void* __restrict__ dbeta, int rows,
    int M, int threads, int layernorm, int param_bf16, int passes) {
  const T* dy = static_cast<const T*>(dy_);
  const T* r = static_cast<const T*>(r_);
  const T* dr = static_cast<const T*>(dr_);
  T* dx = static_cast<T*>(dx_);
  extern __shared__ float4 smem[];
  __shared__ int last;
  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32, warps = threads / 32;
  const int seg = threads * VW * NV, A = (2 * seg + 31) / 32 * 32;
  const int c0 = blockIdx.y * seg, Ms = min(seg, M - c0);
  float* acc = reinterpret_cast<float*>(smem);
  float2* red = reinterpret_cast<float2*>(acc + A);
  float4* runs_out = reinterpret_cast<float4*>(red + 2 * kMaxWarps);
  const bool pbf = param_bf16 != 0, has_dr = dr != nullptr;
  const float m = (float)M;
  int parity = 0;
  auto raw = [&](size_t off, int col, float* dyv, float* rv) {
    Pack<T, VW> a, b;
    a.load(dy + off + col);
    b.load(r + off + col);
#pragma unroll
    for (int e = 0; e < VW; ++e) dyv[e] = a[e], rv[e] = b[e];
  };
  for (int i = t; i < A; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = (size_t)row * M;
    const float rstd = __ldg(rstd_in + row);
    const float mean = layernorm ? __ldg(mean_in + row) : 0.f;
    float s1 = 0.f, s2 = 0.f;
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = p * seg + (c * threads + t) * VW;
        if (col < M) {
          float dyv[VW], rv[VW], gc[VW];
          raw(off, col, dyv, rv);
          load_params<VW>(gc, gamma, pbf, col);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const float xh = __fmul_rn(__fsub_rn(rv[e], mean), rstd);
            const float dxh = __fmul_rn(dyv[e], gc[e]);
            s1 = __fadd_rn(s1, dxh);
            s2 = __fadd_rn(s2, __fmul_rn(dxh, xh));
          }
        }
      }
    }
    const float2 sums = group_sum<true>(s1, s2, red, parity, lane, warp, warps, 1, threads);
    const float c1 = layernorm ? __fdiv_rn(sums.x, m) : 0.f;
    const float c2 = __fdiv_rn(sums.y, m);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int lc = (c * threads + t) * VW, col = c0 + lc;
      if (lc < Ms) {
        float dyv[VW], rv[VW], gc[VW], drv[VW], pg[VW], out[VW];
        raw(off, col, dyv, rv);
        load_params<VW>(gc, gamma, pbf, col);
        if (has_dr) {
          Pack<T, VW> a;
          a.load(dr + off + col);
#pragma unroll
          for (int e = 0; e < VW; ++e) drv[e] = a[e];
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xh = __fmul_rn(__fsub_rn(rv[e], mean), rstd);
          const float dxh = __fmul_rn(dyv[e], gc[e]);
          pg[e] = __fmul_rn(dyv[e], xh);
          const float tt = __fsub_rn(__fsub_rn(dxh, c1), __fmul_rn(xh, c2));
          out[e] = to_float(from_float<T>(__fmul_rn(rstd, tt)));   // dx in dy's dtype
          if (has_dr) out[e] = __fadd_rn(out[e], drv[e]);
        }
        store<T, VW>(dx + off + col, out);
        add_cols<VW>(acc + lc, pg);
        add_cols<VW>(acc + Ms + lc, dyv);
      }
    }
  }
  __syncthreads();
  const size_t pbytes = pbf ? 2 : 4;
  const int clusters = gridDim.x / (int)cg::this_cluster().num_blocks();
  reduce_column_sums(acc, A, Ms, ws + (size_t)blockIdx.y * clusters * A,
                     counters + blockIdx.y * kMaxCluster,
                     static_cast<char*>(dgamma) + c0 * pbytes,
                     dbeta == nullptr ? nullptr : static_cast<char*>(dbeta) + c0 * pbytes, pbf,
                     runs_out, last);
}

// The instantiations: 16-byte loads (bf16 up to 4 a thread, fp32 up to 8:
// M <= 16384 at 512 threads a row), and one-element loads for widths that
// are not a multiple of 16 bytes (up to 32 a thread).
using FwdFn = void (*)(const void*, const void*, const void*, const void*, void*, void*, float*,
                       float*, int, int, float, int, int);
using BwdFn = void (*)(const void*, const void*, const void*, const float*, const float*,
                       const void*, void*, float*, int*, void*, void*, int, int, int, int, int);

template <bool kFwd, typename T, int VW>
auto pick_nv(int nv) -> typename std::conditional<kFwd, FwdFn, BwdFn>::type {
  using Fn = typename std::conditional<kFwd, FwdFn, BwdFn>::type;
#define NV_CASE(n)                                                                           \
  if (nv == n) {                                                                             \
    if constexpr (kFwd) return reinterpret_cast<Fn>(fused_norm_fwd_kernel<T, VW, n>);        \
    else return reinterpret_cast<Fn>(fused_norm_bwd_kernel<T, VW, n>);                       \
  }
  if constexpr (VW == 1) {
    NV_CASE(1) NV_CASE(4) NV_CASE(32)
  } else if constexpr (sizeof(T) == 2) {
    NV_CASE(1) NV_CASE(2) NV_CASE(4)
  } else {
    NV_CASE(1) NV_CASE(2) NV_CASE(4) NV_CASE(8)
  }
#undef NV_CASE
  return nullptr;
}

// The wide kernels: the widest geometry of each load width only.
using FwdWideFn = void (*)(const void*, const void*, const void*, const void*, void*, void*,
                           float*, float*, int, int, float, int, int, int);
using BwdWideFn = void (*)(const void*, const void*, const void*, const float*, const float*,
                           const void*, void*, float*, int*, void*, void*, int, int, int, int,
                           int, int);

template <bool kFwd>
auto pick_wide(int dtype, int vec, int nv)
    -> typename std::conditional<kFwd, FwdWideFn, BwdWideFn>::type {
  using Fn = typename std::conditional<kFwd, FwdWideFn, BwdWideFn>::type;
#define WIDE_CASE(D, T, V, N)                                                                \
  if (dtype == D && vec == V && nv == N) {                                                   \
    if constexpr (kFwd) return reinterpret_cast<Fn>(fused_norm_fwd_wide_kernel<T, V, N>);    \
    else return reinterpret_cast<Fn>(fused_norm_bwd_wide_kernel<T, V, N>);                   \
  }
  WIDE_CASE(0, float, 4, 8) WIDE_CASE(0, float, 1, 32)
  WIDE_CASE(1, __nv_bfloat16, 8, 4) WIDE_CASE(1, __nv_bfloat16, 1, 32)
#undef WIDE_CASE
  return nullptr;
}

// A wide geometry: 512 threads, `passes` > 1 segments covering M.
bool wide_ok(int dtype, int M, int vec, int nv, int threads, int passes) {
  const int full = dtype == 0 ? 4 : 8;
  const long seg = (long)threads * vec * nv;
  return passes > 1 && threads == kMaxThreads && (vec == full || vec == 1) && M % vec == 0 &&
         seg * (passes - 1) < M && seg * passes >= M;
}

template <bool kFwd>
auto pick(int dtype, int vec, int nv) -> typename std::conditional<kFwd, FwdFn, BwdFn>::type {
  if (dtype == 0 && vec == 4) return pick_nv<kFwd, float, 4>(nv);
  if (dtype == 0 && vec == 1) return pick_nv<kFwd, float, 1>(nv);
  if (dtype == 1 && vec == 8) return pick_nv<kFwd, __nv_bfloat16, 8>(nv);
  if (dtype == 1 && vec == 1) return pick_nv<kFwd, __nv_bfloat16, 1>(nv);
  return nullptr;
}

// What both kernels take: a width up to kMaxM that the loads divide, and a
// row group of whole warps, up to kMaxThreads, covering a row.
bool geometry_ok(int dtype, int M, int vec, int nv, int threads) {
  const int full = dtype == 0 ? 4 : 8;
  return M >= 1 && M <= kMaxM && (vec == full || vec == 1) && M % vec == 0 && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0 && (long)threads * vec * nv >= M;
}

cudaLaunchConfig_t bwd_config(int blocks, int block_threads, size_t smem, int cluster,
                              cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(block_threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace rg

// ---------------------------------------------------------------------------
// Design "warp_row" (the first design).

namespace wr {

constexpr int kWarps = 8;                 // rows in flight per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPerLane = 32;           // values a lane holds: M <= 1024
constexpr int kMaxM = 32 * kMaxPerLane;
constexpr int kFwdBlocksPerSm = 8;        // rows loop past this many blocks an SM
constexpr int kReduceSlices = 8;          // partial slices per column

// One 16-byte vector of T to fp32, and back.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int V = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = to_float(vals[e]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  constexpr int V = 16 / sizeof(T);
  uint4 raw;
  T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < V; ++e) vals[e] = from_float<T>(in[e]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// gamma / beta values of this lane's vectors, in fp32 (zeros past M, or
// where the pointer is null).
template <typename T, typename P>
__device__ __forceinline__ void load_params(float* dst, const P* src, int lane, int nvec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = kMaxPerLane / V;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int vi = c * 32 + lane;
#pragma unroll
    for (int e = 0; e < V; ++e)
      dst[c * V + e] = (src != nullptr && vi < nvec) ? to_float(src[vi * V + e]) : 0.f;
  }
}

template <typename T, typename P, bool kLayerNorm, bool kStats>
__global__ void __launch_bounds__(kThreads) fused_norm_warp_row_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ resid, const P* __restrict__ gamma,
    const P* __restrict__ beta, T* __restrict__ y, T* __restrict__ r_out,
    float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows, int M, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = kMaxPerLane / V;
  const int lane = threadIdx.x % 32;
  const int nvec = M / V;
  const float m = (float)M;

  float g[kMaxPerLane], b[kMaxPerLane];
  load_params<T>(g, gamma, lane, nvec);
  load_params<T>(b, beta, lane, nvec);

  for (int row = blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += gridDim.x * kWarps) {
    const size_t off = (size_t)row * M;
    float v[kMaxPerLane];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int vi = c * 32 + lane;
      if (vi < nvec) {
        load_vec(x + off + (size_t)vi * V, v + c * V);
        if (resid != nullptr) {
          float rv[V];
          load_vec(resid + off + (size_t)vi * V, rv);
#pragma unroll
          for (int e = 0; e < V; ++e) v[c * V + e] = __fadd_rn(v[c * V + e], rv[e]);
          store_vec(r_out + off + (size_t)vi * V, v + c * V);   // rounded once
        }
      }
    }
    // Statistics of the unrounded fp32 sum.
    float mean = 0.f, sq = 0.f;
    if (kLayerNorm) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c * 32 + lane < nvec) {
#pragma unroll
          for (int e = 0; e < V; ++e) s += v[c * V + e];
        }
      mean = __fdiv_rn(warp_sum(s), m);
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c * 32 + lane < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = __fsub_rn(v[c * V + e], mean);
          sq = __fadd_rn(sq, __fmul_rn(d, d));
        }
      }
    const float rstd = 1.f / sqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), m), eps));
    if (kStats && lane == 0) {
      if (kLayerNorm) mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int vi = c * 32 + lane;
      if (vi < nvec) {
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int i = c * V + e;
          float t = __fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), rstd), g[i]);
          out[e] = beta != nullptr ? __fadd_rn(t, b[i]) : t;
        }
        store_vec(y + off + (size_t)vi * V, out);
      }
    }
  }
}

template <typename T, typename P, bool kLayerNorm>
__global__ void __launch_bounds__(kThreads) fused_norm_warp_row_bwd_kernel(
    const T* __restrict__ dy, const T* __restrict__ r, const P* __restrict__ gamma,
    const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
    const T* __restrict__ dr, T* __restrict__ dx, float* __restrict__ part_g,
    float* __restrict__ part_b, int rows, int M) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = kMaxPerLane / V;
  __shared__ float acc_g[kMaxM];
  __shared__ float acc_b[kMaxM];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nvec = M / V;
  const float m = (float)M;

  float g[kMaxPerLane], dg[kMaxPerLane], db[kMaxPerLane];
  load_params<T>(g, gamma, lane, nvec);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) dg[i] = db[i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t off = (size_t)row * M;
    const float rstd = rstd_in[row];
    const float mean = kLayerNorm ? mean_in[row] : 0.f;
    float d[kMaxPerLane], xh[kMaxPerLane];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c * 32 + lane < nvec) {
        const size_t at = off + (size_t)(c * 32 + lane) * V;
        load_vec(dy + at, d + c * V);
        load_vec(r + at, xh + c * V);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int i = c * V + e;
          xh[i] = __fmul_rn(__fsub_rn(xh[i], mean), rstd);
          dg[i] = __fadd_rn(dg[i], __fmul_rn(d[i], xh[i]));
          db[i] = __fadd_rn(db[i], d[i]);
          d[i] = __fmul_rn(d[i], g[i]);                 // dxhat
          s1 = __fadd_rn(s1, d[i]);
          s2 = __fadd_rn(s2, __fmul_rn(d[i], xh[i]));
        }
      }
    }
    const float c1 = kLayerNorm ? __fdiv_rn(warp_sum(s1), m) : 0.f;
    const float c2 = __fdiv_rn(warp_sum(s2), m);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c * 32 + lane < nvec) {
        const size_t at = off + (size_t)(c * 32 + lane) * V;
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int i = c * V + e;
          const float t = __fsub_rn(__fsub_rn(d[i], c1), __fmul_rn(xh[i], c2));
          out[e] = to_float(from_float<T>(__fmul_rn(rstd, t)));   // dx in dy's dtype
        }
        if (dr != nullptr) {
          float rv[V];
          load_vec(dr + at, rv);
#pragma unroll
          for (int e = 0; e < V; ++e) out[e] = __fadd_rn(out[e], rv[e]);
        }
        store_vec(dx + at, out);
      }
    }
  }

  // The block's partial: its warps' column sums, added in warp order.
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int vi = c * 32 + lane;
        if (vi < nvec) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int col = vi * V + e;
            acc_g[col] = w == 0 ? dg[c * V + e] : __fadd_rn(acc_g[col], dg[c * V + e]);
            acc_b[col] = w == 0 ? db[c * V + e] : __fadd_rn(acc_b[col], db[c * V + e]);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < M; col += kThreads) {
    part_g[(size_t)blockIdx.x * M + col] = acc_g[col];
    if (part_b != nullptr) part_b[(size_t)blockIdx.x * M + col] = acc_b[col];
  }
}

// out[col] = sum over blocks of part[block, col]: 32 columns per block, one
// warp per contiguous slice of partials, the slices added in order.
template <typename P>
__global__ void __launch_bounds__(kThreads) fused_norm_warp_row_reduce_kernel(
    const float* __restrict__ part, P* __restrict__ out, int nblocks, int M) {
  __shared__ float slice[kReduceSlices][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const int per = (nblocks + kReduceSlices - 1) / kReduceSlices;
  const int b0 = warp * per;
  const int b1 = min(nblocks, b0 + per);
  float s = 0.f;
  if (col < M) {
#pragma unroll 8
    for (int b = b0; b < b1; ++b) s = __fadd_rn(s, part[(size_t)b * M + col]);
  }
  slice[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < M) {
    float total = slice[0][lane];
#pragma unroll
    for (int w = 1; w < kReduceSlices; ++w) total = __fadd_rn(total, slice[w][lane]);
    out[col] = from_float<P>(total);
  }
}

template <typename T, typename P>
int launch_fwd(const void* x, const void* resid, const void* gamma, const void* beta, void* y,
               void* r_out, float* mean, float* rstd, int layernorm, int rows, int M, float eps,
               int sms, cudaStream_t stream) {
  const int needed = (rows + kWarps - 1) / kWarps;
  const int cap = kFwdBlocksPerSm * sms;
  const int blocks = needed < cap ? needed : cap;
  const bool stats = rstd != nullptr;
#define FWD(LN, ST)                                                                    \
  fused_norm_warp_row_fwd_kernel<T, P, LN, ST><<<blocks, kThreads, 0, stream>>>(       \
      static_cast<const T*>(x), static_cast<const T*>(resid),                          \
      static_cast<const P*>(gamma), static_cast<const P*>(beta), static_cast<T*>(y),   \
      static_cast<T*>(r_out), mean, rstd, rows, M, eps)
  if (layernorm && stats) FWD(true, true);
  else if (layernorm) FWD(true, false);
  else if (stats) FWD(false, true);
  else FWD(false, false);
#undef FWD
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int launch_bwd(const void* dy, const void* r, const void* gamma, const float* mean,
               const float* rstd, const void* dr, void* dx, float* part_g, float* part_b,
               void* dgamma, void* dbeta, int layernorm, int rows, int M, int blocks,
               cudaStream_t stream) {
  auto kernel = layernorm ? fused_norm_warp_row_bwd_kernel<T, P, true>
                          : fused_norm_warp_row_bwd_kernel<T, P, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(r), static_cast<const P*>(gamma), mean,
      rstd, static_cast<const T*>(dr), static_cast<T*>(dx), part_g, part_b, rows, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cols = (M + 31) / 32;
  fused_norm_warp_row_reduce_kernel<P><<<cols, kThreads, 0, stream>>>(
      part_g, static_cast<P*>(dgamma), blocks, M);
  if (part_b != nullptr)
    fused_norm_warp_row_reduce_kernel<P><<<cols, kThreads, 0, stream>>>(
        part_b, static_cast<P*>(dbeta), blocks, M);
  return (int)cudaGetLastError();
}

bool shape_ok(int rows, int M) { return rows >= 1 && M >= 8 && M <= kMaxM && M % 8 == 0; }

}  // namespace wr

}  // namespace

extern "C" {

// dtype / param_dtype: 0 = float32, 1 = bfloat16 (x, resid, y, r_out, dy,
// r, dr, dx: dtype; gamma, beta, dgamma, dbeta: param_dtype). resid / r_out,
// beta, mean / rstd, dr, dbeta may be null (rstd null: no statistics are
// written; mean is read or written only for LayerNorm). Every launch
// returns cudaGetLastError() after it; -1 for a shape, dtype or geometry
// the kernels do not take.

// Blocks of the "row_group" forward an SM holds at `threads` threads (the
// occupancy API), or -1. `passes` > 1: the wide kernel.
int fused_norm_fwd_occupancy(int dtype, int vec, int nv, int threads, int passes) {
  if (passes > 1) {
    const rg::FwdWideFn wide = rg::pick_wide<true>(dtype, vec, nv);
    if (wide == nullptr) return -1;
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wide, threads, 0);
    return err == cudaSuccess ? blocks : -(int)err;
  }
  const rg::FwdFn kernel = rg::pick<true>(dtype, vec, nv);
  if (kernel == nullptr) return -1;
  const size_t smem = rg::fwd_smem(vec, nv, threads);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// The "row_group" forward: row groups of `threads` threads holding `nv`
// loads of `vec` elements, `blocks` blocks; `passes` > 1 segments a row: the
// wide kernel.
int fused_norm_fwd_launch(const void* x, const void* resid, const void* gamma, const void* beta,
                          void* y, void* r_out, float* mean, float* rstd, int dtype,
                          int param_dtype, int layernorm, int rows, int M, float eps, int vec,
                          int nv, int threads, int blocks, int passes, void* stream) {
  if (passes > 1) {
    const rg::FwdWideFn wide = rg::pick_wide<true>(dtype, vec, nv);
    if (wide == nullptr || rows < 1 || blocks < 1 || param_dtype < 0 || param_dtype > 1 ||
        !rg::wide_ok(dtype, M, vec, nv, threads, passes))
      return -1;
    wide<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, resid, gamma, beta, y, r_out, mean, rstd, rows, M, eps, layernorm, param_dtype,
        passes);
    return (int)cudaGetLastError();
  }
  const rg::FwdFn kernel = rg::pick<true>(dtype, vec, nv);
  if (kernel == nullptr || rows < 1 || blocks < 1 || param_dtype < 0 || param_dtype > 1 ||
      !rg::geometry_ok(dtype, M, vec, nv, threads))
    return -1;
  const size_t smem = rg::fwd_smem(vec, nv, threads);
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, resid, gamma, beta, y, r_out, mean, rstd, rows, M, eps, layernorm, param_dtype);
  return (int)cudaGetLastError();
}

// Clusters of `cluster` "row_group" backward blocks (`groups` row groups of
// `threads` threads) the device holds at once, or <= 0. `passes` > 1: the
// wide kernel (one row group a block).
int fused_norm_bwd_occupancy(int dtype, int vec, int nv, int threads, int groups, int M,
                             int cluster, int passes) {
  if (passes > 1) {
    const rg::BwdWideFn wide = rg::pick_wide<false>(dtype, vec, nv);
    if (wide == nullptr || groups != 1) return -1;
    const size_t smem = rg::bwd_wide_smem(threads * vec * nv, threads);
    cudaError_t err = set_smem(wide, smem);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t config = rg::bwd_config(cluster, threads, smem, cluster, 0, attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, wide, &config);
    return err == cudaSuccess ? clusters : -(int)err;
  }
  const rg::BwdFn kernel = rg::pick<false>(dtype, vec, nv);
  if (kernel == nullptr || groups < 1 || groups * threads > rg::kMaxThreads) return -1;
  const size_t smem = rg::bwd_smem(M, vec, nv, threads, groups);
  if (smem > rg::kSmemLimit) return -1;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config = rg::bwd_config(cluster, groups * threads, smem, cluster, 0, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  return err == cudaSuccess ? clusters : -(int)err;
}

// The "row_group" backward in one launch: `blocks` blocks of `groups` row
// groups, in clusters of `cluster` dividing `blocks`; ws (blocks / cluster)
// x round_up(2M, 32) fp32 scratch (unused for one cluster), counters
// `cluster` int32 zeros (left zero). `passes` > 1: the wide kernel, a grid
// of blocks x passes (one column slice of threads x vec x nv columns each),
// ws passes x (blocks / cluster) x round_up(2 seg, 32), counters passes x 8.
int fused_norm_bwd_launch(const void* dy, const void* r, const void* gamma, const float* mean,
                          const float* rstd, const void* dr, void* dx, float* ws, int* counters,
                          void* dgamma, void* dbeta, int dtype, int param_dtype, int layernorm,
                          int rows, int M, int vec, int nv, int threads, int groups, int blocks,
                          int cluster, int passes, void* stream) {
  if (passes > 1) {
    const rg::BwdWideFn wide = rg::pick_wide<false>(dtype, vec, nv);
    if (wide == nullptr || rows < 1 || param_dtype < 0 || param_dtype > 1 || groups != 1 ||
        !rg::wide_ok(dtype, M, vec, nv, threads, passes) || cluster < 1 ||
        cluster > rg::kMaxCluster || blocks < cluster || blocks % cluster)
      return -1;
    const size_t smem = rg::bwd_wide_smem(threads * vec * nv, threads);
    cudaError_t err = set_smem(wide, smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t config = rg::bwd_config(blocks, threads, smem, cluster,
                                               static_cast<cudaStream_t>(stream), attr);
    config.gridDim = dim3(blocks, passes);
    err = cudaLaunchKernelEx(&config, wide, dy, r, gamma, mean, rstd, dr, dx, ws, counters,
                             dgamma, dbeta, rows, M, threads, layernorm, param_dtype, passes);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const rg::BwdFn kernel = rg::pick<false>(dtype, vec, nv);
  if (kernel == nullptr || rows < 1 || param_dtype < 0 || param_dtype > 1 ||
      !rg::geometry_ok(dtype, M, vec, nv, threads) || groups < 1 || groups > rg::kMaxGroups ||
      groups * threads > rg::kMaxThreads || (vec * nv > rg::kBwdHeld && groups != 1) ||
      cluster < 1 || cluster > rg::kMaxCluster || blocks < cluster || blocks % cluster)
    return -1;
  const size_t smem = rg::bwd_smem(M, vec, nv, threads, groups);
  if (smem > rg::kSmemLimit) return -1;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config = rg::bwd_config(blocks, groups * threads, smem, cluster,
                                             static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&config, kernel, dy, r, gamma, mean, rstd, dr, dx, ws, counters,
                           dgamma, dbeta, rows, M, threads, layernorm, param_dtype);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The "warp_row" forward: rows strided over up to 8 blocks an SM of `sms`.
int fused_norm_warp_row_fwd_launch(const void* x, const void* resid, const void* gamma,
                                   const void* beta, void* y, void* r_out, float* mean,
                                   float* rstd, int dtype, int param_dtype, int layernorm,
                                   int rows, int M, float eps, int sms, void* stream) {
  if (!wr::shape_ok(rows, M) || sms < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, P)                                                                   \
  return wr::launch_fwd<T, P>(x, resid, gamma, beta, y, r_out, mean, rstd, layernorm,  \
                              rows, M, eps, sms, st)
  if (dtype == 0 && param_dtype == 0) LAUNCH(float, float);
  if (dtype == 0 && param_dtype == 1) LAUNCH(float, __nv_bfloat16);
  if (dtype == 1 && param_dtype == 0) LAUNCH(__nv_bfloat16, float);
  if (dtype == 1 && param_dtype == 1) LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef LAUNCH
  return -1;
}

// The "warp_row" backward: part_g / part_b (blocks, M) fp32 scratch, part_b
// and dbeta null without beta; then the ordered reduction launches.
int fused_norm_warp_row_bwd_launch(const void* dy, const void* r, const void* gamma,
                                   const float* mean, const float* rstd, const void* dr,
                                   void* dx, float* part_g, float* part_b, void* dgamma,
                                   void* dbeta, int dtype, int param_dtype, int layernorm,
                                   int rows, int M, int blocks, void* stream) {
  if (!wr::shape_ok(rows, M) || blocks < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, P)                                                                   \
  return wr::launch_bwd<T, P>(dy, r, gamma, mean, rstd, dr, dx, part_g, part_b, dgamma, \
                              dbeta, layernorm, rows, M, blocks, st)
  if (dtype == 0 && param_dtype == 0) LAUNCH(float, float);
  if (dtype == 0 && param_dtype == 1) LAUNCH(float, __nv_bfloat16);
  if (dtype == 1 && param_dtype == 0) LAUNCH(__nv_bfloat16, float);
  if (dtype == 1 && param_dtype == 1) LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef LAUNCH
  return -1;
}

}  // extern "C"
