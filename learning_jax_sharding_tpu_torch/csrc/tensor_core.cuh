// What the tensor-core kernels (int4_matmul.cu, flash_attention.cu,
// decode_attention.cu) share:
// cp.async copies into shared memory, ldmatrix fragment loads and the bf16
// mma.sync.m16n8k16 product, each one PTX instruction.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 * g + t):
//   A (16 x 16, 4 registers of 2 bf16): a0 row g, a1 row g + 8, a2 row g,
//     a3 row g + 8; columns 2t, 2t + 1 (a0, a1) and 8 + 2t, 9 + 2t (a2, a3).
//   B (16 x 8, 2 registers): b0 rows 2t, 2t + 1, b1 rows 8 + 2t, 9 + 2t;
//     column g.
//   C (16 x 8, 4 fp32): c0, c1 row g, c2, c3 row g + 8; columns 2t, 2t + 1.
// So two neighbouring C tiles, rounded to bf16 and packed in pairs, are one A
// fragment: {c0c1, c2c3} of the first tile, then of the second.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc_prims {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes, zero-filling what lies past src_bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x in one MUFU instruction; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace tc_prims

// Tiles of bf16 rows in shared memory and the products over them (flash
// attention, decode attention).
namespace tc_tiles {

using namespace tc_prims;

// Shared-memory tiles hold bf16 rows of H values padded by 16 bytes, so the 8
// row addresses of an ldmatrix phase fall on 8 different bank groups.
template <int H>
struct Tile {
  static constexpr int kStride = H * 2 + 16;   // bytes per row
  static constexpr int kChunks = H / 8;        // 16-byte copies per row
};

// The A fragment of rows [m0, m0 + 16) x columns [k0, k0 + 16) of a tile.
template <int H>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* tile, int m0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, tile + (m0 + lane % 16) * Tile<H>::kStride + (k0 + (lane / 16) * 8) * 2);
}

// B fragments of the two 8-column tiles n0 .. n0 + 15 at depth k0 .. k0 + 15.
// "nk": the tile's rows are the product's columns (S = Q K^T takes K's rows
// as columns), read as they lie. "kn": the tile's rows are its depth (dQ +=
// dS K), read transposed by ldmatrix.trans.
template <int H>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const uint8_t* tile, int n0,
                                          int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * Tile<H>::kStride +
                     (k0 + ((lane / 8) % 2) * 8) * 2);
}
template <int H>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const uint8_t* tile, int n0,
                                          int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * Tile<H>::kStride +
                           (n0 + (lane / 16) * 8) * 2);
}

// acc (16 x 8 NT) += A B^T at depth ks * 16 .. + 15: `a` the A fragment, B
// rows 0 .. 8 NT - 1 of b_tile ("nk").
template <int H, int NT>
__device__ __forceinline__ void mma_nk(float (&acc)[NT][4], const uint32_t (&a)[4],
                                       const uint8_t* b_tile, int ks) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t b[4];
    load_b_nk<H>(b, b_tile, np * 16, ks * 16);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// acc (16 x 8 NT) += A B^T over the whole depth H: A (16 x H) held as
// fragments, or rows m0 .. m0 + 15 of a_tile.
template <int H, int NT>
__device__ __forceinline__ void product_nk(float (&acc)[NT][4], const uint32_t (&a)[H / 16][4],
                                           const uint8_t* b_tile) {
#pragma unroll
  for (int ks = 0; ks < H / 16; ++ks) mma_nk<H, NT>(acc, a[ks], b_tile, ks);
}
template <int H, int NT>
__device__ __forceinline__ void product_nk(float (&acc)[NT][4], const uint8_t* a_tile, int m0,
                                           const uint8_t* b_tile) {
#pragma unroll
  for (int ks = 0; ks < H / 16; ++ks) {
    uint32_t a[4];
    load_a<H>(a, a_tile, m0, ks * 16);
    mma_nk<H, NT>(acc, a, b_tile, ks);
  }
}

// acc (16 x H) += X B: X is 16 x 8 NT as fp32 C fragments, rounded to bf16
// (two C tiles make one A fragment); B is rows 0 .. 8 NT - 1 of b_tile ("kn").
template <int H, int NT>
__device__ __forceinline__ void product_kn(float (&acc)[H / 8][4], const float (&x)[NT][4],
                                           const uint8_t* b_tile) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int nh = 0; nh < H / 16; ++nh) {
      uint32_t b[4];
      load_b_kn<H>(b, b_tile, nh * 16, kk * 16);
      mma_bf16(acc[2 * nh], a, b[0], b[1]);
      mma_bf16(acc[2 * nh + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace tc_tiles
