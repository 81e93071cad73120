// One warp's 16 x 16 f32 accumulator tile, for the matrix products of
// kernel K6 (fused_mlp.cu); K5 moved to the staged-weight mma.sync pieces
// of gemm_sm90.cuh, which K6's redesign is to take as well.
//
//   Tile16<T> acc;  acc.zero();
//   acc.mma(a, lda, b, ldb);   // acc += A[16 x 16] . B[16 x 16], row-major
//   acc.store(c, ldc);         // row-major f32 16 x 16 out
//
// bf16 goes through the tensor cores (nvcuda::wmma 16x16x16, f32
// accumulation): A and B pointers 32-byte aligned, lda / ldb multiples of
// 8 elements, A and B in shared or device memory.  f32 runs true f32 FMA on
// the CUDA cores, so that an f32 product keeps f32 parity: lane l owns row
// l / 2 and the 8 columns from 8 (l % 2), and sums over k in order.
#pragma once

#include <mma.h>

#include "common.cuh"

template <typename T>
struct Tile16;

template <>
struct Tile16<__nv_bfloat16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc;

  __device__ __forceinline__ void zero() {
    nvcuda::wmma::fill_fragment(acc, 0.f);
  }
  __device__ __forceinline__ void mma(const __nv_bfloat16* a, int lda,
                                      const __nv_bfloat16* b, int ldb) {
    nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           nvcuda::wmma::row_major>
        fa;
    nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           nvcuda::wmma::row_major>
        fb;
    nvcuda::wmma::load_matrix_sync(fa, a, lda);
    nvcuda::wmma::load_matrix_sync(fb, b, ldb);
    nvcuda::wmma::mma_sync(acc, fa, fb, acc);
  }
  __device__ __forceinline__ void store(float* c, int ldc) {
    nvcuda::wmma::store_matrix_sync(c, acc, ldc, nvcuda::wmma::mem_row_major);
  }
};

template <>
struct Tile16<float> {
  float acc[8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  }
  __device__ __forceinline__ void mma(const float* a, int lda, const float* b,
                                      int ldb) {
    const int lane = threadIdx.x & 31;
    const float* arow = a + (lane >> 1) * lda;
    const float* bcol = b + (lane & 1) * 8;
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float av = arow[k];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(av, bcol[k * ldb + j], acc[j]);
    }
  }
  __device__ __forceinline__ void store(float* c, int ldc) {
    const int lane = threadIdx.x & 31;
    float* crow = c + (lane >> 1) * ldc + (lane & 1) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) crow[j] = acc[j];
  }
};

// row padding of a shared-memory operand tile, in elements: keeps wmma's
// 32-byte alignment for bf16 and breaks the bank stride for f32
template <typename T>
__host__ __device__ constexpr int row_pad() {
  return sizeof(T) == 2 ? 8 : 4;
}
