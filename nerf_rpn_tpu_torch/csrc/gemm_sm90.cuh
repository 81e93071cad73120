// Staged-weight matrix products for Hopper: the mainloop pieces of kernel
// K5 (fused_ln_qkv.cu), written so that K6 (fused_mlp.cu) can take them.
//
// The weight is read in nn.Linear's layout, (N, K) row-major with K
// contiguous: mma.sync's "col" B operand.  A block copies (BN x BK)
// k-chunks of its BN output columns into a ring of padded shared tiles by
// 16-byte cp.async (copy_tile_async), keeping the next chunks in flight,
// and each warp adds one chunk's products into its 16 x (8 NT) f32
// accumulator tile (warp_chunk_mma):
//
//   acc[nt] (16 x 8) += A[16 rows, BK] . B[8 nt .. 8 nt + 7, BK]^T
//
// bf16: mma.sync m16n8k16 with A and B fragments from ldmatrix (A and B
// tile rows an odd number of 16-byte units apart, so the eight rows of an
// 8x8 matrix hit no bank twice).  f32: 3xTF32 mma.sync m16n8k8 (each
// operand split into tf32 hi + lo) from scalar fragment loads, rows 4 mod 8
// words apart.  Fragment layouts as in mma_sm90.cuh.
#pragma once

#include "mma_sm90.cuh"

// cp.async a (rows x cols) tile of a row-major matrix (row stride ld_src
// elements, 16-byte-aligned rows) into shared memory (row stride ld_dst),
// 16-byte pieces spread over nthreads threads; cols * sizeof(T) must be a
// power-of-two multiple of 16 bytes
template <typename T>
__device__ __forceinline__ void copy_tile_async(T* dst, int ld_dst,
                                                const T* __restrict__ src,
                                                long long ld_src, int rows,
                                                int cols, int tid,
                                                int nthreads) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int per_row = cols / kVec;
  const int shift = __ffs(per_row) - 1;
  for (int i = tid; i < rows * per_row; i += nthreads) {
    const int r = i >> shift, c = (i & (per_row - 1)) * kVec;
    cp_async16(dst + r * ld_dst + c, src + r * ld_src + c);
  }
}

// bf16: acc += A (16 x bk at a, row stride lda) . B^T, B the warp's
// (8 NT x bk) rows at b (row stride ldb); bk a multiple of 16
template <int NT>
__device__ __forceinline__ void warp_chunk_mma(float (&acc)[NT][4],
                                               const __nv_bfloat16* a, int lda,
                                               const __nv_bfloat16* b, int ldb,
                                               int bk, int lane) {
  static_assert(NT % 2 == 0, "B fragments come two n8 tiles per ldmatrix.x4");
  const __nv_bfloat16* ap =
      a + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda + (lane >> 4) * 8;
  const __nv_bfloat16* bp =
      b + ((lane >> 4) * 8 + (lane & 7)) * ldb + ((lane >> 3) & 1) * 8;
  for (int k = 0; k < bk; k += 16) {
    uint32_t af[4];
    ldsm_x4(af, ap + k);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, bp + np * 16 * ldb + k);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// f32 (3xTF32): the same product; bk a multiple of 8
template <int NT>
__device__ __forceinline__ void warp_chunk_mma(float (&acc)[NT][4],
                                               const float* a, int lda,
                                               const float* b, int ldb, int bk,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* ap = a + g * lda + t;
  const float* bp = b + g * ldb + t;
  for (int k = 0; k < bk; k += 8) {
    uint32_t ah[4], al[4];
    split_tf32(ap[k], ah[0], al[0]);                // (g, t)
    split_tf32(ap[8 * lda + k], ah[1], al[1]);      // (g + 8, t)
    split_tf32(ap[k + 4], ah[2], al[2]);            // (g, t + 4)
    split_tf32(ap[8 * lda + k + 4], ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* bb = bp + nt * 8 * ldb + k;
      uint32_t bh[2], bl[2];
      split_tf32(bb[0], bh[0], bl[0]);  // (k = t, n = g)
      split_tf32(bb[4], bh[1], bl[1]);  // (k = t + 4, n = g)
      mma_3xtf32(acc[nt], ah, al, bh, bl);
    }
  }
}
