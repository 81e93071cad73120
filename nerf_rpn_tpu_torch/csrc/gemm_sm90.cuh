// Staged-weight matrix products for Hopper: the mainloop pieces that
// kernels K5 (fused_ln_qkv.cu) and K6 (fused_mlp.cu) share.  Both run a
// block of kWarps = 4 warps that normalises its token rows in a shared A
// tile (RowMap, copy_rows_async, layer_norm_rows), streams weight chunks
// through a ring of kRing buffers and stores from the accumulator
// fragments (store_warp_tile).
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

constexpr int kWarps = 4;  // warps of a K5 / K6 block
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 4;          // weight k-chunk buffers
constexpr int kMaxSmem = 232448;  // dynamic shared memory of one block

// row pad of every shared tile: 16 bytes (an odd number of 16-byte units
// a row for bf16 ldmatrix, 4 mod 8 words for f32 fragment loads)
template <typename T>
__host__ __device__ constexpr int pad_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

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

// a 16-byte vector as f32 values, and back (bf16: round to nearest even)
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = unpack_bf16(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// two adjacent values of a device array (8-byte / 4-byte aligned) as f32
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

// The rows of one warp (R / kWarps of the block's tokens) in the
// LayerNorm's lane map: up to 8 rows a pass, each row's 16-byte vectors
// spread over a group of 32 / (rows a pass) lanes, so that a pass has
// several rows' loads and short reductions in flight.
struct RowMap {
  int lanes, slot, gl, per_pass, rows, first;
  __device__ RowMap(int R, int warp, int lane) {
    rows = R / kWarps;
    per_pass = rows < 8 ? rows : 8;
    lanes = 32 / per_pass;
    slot = lane / lanes;
    gl = lane % lanes;
    first = warp * rows;
  }
};

// each warp copies its own x rows into the A tile (rows with a negative
// source are skipped); src is this lane's row's offset for lanes < rows
template <typename T>
__device__ __forceinline__ void copy_rows_async(T* a, int lda,
                                                const T* __restrict__ x,
                                                const RowMap& m, int nv,
                                                long long src) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  for (int r0 = 0; r0 < m.rows; r0 += m.per_pass) {
    const int r = r0 + m.slot;
    const long long s = __shfl_sync(0xffffffffu, src, r & 31);
    if (r < m.rows && s >= 0)
      for (int v = m.gl; v < nv; v += m.lanes)
        cp_async16(a + (m.first + r) * lda + v * kVec, x + s + v * kVec);
  }
}

// the sum of a 16-byte vector's values, as a pairwise tree
template <int N>
__device__ __forceinline__ float tree_sum(const float (&f)[N]) {
  float h[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) h[e] = f[2 * e] + f[2 * e + 1];
  if constexpr (N / 2 == 1) {
    return h[0];
  } else {
    return tree_sum<N / 2>(h);
  }
}

// How layer_norm_rows takes the variance: about the mean in a second pass
// (K5, as its twin), or E[x^2] - E[x]^2 from one pass (K6, as its twin)
enum class Variance { kTwoPass, kFast };

// LayerNorm of the warp's rows in place in the A tile, f32 statistics by
// the variance form V, then (x - mean) * rstd * scale + bias in f32,
// rounded once to T; a row with a negative source becomes zeros
template <Variance V, typename T>
__device__ __forceinline__ void layer_norm_rows(
    T* a, int lda, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const RowMap& m, int C, int nv,
    long long src, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  for (int r0 = 0; r0 < m.rows; r0 += m.per_pass) {
    const int r = r0 + m.slot;
    const long long s = __shfl_sync(0xffffffffu, src, r & 31);
    const bool live = r < m.rows && s >= 0;
    T* arow = a + (m.first + r) * lda;
    float sum = 0.f, sq = 0.f;
    if (live) {
#pragma unroll 4
      for (int v = m.gl; v < nv; v += m.lanes) {
        float f[kVec];
        unpack(*reinterpret_cast<const uint4*>(arow + v * kVec), f);
        sum += tree_sum(f);
        if constexpr (V == Variance::kFast) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) f[e] *= f[e];
          sq += tree_sum(f);
        }
      }
    }
    for (int o = m.lanes / 2; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if constexpr (V == Variance::kFast)
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mean = sum / C;
    float var;
    if constexpr (V == Variance::kFast) {
      var = sq / C - mean * mean;
    } else {
      if (live) {
#pragma unroll 4
        for (int v = m.gl; v < nv; v += m.lanes) {
          float f[kVec];
          unpack(*reinterpret_cast<const uint4*>(arow + v * kVec), f);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float d = f[e] - mean;
            f[e] = d * d;
          }
          sq += tree_sum(f);
        }
      }
      for (int o = m.lanes / 2; o > 0; o >>= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      var = sq / C;
    }
    const float rstd = 1.f / sqrtf(var + eps);
    if (r < m.rows) {
#pragma unroll 2
      for (int v = m.gl; v < nv; v += m.lanes) {
        float f[kVec];
        if (live) {
          unpack(*reinterpret_cast<const uint4*>(arow + v * kVec), f);
          const float4* sc = reinterpret_cast<const float4*>(ln_scale + v * kVec);
          const float4* bi = reinterpret_cast<const float4*>(ln_bias + v * kVec);
#pragma unroll
          for (int q = 0; q < kVec / 4; ++q) {
            const float4 s4 = __ldg(sc + q), b4 = __ldg(bi + q);
            f[4 * q] = (f[4 * q] - mean) * rstd * s4.x + b4.x;
            f[4 * q + 1] = (f[4 * q + 1] - mean) * rstd * s4.y + b4.y;
            f[4 * q + 2] = (f[4 * q + 2] - mean) * rstd * s4.z + b4.z;
            f[4 * q + 3] = (f[4 * q + 3] - mean) * rstd * s4.w + b4.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) f[e] = 0.f;
        }
        *reinterpret_cast<uint4*>(arow + v * kVec) = pack(f);
      }
    }
  }
}

// One warp's 16 x 8 NT accumulator tile stored from the fragments through
// an epilogue: epi(v, r, c) gives the f32 values of columns c, c + 1 of
// row r (0 <= r < 16) from their sums v, and rows r >= rows are not
// stored.  f32 as 8-byte pairs (a row's 4 lanes fill 32 bytes); bf16 as
// 8-byte quads after a swap with the neighbouring lane, so that a row's 4
// lanes fill the 32 bytes of two adjacent n8 tiles (one rounding, to
// nearest even, at the store).
template <int NT, typename Epi>
__device__ __forceinline__ void store_warp_tile(float* dst, long long ld,
                                                const float (&acc)[NT][4],
                                                int lane, int rows, Epi epi) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g, g + 8
      const int r = g + 8 * h;
      const float2 v = epi(make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]), r, c);
      if (r < rows) *reinterpret_cast<float2*>(dst + r * ld + c) = v;
    }
  }
}
template <int NT, typename Epi>
__device__ __forceinline__ void store_warp_tile(__nv_bfloat16* dst, long long ld,
                                                const float (&acc)[NT][4],
                                                int lane, int rows, Epi epi) {
  const int g = lane >> 2, t = lane & 3, odd = t & 1;
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g, g + 8
      const int r = g + 8 * h;
      const float2 v0 = epi(make_float2(acc[2 * p][2 * h], acc[2 * p][2 * h + 1]), r,
                            p * 16 + 2 * t);
      const float2 v1 = epi(make_float2(acc[2 * p + 1][2 * h], acc[2 * p + 1][2 * h + 1]),
                            r, p * 16 + 8 + 2 * t);
      const uint32_t u0 = pack_bf16(v0.x, v0.y), u1 = pack_bf16(v1.x, v1.y);
      const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? u0 : u1, 1);
      // even t: tile 2p columns 2t .. 2t + 3; odd t: tile 2p + 1 columns
      // 2t - 2 .. 2t + 1
      const uint2 q = odd ? make_uint2(got, u1) : make_uint2(u0, got);
      const int col = odd ? p * 16 + 8 + 2 * t - 2 : p * 16 + 2 * t;
      if (r < rows) *reinterpret_cast<uint2*>(dst + r * ld + col) = q;
    }
  }
}
