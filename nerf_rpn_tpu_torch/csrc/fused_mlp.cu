// Kernel K6: the MLP half of an eval Swin block,
//   out = x + fc2(GELU(fc1(LN(x)))),
// on (T, C) tokens with w1 (C, Hd) and w2 (Hd, C).
//
// Replaces nerf_rpn_tpu/ops/fused_mlp.py : _kernel (the Pallas TPU kernel
// behind fused_mlp_block), with its rounding points:
//   LN with the fast variance E[x^2] - E[x]^2 in f32, eps inside the
//   square root, affine in f32, rounded to the type;
//   h = round(LN(x) . w1) (f32 accumulation), then h = round(h + b1) with
//   b1 in the type; GELU in f32 from that h, h * 0.5 * (1 + erf(h / sqrt 2))
//   with the A&S 7.1.26 erf of _erf_f32, rounded;
//   o = round(h . w2), o = round(o + b2), out = round(x + o).
//
// What bounds it on the H100: at the Swin-S bench shape, stage 0 does
// 14.4 GFLOP of products per block on 18.7 MB in and out, so the bf16
// tensor-core rate bounds it (~15 us at 989 TFLOP/s); the (T, 4C) hidden
// activation is what the unfused chain moves through device memory (75 MB
// written and read again per stage-0 block).  The design keeps it out:
// a block owns `rows` tokens, holds their LN'd tile in shared memory, and
// walks its share of the hidden width in chunks of 64 -- fc1 into a
// (rows x 64) tile, bias and GELU applied there, then that tile times the
// chunk's 64 rows of w2 added into the (rows x C) output accumulators,
// which stay in registers across the 8 warps (Tile16: wmma 16x16x16 bf16
// with f32 accumulation, or true f32 FMA for f32).  Where there are too few
// token tiles to fill the SMs (the late stages: 48 and 8 tiles at the
// bench shape), the hidden width is split over `splits` blocks per tile;
// each writes its f32 partial sums, and a second kernel adds them in split
// order (deterministic, no atomics) before the epilogue.  The weights are
// read from L2 by every block.  wgmma and TMA staging of the weights are
// later work.
#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // hidden columns per step

// erf by Abramowitz & Stegun 7.1.26, as _erf_f32 of the JAX kernel
__device__ __forceinline__ float erf_as7126(float v) {
  const float a = fabsf(v);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float sign = v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
  return sign * (1.f - poly * expf(-a * a));
}

// the epilogue of one output element from its f32 sum:
// o = round(acc), o = round(o + b2), out = round(x + o)
template <typename T>
__device__ __forceinline__ T mlp_out(float acc, T b2, T x) {
  const float o = round_to<T>(round_to<T>(acc) + to_f32(b2));
  return from_f32<T>(to_f32(x) + o);
}

// RT row tiles of 16 tokens; MAXF output tiles per warp (RT * C / 16 <=
// 8 * MAXF).  Grid (token tiles, splits); with splits > 1 the block writes
// its f32 partial sums to part (splits, n_tokens, C) instead of the output
template <typename T, int RT, int MAXF>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias,
                     const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const T* __restrict__ b2,
                     T* __restrict__ out, float* __restrict__ part,
                     int n_tokens, int C, int Hd, int splits, float eps) {
  constexpr int rows = RT * 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lda = C + row_pad<T>();
  constexpr int ldh = kChunk + row_pad<T>();
  T* a = reinterpret_cast<T*>(smem_raw);  // (rows, lda) LN'd tokens
  T* hs = a + rows * lda;                 // (rows, ldh) GELU'd hidden chunk
  float* stage = reinterpret_cast<float*>(hs + rows * ldh);  // (warps, 256)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  float* st = stage + warp * 256;

  // LayerNorm, one warp per token (rows past the end are zeros)
  for (int i = warp; i < rows; i += kWarps) {
    T* arow = a + i * lda;
    if (row0 + i >= n_tokens) {
      for (int c = lane; c < C; c += 32) arow[c] = from_f32<T>(0.f);
      continue;
    }
    const T* xr = x + (row0 + i) * C;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f32(xr[c]);
      sum += v;
      sq += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mean = sum / C;
    const float var = sq / C - mean * mean;
    const float rstd = 1.f / sqrtf(var + eps);
    for (int c = lane; c < C; c += 32)
      arow[c] = from_f32<T>((to_f32(xr[c]) - mean) * rstd * ln_scale[c] +
                            ln_bias[c]);
  }
  __syncthreads();

  const int n_ct = C / 16;
  const int n_out = RT * n_ct;  // output tiles, tile id -> (id % RT, id / RT)
  Tile16<T> acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) acc[f].zero();

  const float sqrt2 = sqrtf(2.f);  // the JAX kernel divides by jnp.sqrt(2.0)

  const int per = Hd / splits;
  const int j_end = (blockIdx.y + 1) * per;
  for (int j0 = blockIdx.y * per; j0 < j_end; j0 += kChunk) {
    // fc1 on this chunk: RT x 4 tiles, one per warp
    if (warp < RT * (kChunk / 16)) {
      const int rt = warp % RT, ct = warp / RT;
      Tile16<T> h;
      h.zero();
      for (int k = 0; k < C; k += 16)
        h.mma(a + rt * 16 * lda + k, lda,
              w1 + static_cast<size_t>(k) * Hd + j0 + ct * 16, Hd);
      h.store(st, 16);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const float hb =
            round_to<T>(round_to<T>(st[e]) + to_f32(b1[j0 + ct * 16 + c]));
        const float g = hb * 0.5f * (1.f + erf_as7126(hb / sqrt2));
        hs[(rt * 16 + r) * ldh + ct * 16 + c] = from_f32<T>(g);
      }
      __syncwarp();
    }
    __syncthreads();
    // fc2: out tiles += hs (rows x 64) . w2[j0 : j0 + 64, :]
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int id = warp + kWarps * f;
      if (id < n_out) {
        const int rt = id % RT, ct = id / RT;
#pragma unroll
        for (int k = 0; k < kChunk; k += 16)
          acc[f].mma(hs + rt * 16 * ldh + k, ldh,
                     w2 + static_cast<size_t>(j0 + k) * C + ct * 16, C);
      }
    }
    __syncthreads();
  }

  // epilogue, or this split's partial sums
  float* my_part =
      splits > 1 ? part + static_cast<long long>(blockIdx.y) * n_tokens * C
                 : nullptr;
#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int id = warp + kWarps * f;
    if (id < n_out) {
      const int rt = id % RT, ct = id / RT;
      acc[f].store(st, 16);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const long long row = row0 + rt * 16 + r;
        if (row < n_tokens) {
          const long long at = row * C + ct * 16 + c;
          if (my_part)
            my_part[at] = st[e];
          else
            out[at] = mlp_out<T>(st[e], b2[ct * 16 + c], x[at]);
        }
      }
      __syncwarp();
    }
  }
}

// sums the splits' partials in split order, then the epilogue
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlp_reduce_kernel(const float* __restrict__ part, const T* __restrict__ x,
                      const T* __restrict__ b2, T* __restrict__ out,
                      long long n, int C, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[s * n + i];
  out[i] = mlp_out<T>(acc, b2[i % C], x[i]);
}

template <typename T, int RT>
size_t smem_bytes(int C) {
  return static_cast<size_t>(RT * 16) *
             ((C + row_pad<T>()) + (kChunk + row_pad<T>())) * sizeof(T) +
         kWarps * 256 * sizeof(float);
}

template <typename T, int RT, int MAXF>
int launch_tiles(const void* x, const void* s, const void* t, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* out,
                 void* part, int n_tokens, int C, int Hd, int splits, float eps,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes<T, RT>(C);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T, RT, MAXF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_tokens + RT * 16 - 1) / (RT * 16);
  fused_mlp_kernel<T, RT, MAXF><<<dim3(tiles, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out),
      static_cast<float*>(part), n_tokens, C, Hd, splits, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(n_tokens) * C;
  mlp_reduce_kernel<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const T*>(x),
      static_cast<const T*>(b2), static_cast<T*>(out), n, C, splits);
  return static_cast<int>(cudaGetLastError());
}

// 32-token blocks up to C = 768 (12 output tiles a warp, 96 accumulator
// registers a thread); 16-token blocks up to C = 1536
template <typename T>
int launch(const void* x, const void* s, const void* t, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out,
           void* part, int n_tokens, int C, int Hd, int splits, float eps,
           cudaStream_t stream) {
  if (C <= 256)
    return launch_tiles<T, 2, 4>(x, s, t, w1, b1, w2, b2, out, part, n_tokens,
                                 C, Hd, splits, eps, stream);
  if (C <= 768)
    return launch_tiles<T, 2, 12>(x, s, t, w1, b1, w2, b2, out, part,
                                  n_tokens, C, Hd, splits, eps, stream);
  if (C <= 1536)
    return launch_tiles<T, 1, 12>(x, s, t, w1, b1, w2, b2, out, part,
                                  n_tokens, C, Hd, splits, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (T, C) f32|bf16, ln scale / bias (C,) f32, w1 (C, Hd), b1 (Hd,),
// w2 (Hd, C), b2 (C,) and out (T, C) of x's type; all contiguous.  C a
// multiple of 16 up to 1536, Hd a multiple of 64 * splits; with splits > 1,
// part is f32 scratch of (splits, T, C).  Returns the CUDA error code of
// the launches (0 on success).
extern "C" int fused_mlp_block(const void* x, const void* ln_scale,
                               const void* ln_bias, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               void* out, void* part, int n_tokens, int C,
                               int Hd, int splits, int dtype_code, float eps,
                               void* stream) {
  if (n_tokens <= 0 || C <= 0 || C % 16 || Hd <= 0 || splits <= 0 ||
      Hd % (kChunk * splits) || (splits > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kFloat32)
    return launch<float>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, part,
                         n_tokens, C, Hd, splits, eps, s);
  if (dtype_code == kBFloat16)
    return launch<__nv_bfloat16>(x, ln_scale, ln_bias, w1, b1, w2, b2, out,
                                 part, n_tokens, C, Hd, splits, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
