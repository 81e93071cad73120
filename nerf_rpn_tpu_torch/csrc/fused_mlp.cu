// Kernel K6: the MLP half of an eval Swin block,
//   out = x + fc2(GELU(fc1(LN(x)))),
// on (T, C) tokens with fc1's weight (Hd, C) and fc2's weight (C, Hd), both
// in nn.Linear's layout.
//
// Replaces nerf_rpn_tpu/ops/fused_mlp.py : _kernel (the Pallas TPU kernel
// behind fused_mlp_block), with its rounding points:
//   LN with the fast variance E[x^2] - E[x]^2 in f32, eps inside the
//   square root, affine in f32, rounded to the type;
//   h = round(round(LN(x) . w1) + b1) (f32 accumulation, b1 in the type);
//   GELU in f32 from that h, h * 0.5 * (1 + erf(h / sqrt 2)) with the
//   A&S 7.1.26 erf of _erf_f32 (fast f32 forms, gelu_hidden), rounded;
//   o = round(round(h . w2) + b2), out = round(x + o).
//
// What bounds it on the H100: 4 T C Hd operations against T C bytes in and
// out, so the bf16 tensor-core rate at stage 0 of the Swin-S bench shape
// (14.4 GFLOP: ~15 us at 989 TFLOP/s) and far less at the late stages
// (stage 2: 3.6 us, 24 tiles of 64 tokens).  The unfused chain moves the
// (T, Hd) hidden activation through device memory; this kernel keeps it in
// shared memory.  What a block's time is made of at the late stages is its
// serial chain of weight chunks (as K5 found), so the design spreads the
// hidden width over blocks until the card is full and keeps that chain
// short and unbroken:
//
// - Grid: one block of 4 warps per (R token rows, hidden slice s of S);
//   the slice is H_s = Hd / S hidden columns; block b takes slice b % S of
//   token tile b / S.  The wrapper's planner (ops/fused_mlp.py : mlp_plan)
//   picks (R, S, BN, BK) by a rule.
// - Pass 1 (fc1): each warp cp.asyncs its x rows into the A tile (R x C)
//   and normalises them in place, 8 rows a warp pass (gemm_sm90.cuh, the
//   fast variance); rows past T are zeros.  The block streams
//   fc1.weight[h0 : h0 + H_s, :] as (BN x BK) k-chunks through a ring of
//   four cp.async buffers into bf16 mma.sync m16n8k16 from ldmatrix (f32:
//   3xTF32 m16n8k8).  At the end of each BN-wide column tile, bias and GELU
//   run on the accumulator fragments and the rounded values go to the
//   shared hidden tile Hs (R x H_s).
// - Pass 2 (fc2): the same ring streams fc2.weight[:, h0 : h0 + H_s] (row
//   stride Hd) with A = Hs.  The two passes are one chunk stream: pass 2's
//   first chunks are in flight while pass 1's last products run, and the
//   ring's one __syncthreads a chunk orders Hs's writes before its reads.
// - Epilogue: with S = 1 the block stores round(x + round(round(acc) + b2))
//   from the fragments in whole 32-byte sectors (x re-read from L2); with
//   S > 1 it stores its f32 partial sums, and mlp_reduce_kernel adds the
//   splits in split order (no atomics: the same bits every run) before the
//   same epilogue.
// - A warp holds 16 x 8 NT f32 accumulators (R * BN = 512 NT) whatever C
//   is; the weights are read where nn.Linear keeps them, so the model's
//   `Linear.weight.t()` views cost no transposed copy.

#include "gemm_sm90.cuh"

namespace {

constexpr int kMaxC = 1536;         // widest LayerNorm (Swin-L's last stage)
constexpr int kReduceThreads = 256;

// the hidden value from fc1's f32 sum: h = round(round(acc) + b1), then
// GELU in f32 with the A&S 7.1.26 erf of the JAX kernel's _erf_f32
// (rounded to T where it is stored).  The GELU is most of the work at
// stage 0 (37M values), so its arithmetic takes the fast forms, each
// within a few f32 ulps of the JAX kernel's: h * (1 / sqrt 2) for
// h / sqrt(2), an approximate reciprocal, exp(-a^2) as ex2.approx, and the
// sign by copysign (erf(0) = 1.5e-9 instead of 0 is harmless: h = 0)
template <typename T>
__device__ __forceinline__ float gelu_hidden(float acc, float b1) {
  const float h = round_to<T>(round_to<T>(acc) + b1);
  const float z = h * 0.70710678f;
  const float a = fabsf(z);
  const float t = __fdividef(1.f, 1.f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf = copysignf(1.f - poly * exp2f(-a * a * 1.44269504f), z);
  return h * 0.5f * (1.f + erf);
}

// the output from fc2's f32 sum: o = round(round(acc) + b2), x + o (rounded
// to T where it is stored)
template <typename T>
__device__ __forceinline__ float mlp_out(float acc, float b2, float x) {
  return x + round_to<T>(round_to<T>(acc) + b2);
}

template <typename T>
size_t smem_bytes(int C, int Hd, int R, int S, int BN, int BK) {
  constexpr int kPad = pad_elems<T>();
  return (static_cast<size_t>(R) * (C + kPad) +
          static_cast<size_t>(R) * (Hd / S + kPad) +
          static_cast<size_t>(kRing) * BN * (BK + kPad)) *
         sizeof(T);
}

// Block b: hidden slice b % S, token rows R (b / S) ... + R - 1.  Warp w:
// rows 16 (w % (R / 16)), columns 8 NT (w / (R / 16)) of each BN-wide
// column tile of either pass.  Chunk q of the block's weight stream is
// pass 1's k-chunk q % nk1 of column tile q / nk1 for q < total1, then
// pass 2's likewise.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 4)
    fused_mlp_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias,
                     const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const T* __restrict__ b2,
                     T* __restrict__ out, float* __restrict__ part,
                     int n_tokens, int C, int Hd, int R, int S, int BN, int BK,
                     float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kPad = pad_elems<T>();
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int Hs = Hd / S;
  const int lda = C + kPad, ldh = Hs + kPad, ldb = BK + kPad;
  T* a = reinterpret_cast<T*>(smem_raw);  // (R, lda): x, then LN(x)
  T* hid = a + R * lda;                   // (R, ldh): GELU(fc1) of the slice
  T* ring = hid + R * ldh;                // kRing x (BN, ldb) weight chunks
  const int split = blockIdx.x % S;
  const long long row0 = static_cast<long long>(blockIdx.x / S) * R;
  const int h0 = split * Hs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk1 = C / BK, nk2 = Hs / BK, nt1 = Hs / BN;
  const int total1 = nt1 * nk1, total = total1 + (C / BN) * nk2;
  const int nv = C / kVec;

  auto fetch = [&](int q) {
    T* dst = ring + (q % kRing) * BN * ldb;
    if (q < total1) {
      copy_tile_async(dst, ldb,
                      w1 + static_cast<size_t>(h0 + q / nk1 * BN) * C + q % nk1 * BK,
                      C, BN, BK, tid, kThreads);
    } else {
      q -= total1;
      copy_tile_async(dst, ldb,
                      w2 + static_cast<size_t>(q / nk2 * BN) * Hd + h0 + q % nk2 * BK,
                      Hd, BN, BK, tid, kThreads);
    }
  };

  // copy group 0: this warp's x rows; groups 1 .. kRing - 1: weight chunks
  // 0 .. kRing - 2
  const RowMap rows(R, warp, lane);
  const long long tok = row0 + rows.first + lane;
  const long long src = lane < rows.rows && tok < n_tokens ? tok * C : -1;
  copy_rows_async(a, lda, x, rows, nv, src);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < total) fetch(s);
    cp_async_commit();
  }
  cp_async_wait<kRing - 1>();
  __syncwarp();
  layer_norm_rows<Variance::kFast>(a, lda, ln_scale, ln_bias, rows, C, nv, src,
                                   eps);

  const int wm = R / 16;
  const int wr = (warp % wm) * 16, wc = (warp / wm) * 8 * NT;
  const long long left = n_tokens - (row0 + wr);
  const int rows_left = left < 16 ? static_cast<int>(left) : 16;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  int j = 0, kc = 0;  // column tile and k-chunk of chunk q in its pass
  for (int q = 0; q < total; ++q) {
    // chunk q landed; every warp is past chunk q - 1 (its buffer is free),
    // the first time past its LayerNorm, and at q = total1 past its last
    // writes of the hidden tile
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (q + kRing - 1 < total) fetch(q + kRing - 1);
    cp_async_commit();
    const T* bq = ring + (q % kRing) * BN * ldb + wc * ldb;
    const bool fc1 = q < total1;
    if (fc1)
      warp_chunk_mma<NT>(acc, a + wr * lda + kc * BK, lda, bq, ldb, BK, lane);
    else
      warp_chunk_mma<NT>(acc, hid + wr * ldh + kc * BK, ldh, bq, ldb, BK, lane);
    if (++kc < (fc1 ? nk1 : nk2)) continue;
    kc = 0;
    const int col = j * BN + wc;
    if (fc1) {
      const T* bj = b1 + h0 + col;
      store_warp_tile<NT>(hid + wr * ldh + col, ldh, acc, lane, 16,
                          [bj](float2 v, int, int c) {
                            const float2 b = load_pair(bj + c);
                            return make_float2(gelu_hidden<T>(v.x, b.x),
                                               gelu_hidden<T>(v.y, b.y));
                          });
      if (++j == nt1) j = 0;
    } else if (S > 1) {
      store_warp_tile<NT>(part + (split * static_cast<long long>(n_tokens) +
                                  row0 + wr) * C + col,
                          C, acc, lane, rows_left,
                          [](float2 v, int, int) { return v; });
      ++j;
    } else {
      const T* xr = x + (row0 + wr) * C + col;
      const T* bj = b2 + col;
      store_warp_tile<NT>(out + (row0 + wr) * C + col, C, acc, lane, rows_left,
                          [xr, bj, rows_left, C](float2 v, int r, int c) {
                            const float2 b = load_pair(bj + c);
                            const float2 xv = r < rows_left
                                                  ? load_pair(xr + r * C + c)
                                                  : make_float2(0.f, 0.f);
                            return make_float2(mlp_out<T>(v.x, b.x, xv.x),
                                               mlp_out<T>(v.y, b.y, xv.y));
                          });
      ++j;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
}

// sums the splits' partials in split order, then the epilogue; four
// elements a thread (C is a multiple of 16)
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    mlp_reduce_kernel(const float* __restrict__ part, const T* __restrict__ x,
                      const T* __restrict__ b2, T* __restrict__ out,
                      long long n, int C, int S) {
  const long long i =
      4 * (static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x);
  if (i >= n) return;
  float4 acc = __ldg(reinterpret_cast<const float4*>(part + i));
  for (int s = 1; s < S; ++s) {
    const float4 p = __ldg(reinterpret_cast<const float4*>(part + s * n + i));
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const int c = static_cast<int>(i % C);
  const float2 x01 = load_pair(x + i), x23 = load_pair(x + i + 2);
  const float2 b01 = load_pair(b2 + c), b23 = load_pair(b2 + c + 2);
  store_pair(out + i, mlp_out<T>(acc.x, b01.x, x01.x), mlp_out<T>(acc.y, b01.y, x01.y));
  store_pair(out + i + 2, mlp_out<T>(acc.z, b23.x, x23.x),
             mlp_out<T>(acc.w, b23.y, x23.y));
}

template <typename T, int NT>
int launch_nt(const T* x, const float* s, const float* t, const T* w1,
              const T* b1, const T* w2, const T* b2, T* out, float* part,
              int n_tokens, int C, int Hd, int R, int S, int BN, int BK,
              float eps, long long blocks, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_mlp_kernel<T, NT>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          x, s, t, w1, b1, w2, b2, out, part, n_tokens, C, Hd, R, S, BN, BK,
          eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(n_tokens) * C;
  const long long threads = n / 4;
  mlp_reduce_kernel<T><<<static_cast<unsigned>((threads + kReduceThreads - 1) /
                                               kReduceThreads),
                         kReduceThreads, 0, stream>>>(part, x, b2, out, n, C, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* s, const void* t, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out,
           void* part, int n_tokens, int C, int Hd, int R, int S, int BN,
           int BK, float eps, cudaStream_t stream) {
  if ((R != 16 && R != 32 && R != 64) || S <= 0 || Hd % S || BN <= 0 ||
      BN % 16 || C % BN || (Hd / S) % BN || (BK != 16 && BK != 32 && BK != 64) ||
      C % BK || (Hd / S) % BK || (R * BN) % 512 || (S > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(C, Hd, R, S, BN, BK);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_tokens + static_cast<long long>(R) - 1) / R * S;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const float* st = static_cast<const float*>(s);
  const float* tt = static_cast<const float*>(t);
  const T* w1t = static_cast<const T*>(w1);
  const T* b1t = static_cast<const T*>(b1);
  const T* w2t = static_cast<const T*>(w2);
  const T* b2t = static_cast<const T*>(b2);
  T* ot = static_cast<T*>(out);
  float* pt = static_cast<float*>(part);
#define K6_LAUNCH(NT)                                                        \
  return launch_nt<T, NT>(xt, st, tt, w1t, b1t, w2t, b2t, ot, pt, n_tokens, \
                          C, Hd, R, S, BN, BK, eps, blocks, smem, stream)
  switch (R * BN / 512) {  // n8 column tiles a warp holds
    case 2: K6_LAUNCH(2);
    case 4: K6_LAUNCH(4);
    case 6: K6_LAUNCH(6);
    case 8: K6_LAUNCH(8);
    case 12: K6_LAUNCH(12);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K6_LAUNCH
}

}  // namespace

// x (T, C) f32|bf16, ln scale / bias (C,) f32, w1 (Hd, C) and w2 (C, Hd)
// in nn.Linear's layout, b1 (Hd,), b2 (C,) and out (T, C), all of x's type
// but the LN params; all contiguous and 16-byte aligned.  C a multiple of
// 16 up to 1536.  The plan: `rows` (R) tokens and hidden slice Hd / S
// (`splits`) a block, column tiles of `cols` (BN), weight k-chunks of
// `k_chunk` (BK): R in {16, 32, 64}, BN a multiple of 16 dividing C and
// Hd / S, BK in {16, 32, 64} dividing C and Hd / S, R * BN / 512 in {2, 4,
// 6, 8, 12}, shared memory within a block's 227 KB; with S > 1, part is
// f32 scratch of (S, T, C).  Returns the CUDA error code of the launches
// (0 on success; cudaErrorInvalidValue for arguments it does not take).
extern "C" int fused_mlp_block(const void* x, const void* ln_scale,
                               const void* ln_bias, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               void* out, void* part, int n_tokens, int C,
                               int Hd, int rows, int splits, int cols,
                               int k_chunk, int dtype_code, float eps,
                               void* stream) {
  if (n_tokens <= 0 || C <= 0 || C % 16 || C > kMaxC || Hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kFloat32)
    return launch<float>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, part,
                         n_tokens, C, Hd, rows, splits, cols, k_chunk, eps, s);
  if (dtype_code == kBFloat16)
    return launch<__nv_bfloat16>(x, ln_scale, ln_bias, w1, b1, w2, b2, out,
                                 part, n_tokens, C, Hd, rows, splits, cols,
                                 k_chunk, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
