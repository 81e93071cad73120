// Kernel K2: the window-attention backward (the train path's VJP).
//
// Replaces nerf_rpn_tpu/ops/window_attention.py : _flash_bwd_kernel (the
// Pallas TPU kernel behind _flash_bwd_call, the custom VJP of
// flash_window_attention).  For every window w and head h, with q, k, v
// the head slices of qkv ([q heads | k heads | v heads]) and g = dout:
//   qs  = round_T(q * round_T(scale))
//   s   = qs k^T + bias[h] (+ mask[w % nW])             f32, minus row max
//   p   = e / sum(e)                                     f32
//   dv  = round_T(round_T(p)^T g)
//   dp  = g v^T                                          f32
//   ds  = p * (dp - rowsum(dp * p))                      f32
//   dq  = round_T((round_T(ds) k) * scale)
//   dk  = round_T(round_T(ds)^T qs)
//   dbias[h] = sum over w of ds                          f32, unrounded
// in the order of operations of the TPU kernel, products accumulated in
// f32.  dqkv is written in the q | k | v lane layout of qkv.
//
// What bounds it on the H100: at the Swin-S train stage 0 (2000 windows x
// 3 heads, N = 64, D = 32, bf16) it moves ~188 MB (qkv, dout and dqkv, the
// f32 shift mask) and does five 64 x 64 x 32 products per (window, head),
// ~7.9 GFLOP: far below the bf16 ridge point, so device-memory bytes bound
// it (~56 us).  The earlier body (one block per (window group, head), f32
// CUDA-core products reading two shared words per FMA, 2-byte loads with a
// divide per element, no overlap) was bound by shared-memory bandwidth at
// ~20x that.  This design:
//
// - Block: 4 warps for one head and a fixed run of windows, walked in
//   order (ops/window_attention.py backward_groups picks the number of
//   runs: the grid fills the SMs' resident slots, two blocks an SM at
//   least where the work allows).  Each warp owns 16 query rows for the
//   logits, dp and dq, and 16 key rows for dk and dv.  The block reads
//   bias[h] once, in the accumulator layout (registers for f32, a
//   thread-private shared slice for bf16), and keeps its dbias partial in
//   registers.
// - Loads: q, k, v and dout of window w + 1 are copied with 16-byte
//   cp.async into the second of two tile buffers (padded rows, as K1's)
//   before window w's products start, so they land behind them.  The copy
//   loops step (row, chunk) pairs without divisions.  The mask fragment of
//   mask[w % nW] is read once per window, while the copies land.
// - Products on the tensor cores: bf16 mma.sync m16n8k16 with f32
//   accumulation, operands from ldmatrix.  S = qs k^T (q is scaled in
//   place in its tile, as round_T(q * round_T(scale))), dp = g v^T; bias
//   and mask go into the S fragments and the softmax runs in registers;
//   ds in f32 registers; dq from round_T(ds) as the A fragment straight
//   from the accumulator layout.  round_T(p) and round_T(ds) are staged as
//   64 x 64 tiles in shared memory, and the transposed products dv =
//   round_T(p)^T g and dk = round_T(ds)^T qs read their A fragments with
//   ldmatrix.trans.  Products of bf16 operands are exact in f32, so only
//   the order of the f32 sums differs from the twin.
// - f32: the same five products in 3xTF32 mma.sync m16n8k8 (tf32 hi + lo
//   split, hi.hi + hi.lo + lo.hi), with K1's key permutation for the A
//   fragment taken from the accumulator.
// - Stores: each warp stages its rows of dq, dk and dv in its (dead) q, k
//   and v tile rows and writes them with 16-byte stores.
// - dbias is deterministic: each block writes one f32 partial (run, h,
//   64, 64) and a second kernel sums the partials over runs in a fixed
//   order (1, 2, 4 or 8 slices of 16 runs or more, each in run order,
//   then the slices in order).  No atomics, so two runs give the same
//   bits.
#include "mma_sm90.cuh"

namespace {

constexpr int kN = 64;              // tokens per 4x4x4 window
constexpr int kWarps = 4;           // 16 query (and key) rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 64;           // head width limit of this kernel
constexpr int kMaxSmem = 232448;    // dynamic shared memory of a block
constexpr size_t kSmemPerSM = 233472;  // an SM's 228 KB (1 KB more a block)
constexpr int kLdX = kN + 8;        // row stride of the staged p and ds tiles
constexpr int kReduceThreads = 256;  // a reduction block: columns x slices
constexpr int kMaxSlices = 8;        // slices of the runs it sums apart
constexpr int kRunsPerSlice = 16;    // at least, where there are enough runs

// bf16 keeps bias[h] in a shared-memory slice of each thread's own (its 32
// fragment values as 8 float4, laid out [8][kThreads]: no bank conflicts),
// so that three blocks an SM fit 168 registers; f32 keeps it in registers
template <typename T>
__host__ __device__ constexpr bool bias_in_smem() {
  return sizeof(T) == 2;
}

// shared memory of a block: two buffers of q, k, v, dout tiles, the staged
// round(p), round(ds), and for bf16 the bias slices;
// ops/window_attention.py mirrors it
template <typename T, int Dp>
constexpr size_t smem_bytes() {
  return (8 * static_cast<size_t>(kN) * tile_ld<T, Dp>() + 2 * kN * kLdX) *
             sizeof(T) +
         (bias_in_smem<T>() ? kN * kN * sizeof(float) : 0);
}

// blocks an SM holds by shared memory, at most 3 (the register budget)
template <typename T, int Dp>
constexpr int min_blocks() {
  constexpr size_t n = kSmemPerSM / (smem_bytes<T, Dp>() + 1024);
  return n >= 3 ? 3 : static_cast<int>(n);
}

// ---- bf16 products ------------------------------------------------------

// acc (16 x 64) = a[warp rows] b^T over Dp: the warp's 16 rows of tile a
// against all 64 rows of tile b
template <int Dp>
__device__ __forceinline__ void mm_rows_nt(float (&acc)[8][4],
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b, int warp,
                                           int lane) {
  constexpr int LD = tile_ld<__nv_bfloat16, Dp>();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Dp / 16; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, a + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                      ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x Dp) = round(x) b: x the warp's 16 x 64 accumulator registers
// (rounded to bf16 as the A fragment), b a 64-row tile
template <int Dp>
__device__ __forceinline__ void mm_regs_nn(float (&acc)[Dp / 8][4],
                                           const float (&x)[8][4],
                                           const __nv_bfloat16* b, int lane) {
  constexpr int LD = tile_ld<__nv_bfloat16, Dp>();
#pragma unroll
  for (int nt = 0; nt < Dp / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step
    uint32_t af[4];
    af[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    af[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    af[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    af[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < Dp / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                            (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], af, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x Dp) = x^T[warp rows] b: x a staged 64 x 64 tile (rows i,
// columns j) read transposed for the warp's 16 columns j, b a 64-row tile
template <int Dp>
__device__ __forceinline__ void mm_trans_nn(float (&acc)[Dp / 8][4],
                                            const __nv_bfloat16* x,
                                            const __nv_bfloat16* b, int warp,
                                            int lane) {
  constexpr int LD = tile_ld<__nv_bfloat16, Dp>();
#pragma unroll
  for (int nt = 0; nt < Dp / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 16 rows i a step
    uint32_t af[4];
    ldsm_x4_trans(af, x + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kLdX +
                          warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int dp = 0; dp < Dp / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                            (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], af, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], af, bf[2], bf[3]);
    }
  }
}

// ---- f32 products (3xTF32) ----------------------------------------------

template <int Dp>
__device__ __forceinline__ void mm_rows_nt(float (&acc)[8][4], const float* a,
                                           const float* b, int warp,
                                           int lane) {
  constexpr int LD = tile_ld<float, Dp>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const float* ar = a + (warp * 16 + g) * LD + t;
#pragma unroll
  for (int ks = 0; ks < Dp / 8; ++ks) {
    uint32_t ah[4], al[4];
    split_tf32(ar[ks * 8], ah[0], al[0]);               // (g, t)
    split_tf32(ar[8 * LD + ks * 8], ah[1], al[1]);      // (g + 8, t)
    split_tf32(ar[ks * 8 + 4], ah[2], al[2]);           // (g, t + 4)
    split_tf32(ar[8 * LD + ks * 8 + 4], ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* br = b + (nt * 8 + g) * LD + ks * 8 + t;
      uint32_t bh[2], bl[2];
      split_tf32(br[0], bh[0], bl[0]);
      split_tf32(br[4], bh[1], bl[1]);
      mma_3xtf32(acc[nt], ah, al, bh, bl);
    }
  }
}

// the tf32 A fragment's column t is key 2t of the 8-key step and column
// t + 4 key 2t + 1 (the b rows follow the same permutation)
template <int Dp>
__device__ __forceinline__ void mm_regs_nn(float (&acc)[Dp / 8][4],
                                           const float (&x)[8][4],
                                           const float* b, int lane) {
  constexpr int LD = tile_ld<float, Dp>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < Dp / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {  // 8 keys a step
    uint32_t ah[4], al[4];
    split_tf32(x[kt][0], ah[0], al[0]);  // (g, key 2t)
    split_tf32(x[kt][2], ah[1], al[1]);  // (g + 8, key 2t)
    split_tf32(x[kt][1], ah[2], al[2]);  // (g, key 2t + 1)
    split_tf32(x[kt][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
    const float* br = b + (kt * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int nt = 0; nt < Dp / 8; ++nt) {
      uint32_t bh[2], bl[2];
      split_tf32(br[nt * 8], bh[0], bl[0]);       // key 2t, column g
      split_tf32(br[LD + nt * 8], bh[1], bl[1]);  // key 2t + 1, column g
      mma_3xtf32(acc[nt], ah, al, bh, bl);
    }
  }
}

template <int Dp>
__device__ __forceinline__ void mm_trans_nn(float (&acc)[Dp / 8][4],
                                            const float* x, const float* b,
                                            int warp, int lane) {
  constexpr int LD = tile_ld<float, Dp>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < Dp / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const float* xr = x + t * kLdX + warp * 16 + g;
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {  // 8 rows i a step
    uint32_t ah[4], al[4];
    split_tf32(xr[kt * 8 * kLdX], ah[0], al[0]);              // (j g, i t)
    split_tf32(xr[kt * 8 * kLdX + 8], ah[1], al[1]);          // (j g + 8, i t)
    split_tf32(xr[(kt * 8 + 4) * kLdX], ah[2], al[2]);        // (j g, i t + 4)
    split_tf32(xr[(kt * 8 + 4) * kLdX + 8], ah[3], al[3]);    // (j g + 8, i t + 4)
    const float* br = b + (kt * 8 + t) * LD + g;
#pragma unroll
    for (int nt = 0; nt < Dp / 8; ++nt) {
      uint32_t bh[2], bl[2];
      split_tf32(br[nt * 8], bh[0], bl[0]);           // row i t, column g
      split_tf32(br[4 * LD + nt * 8], bh[1], bl[1]);  // row i t + 4
      mma_3xtf32(acc[nt], ah, al, bh, bl);
    }
  }
}

// ---- the kernel -----------------------------------------------------------

// the warp's 16 rows of the q tile scaled in place: round_T(q * s)
template <int Dp>
__device__ __forceinline__ void scale_rows(__nv_bfloat16* q, float s,
                                           int lane) {
  constexpr int LD = tile_ld<__nv_bfloat16, Dp>();
  constexpr int kRow = Dp / 8;  // 16-byte units a row
#pragma unroll
  for (int idx = lane; idx < 16 * kRow; idx += 32) {
    uint4* p = reinterpret_cast<uint4*>(q + (idx / kRow) * LD) + idx % kRow;
    uint4 u = *p;
    uint32_t* r = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(r[e]);
      r[e] = pack_bf16(f.x * s, f.y * s);
    }
    *p = u;
  }
}

template <int Dp>
__device__ __forceinline__ void scale_rows(float* q, float s, int lane) {
  constexpr int LD = tile_ld<float, Dp>();
  constexpr int kRow = Dp / 4;
#pragma unroll
  for (int idx = lane; idx < 16 * kRow; idx += 32) {
    float4* p = reinterpret_cast<float4*>(q + (idx / kRow) * LD) + idx % kRow;
    float4 f = *p;
    f.x *= s;
    f.y *= s;
    f.z *= s;
    f.w *= s;
    *p = f;
  }
}

// Block: head blockIdx.x % H and the run grp = blockIdx.x / H of windows
// [grp * W / n_groups, (grp + 1) * W / n_groups), in order.  Shared memory:
// two buffers of q, k, v, dout tiles (64 x tile_ld rows each), then the
// staged round(p) and round(ds) (64 x kLdX), then (bf16) the bias slices.
template <typename T, int Dp>
__global__ void __launch_bounds__(kThreads, min_blocks<T, Dp>())
    window_attention_bwd_kernel(const T* __restrict__ qkv,
                                const T* __restrict__ dout,
                                const float* __restrict__ bias,
                                const float* __restrict__ mask,
                                T* __restrict__ dqkv,
                                float* __restrict__ dbias_part, int W, int H,
                                int C, int D, int nW, int n_groups,
                                float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int LD = tile_ld<T, Dp>();
  constexpr int kTile = kN * LD;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  T* xp = smem + 8 * kTile;             // round(p)
  T* xs = xp + kN * kLdX;               // round(ds)

  const int grp = blockIdx.x / H;
  const int h = blockIdx.x - grp * H;
  const int w_begin = static_cast<int>(static_cast<long long>(grp) * W / n_groups);
  const int w_end = static_cast<int>(static_cast<long long>(grp + 1) * W / n_groups);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this lane's rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);           // and columns c0, c0 + 1 of 8
  const int chunks = D / kVec;             // 16-byte copies per tile row
  const size_t row_qkv = 3 * static_cast<size_t>(C);

  // zero the pad columns D .. Dp of the eight tiles (no copy writes there)
  if (D < Dp) {
    const int pad = Dp - D;
    for (int idx = tid; idx < 8 * kN * pad; idx += kThreads)
      smem[(idx / pad) * LD + D + idx % pad] = from_f32<T>(0.f);
  }

  // one copy group per window: q, k, v and dout rows of 64 x D of head h.
  // Thread tid takes the (row, 16-byte chunk) pairs tid, tid + kThreads,
  // ... of each tile, stepped without divisions
  const int row0 = tid / chunks, chunk0 = tid % chunks;
  const int row_step = kThreads / chunks, chunk_step = kThreads % chunks;
  auto load = [&](int w, int buf) {
    T* dst = smem + buf * 4 * kTile;
    const T* src = qkv + static_cast<size_t>(w) * kN * row_qkv + h * D;
    const T* src_g = dout + static_cast<size_t>(w) * kN * C + h * D;
    for (int i = row0, c = chunk0; i < kN;) {
      T* d = dst + i * LD + c * kVec;
      const T* s = src + i * row_qkv + c * kVec;
      cp_async16(d, s);
      cp_async16(d + kTile, s + C);
      cp_async16(d + 2 * kTile, s + 2 * C);
      cp_async16(d + 3 * kTile, src_g + static_cast<size_t>(i) * C + c * kVec);
      i += row_step;
      c += chunk_step;
      if (c >= chunks) {
        c -= chunks;
        ++i;
      }
    }
    cp_async_commit();
  };
  load(w_begin, 0);

  // bias[h] in this lane's fragment positions, and the dbias partial
  float4 breg[8];
  float4* bsm = reinterpret_cast<float4*>(xs + kN * kLdX);  // bf16: [8][kThreads]
  float db[8][4];
  const float* brow = bias + static_cast<size_t>(h) * kN * kN;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + c0;
    const float2 b0 = __ldg(reinterpret_cast<const float2*>(brow + r0 * kN + c));
    const float2 b1 = __ldg(reinterpret_cast<const float2*>(brow + (r0 + 8) * kN + c));
    const float4 b = make_float4(b0.x, b0.y, b1.x, b1.y);
    if constexpr (bias_in_smem<T>())
      bsm[nt * kThreads + tid] = b;
    else
      breg[nt] = b;
#pragma unroll
    for (int e = 0; e < 4; ++e) db[nt][e] = 0.f;
  }
  const float scale_q = round_to<T>(scale);

  int buf = 0;
  for (int w = w_begin; w < w_end; ++w, buf ^= 1) {
    // the mask fragment of this window, read while the copies land
    float mk[8][4];
    if (mask) {
      const float* mrow = mask + static_cast<size_t>(w % nW) * kN * kN;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = nt * 8 + c0;
        const float2 m0 = __ldg(reinterpret_cast<const float2*>(mrow + r0 * kN + c));
        const float2 m1 =
            __ldg(reinterpret_cast<const float2*>(mrow + (r0 + 8) * kN + c));
        mk[nt][0] = m0.x;
        mk[nt][1] = m0.y;
        mk[nt][2] = m1.x;
        mk[nt][3] = m1.y;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // window w's tiles have landed; buffer buf ^ 1 is free
    if (w + 1 < w_end) load(w + 1, buf ^ 1);

    T* q = smem + buf * 4 * kTile;
    T* k = q + kTile;
    T* v = k + kTile;
    T* g = v + kTile;
    scale_rows<Dp>(q + warp * 16 * LD, scale_q, lane);
    __syncwarp();

    // s = qs k^T + bias (+ mask), in the twin's order; softmax in registers
    float s[8][4];
    mm_rows_nt<Dp>(s, q, k, warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float4 b;
      if constexpr (bias_in_smem<T>())
        b = bsm[nt * kThreads + tid];
      else
        b = breg[nt];
      s[nt][0] += b.x;
      s[nt][1] += b.y;
      s[nt][2] += b.z;
      s[nt][3] += b.w;
      if (mask)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += mk[nt][e];
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mx0);
      s[nt][1] = expf(s[nt][1] - mx0);
      s[nt][2] = expf(s[nt][2] - mx1);
      s[nt][3] = expf(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    // p = e * (1 / sum): within an f32 ulp of e / sum
    const float inv0 = __frcp_rn(sum0), inv1 = __frcp_rn(sum1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] *= inv0;
      s[nt][1] *= inv0;
      s[nt][2] *= inv1;
      s[nt][3] *= inv1;
      store_pair(xp + r0 * kLdX + nt * 8 + c0, s[nt][0], s[nt][1]);
      store_pair(xp + (r0 + 8) * kLdX + nt * 8 + c0, s[nt][2], s[nt][3]);
    }

    // dp = g v^T; ds = p (dp - rowsum(dp p)) in f32, into dp
    float dp[8][4];
    mm_rows_nt<Dp>(dp, g, v, warp, lane);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      rs0 += dp[nt][0] * s[nt][0] + dp[nt][1] * s[nt][1];
      rs1 += dp[nt][2] * s[nt][2] + dp[nt][3] * s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      dp[nt][0] = s[nt][0] * (dp[nt][0] - rs0);
      dp[nt][1] = s[nt][1] * (dp[nt][1] - rs0);
      dp[nt][2] = s[nt][2] * (dp[nt][2] - rs1);
      dp[nt][3] = s[nt][3] * (dp[nt][3] - rs1);
#pragma unroll
      for (int e = 0; e < 4; ++e) db[nt][e] += dp[nt][e];
      store_pair(xs + r0 * kLdX + nt * 8 + c0, dp[nt][0], dp[nt][1]);
      store_pair(xs + (r0 + 8) * kLdX + nt * 8 + c0, dp[nt][2], dp[nt][3]);
    }

    // dq = round(ds) k (scaled at the store)
    float dq[Dp / 8][4];
    mm_regs_nn<Dp>(dq, dp, k, lane);
    __syncthreads();  // round(p), round(ds) and every row of qs are staged

    // dv = round(p)^T g and dk = round(ds)^T qs for the warp's 16 keys
    float dv[Dp / 8][4], dk[Dp / 8][4];
    mm_trans_nn<Dp>(dv, xp, g, warp, lane);
    mm_trans_nn<Dp>(dk, xs, q, warp, lane);
    __syncthreads();  // no warp reads this buffer's tiles or xp, xs now

    // stage the warp's rows of dq, dk, dv in its q, k, v rows, then
    // 16-byte stores into the [q | k | v] lane layout of dqkv
#pragma unroll
    for (int nt = 0; nt < Dp / 8; ++nt) {
      const int c = nt * 8 + c0;
      store_pair(q + r0 * LD + c, dq[nt][0] * scale, dq[nt][1] * scale);
      store_pair(q + (r0 + 8) * LD + c, dq[nt][2] * scale, dq[nt][3] * scale);
      store_pair(k + r0 * LD + c, dk[nt][0], dk[nt][1]);
      store_pair(k + (r0 + 8) * LD + c, dk[nt][2], dk[nt][3]);
      store_pair(v + r0 * LD + c, dv[nt][0], dv[nt][1]);
      store_pair(v + (r0 + 8) * LD + c, dv[nt][2], dv[nt][3]);
    }
    __syncwarp();
    T* out = dqkv + (static_cast<size_t>(w) * kN + warp * 16) * row_qkv + h * D;
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      const T* src = q + which * kTile + warp * 16 * LD;
      T* dst = out + which * C;
      for (int i = lane / chunks, c = lane % chunks; i < 16;) {
        *reinterpret_cast<uint4*>(dst + i * row_qkv + c * kVec) =
            *reinterpret_cast<const uint4*>(src + i * LD + c * kVec);
        i += 32 / chunks;
        c += 32 % chunks;
        if (c >= chunks) {
          c -= chunks;
          ++i;
        }
      }
    }
  }

  float* part = dbias_part + (static_cast<size_t>(grp) * H + h) * kN * kN;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + c0;
    store_pair(part + r0 * kN + c, db[nt][0], db[nt][1]);
    store_pair(part + (r0 + 8) * kN + c, db[nt][2], db[nt][3]);
  }
}

// dbias[x] = the sum over runs of part[run, x] in a fixed order: with S =
// blockDim.y slices, slice y sums runs [y * n / S, (y + 1) * n / S) in run
// order, then the S slice sums are added in slice order.  A warp reads 32
// adjacent entries of a run.
__global__ void __launch_bounds__(kReduceThreads)
    dbias_reduce_kernel(const float* __restrict__ part,
                        float* __restrict__ dbias, int n_groups, int size) {
  __shared__ float sums[kReduceThreads];
  const int cols = blockDim.x, slices = blockDim.y;
  const int x = blockIdx.x * cols + threadIdx.x;
  const int y = threadIdx.y;
  float acc = 0.f;
  if (x < size) {
    const int end = (y + 1) * n_groups / slices;
#pragma unroll 4
    for (int grp = y * n_groups / slices; grp < end; ++grp)
      acc += part[static_cast<size_t>(grp) * size + x];
  }
  sums[y * cols + threadIdx.x] = acc;
  __syncthreads();
  if (y == 0 && x < size) {
    for (int i = 1; i < slices; ++i) acc += sums[i * cols + threadIdx.x];
    dbias[x] = acc;
  }
}

template <typename T, int Dp>
int launch_dp(const T* qkv, const T* dout, const float* bias,
              const float* mask, T* dqkv, float* dbias_part, float* dbias,
              int W, int H, int C, int D, int nW, int n_groups, float scale,
              cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, Dp>();
  static_assert(smem <= static_cast<size_t>(kMaxSmem), "tiles exceed a block");
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_bwd_kernel<T, Dp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_bwd_kernel<T, Dp><<<n_groups * H, kThreads, smem, stream>>>(
      qkv, dout, bias, mask, dqkv, dbias_part, W, H, C, D, nW, n_groups, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = H * kN * kN;
  int slices = 1;  // a power of two, so that a warp stays in one slice
  while (2 * slices <= kMaxSlices && 2 * slices * kRunsPerSlice <= n_groups)
    slices *= 2;
  const int cols = kReduceThreads / slices;
  dbias_reduce_kernel<<<(size + cols - 1) / cols, dim3(cols, slices), 0,
                        stream>>>(dbias_part, dbias, n_groups, size);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* qkv, const void* dout, const void* bias,
           const void* mask, void* dqkv, void* dbias_part, void* dbias, int W,
           int H, int C, int nW, int n_groups, float scale,
           cudaStream_t stream) {
  const int D = C / H;
  if ((D * sizeof(T)) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  T* o = static_cast<T*>(dqkv);
  float* part = static_cast<float*>(dbias_part);
  float* db = static_cast<float*>(dbias);
  if (D <= 16)
    return launch_dp<T, 16>(q, g, b, m, o, part, db, W, H, C, D, nW, n_groups,
                            scale, stream);
  if (D <= 32)
    return launch_dp<T, 32>(q, g, b, m, o, part, db, W, H, C, D, nW, n_groups,
                            scale, stream);
  if (D <= 48)
    return launch_dp<T, 48>(q, g, b, m, o, part, db, W, H, C, D, nW, n_groups,
                            scale, stream);
  return launch_dp<T, 64>(q, g, b, m, o, part, db, W, H, C, D, nW, n_groups,
                          scale, stream);
}

}  // namespace

// qkv (W, 64, 3C) f32|bf16, dout (W, 64, C) of the qkv type, bias
// (H, 64, 64) f32, mask (nW, 64, 64) f32 or NULL; out dqkv (W, 64, 3C) of
// the qkv type, dbias (H, 64, 64) f32, and scratch dbias_part
// (n_groups, H, 64, 64) f32 for the per-run partial sums; all contiguous
// and 16-byte aligned, C / H <= 64 a multiple of 16 bytes, 1 <= n_groups
// <= W window runs.  Launches the per-(run, head) kernel and the
// reduction.  Returns the CUDA error code of the launches (0 on success).
extern "C" int window_attention_bwd(const void* qkv, const void* dout,
                                    const void* bias, const void* mask,
                                    void* dqkv, void* dbias_part, void* dbias,
                                    int W, int H, int C, int nW, int n_groups,
                                    int dtype_code, float scale,
                                    void* stream) {
  if (W <= 0 || H <= 0 || C % H != 0 || C / H <= 0 || C / H > kMaxD ||
      nW <= 0 || W % nW != 0 || n_groups <= 0 || n_groups > W)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kFloat32)
    return launch<float>(qkv, dout, bias, mask, dqkv, dbias_part, dbias, W, H,
                         C, nW, n_groups, scale, s);
  if (dtype_code == kBFloat16)
    return launch<__nv_bfloat16>(qkv, dout, bias, mask, dqkv, dbias_part,
                                 dbias, W, H, C, nW, n_groups, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
