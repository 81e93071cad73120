// Kernels K1 and K4: eval window attention, one body in two modes.
//
// K1 replaces nerf_rpn_tpu/ops/window_attention.py : _kernel_v2 (the Pallas
// TPU kernel behind fused_qkv_window_attention).  From the packed qkv
// (W, 64, 3C), [q heads | k heads | v heads] along the last axis, for every
// window w and head h:
//   out[w, :, h*D:(h+1)*D] = softmax(q k^T + bias[h] (+ mask[w % nW])) v
// with q scaled in the input type, logits and softmax in f32, P cast to the
// input type before P.V, f32 accumulation, output in the input type.
//
// K4 replaces nerf_rpn_tpu/ops/window_attention.py : _kernel (the Pallas TPU
// kernel behind fused_window_attention).  q, k, v are (W, H, 64, D) views
// with any 16-byte-aligned strides and a contiguous D axis; the shift mask
// is a table of P distinct (64, 64) patterns and a pattern id per window:
//   out[w, h] = softmax(q * D^-1/2 k^T + bias[h] + table[ids[w]]) v
// with the logits, the softmax and P in f32, and only the output rounded to
// the input type.
//
// What bounds them on the H100: at the Swin-S bench shapes (stage 0: 1521
// windows x 3 heads, N = 64, D = 32) the op moves ~56 MB of bf16 qkv and
// ~19 MB of output and does ~2.4 GFLOP of products, far below the bf16
// ridge point: device-memory bytes bound it.  The earlier body (one block
// per (window, head), 2-byte loads, f32 FMAs on the CUDA cores reading two
// shared words per FMA) was bound by shared-memory bandwidth instead, at
// ~10x its byte bound.  This design keeps the products off that path:
//
// - Block: 4 warps for one window and a group of G heads (the wrapper's
//   planner picks G: it divides H, G heads' tiles fit its shared-memory
//   budget, and the grid keeps two blocks per SM).  Each warp owns 16 query
//   rows of every head of the group.
// - Loads: each head's q, k, v columns are copied with 16-byte cp.async
//   into shared tiles, one copy group per head, all issued up front, so the
//   loads of the later heads overlap the products of the earlier ones.  The
//   head width is zero-padded to Dp (a multiple of 16) so one body takes
//   every D <= 64; rows carry 16 bytes of pad so that ldmatrix and the
//   fragment loads hit no bank twice.
// - bf16 products: S = Q K^T and O = P V with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate), operands from ldmatrix (V through ldmatrix.trans).  The
//   S accumulator layout is P's A-fragment layout, so P never leaves the
//   registers.  K1 rounds q * scale to bf16 on the A fragment and P to bf16,
//   its stated arithmetic.  K4 multiplies the f32 logits by the scale after
//   the product (the bf16 q k products are exact in f32, so this differs
//   from the twin's (q * scale) k only by f32 rounding), and keeps P in f32
//   by splitting it as hi = bf16(P), lo = bf16(P - hi) and accumulating both
//   products (P held to ~2^-17 relative).
// - f32 products: 3xTF32 mma.sync m16n8k8 (each operand split into tf32
//   hi + lo; hi*hi + hi*lo + lo*hi), which keeps f32 parity (1e-5 of the
//   output's scale) at a fraction of the cost of CUDA-core FMAs.  P's
//   accumulator pairs map onto the tf32 A fragment by permuting the key
//   index inside each 8-key step (the V rows follow the same permutation).
// - Bias and mask go straight into the accumulator fragments as 8-byte
//   pairs through the read-only cache.  The mask is mask[w % nW] for K1 and
//   table[ids[w]] for K4 (the block loads its own pattern id: no scalar
//   prefetch on Hopper); its fragment values are read once a block, while
//   the copies land, and held in registers for every head of the group.
// - Softmax in registers: row max and sum over the 4 lanes of a fragment
//   row with shuffles, expf in f32, P = e * (1 / sum) (within an f32 ulp of
//   the twins' e / sum).
//
// What is left, measured on an H100 (PERF.md): the copies and stores alone
// run at ~2/3 of the byte bound's rate, and the f32 bias, read from L2 for
// every (window, head) (16 KB, more than the head's bf16 q, k, v), costs
// about as much again; a block that keeps the bias of its heads for
// several windows is the next step.
// - Output: each warp stages its 16 rows of O in its own (now dead) q rows
//   and writes them with 16-byte stores: (W, 64, C) for K1, (W, 64, H, D)
//   through the given strides for K4 (so the proj input is a free view).
#include "mma_sm90.cuh"

namespace {

constexpr int kN = 64;                // tokens per 4x4x4 window
constexpr int kWarps = 4;             // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 64;             // head width limit of this kernel
constexpr int kMaxGroup = 8;          // copy groups a block can wait on
constexpr int kMaxSmem = 232448;      // dynamic shared memory of a block

template <typename T, int Dp>
constexpr size_t head_tile_bytes() {
  return 3 * static_cast<size_t>(kN) * tile_ld<T, Dp>() * sizeof(T);
}

// element strides of a (W, H, N, D) operand whose D axis is contiguous
struct Strides {
  long long w, h, n;
  __device__ __forceinline__ long long at(int wi, int hi, int ni) const {
    return wi * w + hi * h + ni * n;
  }
};

// The fragments below follow mma.sync's layouts: lane = 4 * g + t; an f32
// accumulator tile (16 x 8) holds rows g and g + 8, columns 2t and 2t + 1.
// A warp's S is 8 such tiles (its 16 query rows x 64 keys).

// S = (q * scale) k^T (K1) or (q k^T) * scale (K4), bf16 in, f32 out
template <bool kTable, int Dp>
__device__ __forceinline__ void logits(float (&s)[8][4],
                                       const __nv_bfloat16* q,
                                       const __nv_bfloat16* k, float scale,
                                       int warp, int lane) {
  constexpr int LD = tile_ld<__nv_bfloat16, Dp>();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Dp / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, q + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                   ks * 16 + (lane >> 4) * 8);
    if (!kTable) {  // K1: q * scale rounded to bf16, as q * bf16(scale)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = unpack_bf16(a[r]);
        a[r] = pack_bf16(f.x * scale, f.y * scale);
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, k + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ks * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
  if (kTable) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
  }
}

// S = (q * scale) k^T in f32 (both modes), 3xTF32
template <bool kTable, int Dp>
__device__ __forceinline__ void logits(float (&s)[8][4], const float* q,
                                       const float* k, float scale, int warp,
                                       int lane) {
  constexpr int LD = tile_ld<float, Dp>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const float* qa = q + (warp * 16 + g) * LD + t;
#pragma unroll
  for (int ks = 0; ks < Dp / 8; ++ks) {
    uint32_t ah[4], al[4];
    split_tf32(qa[ks * 8] * scale, ah[0], al[0]);               // (g, t)
    split_tf32(qa[8 * LD + ks * 8] * scale, ah[1], al[1]);      // (g + 8, t)
    split_tf32(qa[ks * 8 + 4] * scale, ah[2], al[2]);           // (g, t + 4)
    split_tf32(qa[8 * LD + ks * 8 + 4] * scale, ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* kb = k + (nt * 8 + g) * LD + ks * 8 + t;
      uint32_t bh[2], bl[2];
      split_tf32(kb[0], bh[0], bl[0]);
      split_tf32(kb[4], bh[1], bl[1]);
      mma_3xtf32(s[nt], ah, al, bh, bl);
    }
  }
}

// O = P v with P from the S registers: K1 rounds P to bf16; K4 keeps it in
// f32 as hi + lo
template <bool kTable, int Dp>
__device__ __forceinline__ void attend(float (&o)[Dp / 8][4],
                                       const float (&p)[8][4],
                                       const __nv_bfloat16* v, int lane) {
  constexpr int LD = tile_ld<__nv_bfloat16, Dp>();
#pragma unroll
  for (int nt = 0; nt < Dp / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step
    uint32_t hi[4], lo[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < Dp / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, v + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                           (lane >> 4) * 8);
      if (kTable) {
        mma_bf16(o[2 * dp], lo, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      }
      mma_bf16(o[2 * dp], hi, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
    }
  }
}

// O = P v in f32 (both modes), 3xTF32; the tf32 A fragment's column t is
// key 2t of the step and column t + 4 key 2t + 1
template <bool kTable, int Dp>
__device__ __forceinline__ void attend(float (&o)[Dp / 8][4],
                                       const float (&p)[8][4], const float* v,
                                       int lane) {
  constexpr int LD = tile_ld<float, Dp>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < Dp / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {  // 8 keys a step
    uint32_t ah[4], al[4];
    split_tf32(p[kt][0], ah[0], al[0]);  // (g, key 2t)
    split_tf32(p[kt][2], ah[1], al[1]);  // (g + 8, key 2t)
    split_tf32(p[kt][1], ah[2], al[2]);  // (g, key 2t + 1)
    split_tf32(p[kt][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
    const float* vb = v + (kt * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int nt = 0; nt < Dp / 8; ++nt) {
      uint32_t bh[2], bl[2];
      split_tf32(vb[nt * 8], bh[0], bl[0]);       // key 2t, column g
      split_tf32(vb[LD + nt * 8], bh[1], bl[1]);  // key 2t + 1, column g
      mma_3xtf32(o[nt], ah, al, bh, bl);
    }
  }
}

// kTable = false: K1 (mask[w % nW] or none); kTable = true: K4
// (table[ids[w]]).  Block: window blockIdx.x / (H / G), heads
// h0 .. h0 + G - 1 with h0 = (blockIdx.x % (H / G)) * G.  Shared memory:
// G heads x (q, k, v) tiles of 64 x tile_ld rows.
template <typename T, bool kTable, int Dp>
__global__ void __launch_bounds__(kThreads, 4)
    window_attention_kernel(const T* __restrict__ qg, const T* __restrict__ kg,
                            const T* __restrict__ vg, Strides sq, Strides sk,
                            Strides sv, Strides so,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            const int* __restrict__ ids, T* __restrict__ out,
                            int H, int D, int G, int nW, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int LD = tile_ld<T, Dp>();
  constexpr int kTile = kN * LD;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  const int per_window = H / G;
  const int w = blockIdx.x / per_window;
  const int h0 = (blockIdx.x % per_window) * G;
  const int tid = threadIdx.x;
  const int chunks = D / kVec;  // 16-byte copies per tile row

  // zero the pad columns D .. Dp of every tile (no copy writes there)
  if (D < Dp) {
    const int pad = Dp - D;
    for (int idx = tid; idx < 3 * G * kN * pad; idx += kThreads)
      smem[(idx / pad) * LD + D + idx % pad] = from_f32<T>(0.f);
  }
  // one copy group per head: q, k, v rows of 64 x D.  Thread tid takes
  // the (row, 16-byte chunk) pairs tid, tid + kThreads, ... of each tile,
  // stepped without divisions
  const int row0 = tid / chunks, chunk0 = tid % chunks;
  const int row_step = kThreads / chunks, chunk_step = kThreads % chunks;
  for (int g = 0; g < G; ++g) {
    const int h = h0 + g;
    T* tile = smem + 3 * g * kTile;
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      const Strides& st = which == 0 ? sq : which == 1 ? sk : sv;
      const T* src = (which == 0 ? qg : which == 1 ? kg : vg) + st.at(w, h, 0);
      T* dst = tile + which * kTile;
      for (int i = row0, c = chunk0; i < kN;) {
        cp_async16(dst + i * LD + c * kVec, src + i * st.n + c * kVec);
        i += row_step;
        c += chunk_step;
        if (c >= chunks) {
          c -= chunks;
          ++i;
        }
      }
    }
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this lane's rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);           // and columns c0, c0 + 1 of 8
  const float scale_q = kTable ? scale : round_to<T>(scale);
  // the mask rows of this lane's fragments, held across the block's heads
  // (read while the copies land); zero without a mask
  float mk[8][4] = {};
  if (mask) {
    const float* mrow =
        mask + static_cast<size_t>(kTable ? ids[w] : w % nW) * kN * kN;
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

  for (int g = 0; g < G; ++g) {
    cp_async_wait_upto(G - 1 - g);
    __syncthreads();
    T* q = smem + 3 * g * kTile;
    const T* k = q + kTile;
    const T* v = k + kTile;

    float s[8][4];
    logits<kTable, Dp>(s, q, k, scale_q, warp, lane);
    // + bias[h] (+ mask), in the twins' order
    const float* brow = bias + static_cast<size_t>(h0 + g) * kN * kN;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + c0;
      const float2 b0 = __ldg(reinterpret_cast<const float2*>(brow + r0 * kN + c));
      const float2 b1 =
          __ldg(reinterpret_cast<const float2*>(brow + (r0 + 8) * kN + c));
      s[nt][0] += b0.x;
      s[nt][1] += b0.y;
      s[nt][2] += b1.x;
      s[nt][3] += b1.y;
      if (mask) {
        s[nt][0] += mk[nt][0];
        s[nt][1] += mk[nt][1];
        s[nt][2] += mk[nt][2];
        s[nt][3] += mk[nt][3];
      }
    }

    // softmax over each row's 64 keys: 16 values a lane, 4 lanes a row
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
    // P = e * (1 / sum): within an f32 ulp of e / sum, without 32 IEEE
    // divisions a lane
    const float inv0 = __frcp_rn(sum0), inv1 = __frcp_rn(sum1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] *= inv0;
      s[nt][1] *= inv0;
      s[nt][2] *= inv1;
      s[nt][3] *= inv1;
    }

    float o[Dp / 8][4];
    attend<kTable, Dp>(o, s, v, lane);

    // stage this warp's 16 rows in its own q rows, then 16-byte stores
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < Dp / 8; ++nt) {
      store_pair(q + r0 * LD + nt * 8 + c0, o[nt][0], o[nt][1]);
      store_pair(q + (r0 + 8) * LD + nt * 8 + c0, o[nt][2], o[nt][3]);
    }
    __syncwarp();
    T* dst = out + so.at(w, h0 + g, 0);
    for (int i = warp * 16 + lane / chunks, c = lane % chunks; i < warp * 16 + 16;) {
      *reinterpret_cast<uint4*>(dst + i * so.n + c * kVec) =
          *reinterpret_cast<const uint4*>(q + i * LD + c * kVec);
      i += 32 / chunks;
      c += 32 % chunks;
      if (c >= chunks) {
        c -= chunks;
        ++i;
      }
    }
  }
}

template <typename T, bool kTable, int Dp>
int launch_dp(const T* q, const T* k, const T* v, Strides sq, Strides sk,
              Strides sv, Strides so, const float* bias, const float* mask,
              const int* ids, T* out, int W, int H, int D, int G, int nW,
              float scale, cudaStream_t stream) {
  const size_t smem = head_tile_bytes<T, Dp>() * G;
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T, kTable, Dp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_kernel<T, kTable, Dp>
      <<<W * (H / G), kThreads, smem, stream>>>(q, k, v, sq, sk, sv, so, bias,
                                                mask, ids, out, H, D, G, nW,
                                                scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kTable>
int launch(const void* q, const void* k, const void* v, Strides sq, Strides sk,
           Strides sv, Strides so, const void* bias, const void* mask,
           const int* ids, void* out, int W, int H, int D, int G, int nW,
           float scale, cudaStream_t stream) {
  if (W <= 0 || H <= 0 || G <= 0 || G > kMaxGroup || H % G != 0 || D <= 0 ||
      D > kMaxD || (D * sizeof(T)) % 16 != 0 || nW <= 0 || !bias)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  T* o = static_cast<T*>(out);
  if (D <= 16)
    return launch_dp<T, kTable, 16>(qt, kt, vt, sq, sk, sv, so, b, m, ids, o,
                                    W, H, D, G, nW, scale, stream);
  if (D <= 32)
    return launch_dp<T, kTable, 32>(qt, kt, vt, sq, sk, sv, so, b, m, ids, o,
                                    W, H, D, G, nW, scale, stream);
  if (D <= 48)
    return launch_dp<T, kTable, 48>(qt, kt, vt, sq, sk, sv, so, b, m, ids, o,
                                    W, H, D, G, nW, scale, stream);
  return launch_dp<T, kTable, 64>(qt, kt, vt, sq, sk, sv, so, b, m, ids, o, W,
                                  H, D, G, nW, scale, stream);
}

}  // namespace

// K1.  qkv (W, 64, 3C) f32|bf16, bias (H, 64, 64) f32, mask (nW, 64, 64)
// f32 or NULL, out (W, 64, C) of the qkv type; all contiguous and 16-byte
// aligned, C / H a multiple of 16 bytes; `group` heads per block (divides
// H, <= 8).  Returns the CUDA error code of the launch (0 on success).
extern "C" int window_attention_fwd(const void* qkv, const void* bias,
                                    const void* mask, void* out, int W, int H,
                                    int C, int nW, int group, int dtype_code,
                                    float scale, void* stream) {
  if (H <= 0 || C % H != 0 || nW <= 0 || W % nW != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = C / H;
  const Strides sqkv{static_cast<long long>(kN) * 3 * C, D, 3LL * C};
  const Strides so{static_cast<long long>(kN) * C, D, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kFloat32) {
    const float* b = static_cast<const float*>(qkv);
    return launch<float, false>(b, b + C, b + 2 * C, sqkv, sqkv, sqkv, so,
                                bias, mask, nullptr, out, W, H, D, group, nW,
                                scale, s);
  }
  if (dtype_code == kBFloat16) {
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(qkv);
    return launch<__nv_bfloat16, false>(b, b + C, b + 2 * C, sqkv, sqkv, sqkv,
                                        so, bias, mask, nullptr, out, W, H, D,
                                        group, nW, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4.  q, k, v (W, H, 64, D) f32|bf16 with element strides
// strides[0:3], [3:6], [6:9] for (W, H, N) and a contiguous D axis; out
// (W, H, 64, D) of their type with strides [9:12] (`strides` is a host
// array of 12 int64); every pointer and stride 16-byte aligned; bias
// (H, 64, 64) f32, table (P, 64, 64) f32 and ids (W,) int32 in [0, P),
// contiguous; `group` heads per block.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int fused_window_attention(const void* q, const void* k,
                                      const void* v, const long long* strides,
                                      const void* bias, const void* table,
                                      const void* ids, void* out, int W, int H,
                                      int D, int P, int group, int dtype_code,
                                      float scale, void* stream) {
  if (P <= 0 || !table || !ids) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const int* pid = static_cast<const int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kFloat32)
    return launch<float, true>(q, k, v, sq, sk, sv, so, bias, table, pid, out,
                               W, H, D, group, P, scale, s);
  if (dtype_code == kBFloat16)
    return launch<__nv_bfloat16, true>(q, k, v, sq, sk, sv, so, bias, table,
                                       pid, out, W, H, D, group, P, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
