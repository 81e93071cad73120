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
// What bounds it on the H100: at the Swin-S train shapes (stage 0: 2000
// windows x 3 heads, N = 64, D = 32) a (window, head) pair needs ~0.66 M
// multiply-adds (logits, dp and the three output products) against 32 KB
// of qkv and dout, so the op sits far below the bf16 ridge point in
// device memory but, in this simple form, is bound by the f32 CUDA-core
// products read from shared memory.  The design recomputes p from qkv
// instead of reading stored probabilities (N = 64 makes that cheap),
// keeps p, ds and the logits in registers and shared memory (they never
// reach device memory, as the TPU kernel kept them in VMEM), and takes
// the shift mask as (nW, 64, 64) indexed by w % nW.  Tensor-core products
// are later work.
//
// dbias is deterministic: a block walks a fixed group of windows for one
// head and keeps its part of the sum in registers, writes one f32 partial
// (group, h, 64, 64), and a second kernel sums the partials over groups in
// a fixed order.  No atomics, so two runs give the same bits.
//
// Layout: one block of 256 threads per (window group, head); for the
// logits thread t owns query row i = t / 4 and key columns j = t % 4 + 4m
// (m < 16); the 4 threads of a row are adjacent lanes and reduce the row
// max and sums with shuffles.  For the outputs thread t owns row t / 4
// and lanes d = t % 4 + 4n of dq, dk and dv.
#include "common.cuh"

namespace {

constexpr int kN = 64;         // tokens per 4x4x4 window
constexpr int kThreads = 256;  // 4 threads per query row
constexpr int kMaxD = 64;      // head width limit of this kernel
constexpr int kReduceThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_kernel(const T* __restrict__ qkv,
                                const T* __restrict__ dout,
                                const float* __restrict__ bias,
                                const float* __restrict__ mask,
                                T* __restrict__ dqkv,
                                float* __restrict__ dbias_part, int W, int H,
                                int C, int D, int nW, int group, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // padded row stride: no bank conflicts on columns
  const int pld = kN + 1;
  float* qs = smem;
  float* k = qs + kN * ld;
  float* v = k + kN * ld;
  float* g = v + kN * ld;     // dout
  float* pt = g + kN * ld;    // round_T(p), (kN, kN + 1)
  float* dst = pt + kN * pld; // round_T(ds), (kN, kN + 1)

  const int grp = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int i = tid >> 2;
  const int sub = tid & 3;
  const float scale_t = round_to<T>(scale);
  const float* brow = bias + (static_cast<size_t>(h) * kN + i) * kN;

  float dbias_acc[kN / 4];
#pragma unroll
  for (int m = 0; m < kN / 4; ++m) dbias_acc[m] = 0.f;

  const int w_end = min(W, (grp + 1) * group);
  for (int w = grp * group; w < w_end; ++w) {
    const T* base = qkv + static_cast<size_t>(w) * kN * 3 * C + h * D;
    const T* gbase = dout + static_cast<size_t>(w) * kN * C + h * D;
    for (int idx = tid; idx < kN * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const T* row = base + static_cast<size_t>(r) * 3 * C + d;
      qs[r * ld + d] = round_to<T>(to_f32(row[0]) * scale_t);
      k[r * ld + d] = to_f32(row[C]);
      v[r * ld + d] = to_f32(row[2 * C]);
      g[r * ld + d] = to_f32(gbase[static_cast<size_t>(r) * C + d]);
    }
    __syncthreads();

    const float* mrow =
        mask ? mask + (static_cast<size_t>(w % nW) * kN + i) * kN : nullptr;
    float p[kN / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < kN / 4; ++m) {
      const int j = sub + 4 * m;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += qs[i * ld + d] * k[j * ld + d];
      acc += brow[j];
      if (mrow) acc += mrow[j];
      p[m] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < kN / 4; ++m) {
      p[m] = expf(p[m] - mx);
      sum += p[m];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);

    float dp[kN / 4];
    float rs = 0.f;
#pragma unroll
    for (int m = 0; m < kN / 4; ++m) {
      const int j = sub + 4 * m;
      p[m] = p[m] / sum;
      pt[i * pld + j] = round_to<T>(p[m]);
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += g[i * ld + d] * v[j * ld + d];
      dp[m] = acc;
      rs += acc * p[m];
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
#pragma unroll
    for (int m = 0; m < kN / 4; ++m) {
      const float ds = p[m] * (dp[m] - rs);
      dbias_acc[m] += ds;
      dst[i * pld + sub + 4 * m] = round_to<T>(ds);
    }
    __syncthreads();

    T* orow = dqkv + (static_cast<size_t>(w) * kN + i) * 3 * C + h * D;
    for (int d = sub; d < D; d += 4) {
      float aq = 0.f, ak = 0.f, av = 0.f;
      for (int j = 0; j < kN; ++j) {
        aq += dst[i * pld + j] * k[j * ld + d];   // dq[i] = ds[i, :] k
        ak += dst[j * pld + i] * qs[j * ld + d];  // dk[i] = ds[:, i]^T qs
        av += pt[j * pld + i] * g[j * ld + d];    // dv[i] = p[:, i]^T dout
      }
      orow[d] = from_f32<T>(aq * scale);
      orow[C + d] = from_f32<T>(ak);
      orow[2 * C + d] = from_f32<T>(av);
    }
    __syncthreads();  // the next window overwrites the tiles
  }

  float* part = dbias_part + ((static_cast<size_t>(grp) * H + h) * kN + i) * kN;
#pragma unroll
  for (int m = 0; m < kN / 4; ++m) part[sub + 4 * m] = dbias_acc[m];
}

// dbias[x] = sum over groups, in group order, of part[group, x]
__global__ void __launch_bounds__(kReduceThreads)
    dbias_reduce_kernel(const float* __restrict__ part,
                        float* __restrict__ dbias, int n_groups, int size) {
  const int x = blockIdx.x * kReduceThreads + threadIdx.x;
  if (x >= size) return;
  float acc = 0.f;
  for (int grp = 0; grp < n_groups; ++grp)
    acc += part[static_cast<size_t>(grp) * size + x];
  dbias[x] = acc;
}

template <typename T>
int launch(const void* qkv, const void* dout, const void* bias,
           const void* mask, void* dqkv, void* dbias_part, void* dbias, int W,
           int H, int C, int nW, int group, float scale, cudaStream_t stream) {
  const int D = C / H;
  const int n_groups = (W + group - 1) / group;
  const size_t smem =
      (4 * static_cast<size_t>(kN) * (D + 1) + 2 * kN * (kN + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_bwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_bwd_kernel<T><<<n_groups * H, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<T*>(dqkv), static_cast<float*>(dbias_part), W, H, C, D, nW,
      group, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = H * kN * kN;
  dbias_reduce_kernel<<<(size + kReduceThreads - 1) / kReduceThreads,
                        kReduceThreads, 0, stream>>>(
      static_cast<const float*>(dbias_part), static_cast<float*>(dbias),
      n_groups, size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (W, 64, 3C) f32|bf16, dout (W, 64, C) of the qkv type, bias
// (H, 64, 64) f32, mask (nW, 64, 64) f32 or NULL; out dqkv (W, 64, 3C) of
// the qkv type, dbias (H, 64, 64) f32, and scratch dbias_part
// (ceil(W / group), H, 64, 64) f32 for the per-group partial sums; all
// contiguous.  Launches the per-(group, head) kernel and the reduction.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int window_attention_bwd(const void* qkv, const void* dout,
                                    const void* bias, const void* mask,
                                    void* dqkv, void* dbias_part, void* dbias,
                                    int W, int H, int C, int nW, int group,
                                    int dtype_code, float scale,
                                    void* stream) {
  if (W <= 0 || H <= 0 || C % H != 0 || C / H > kMaxD || nW <= 0 ||
      W % nW != 0 || group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kFloat32)
    return launch<float>(qkv, dout, bias, mask, dqkv, dbias_part, dbias, W, H,
                         C, nW, group, scale, s);
  if (dtype_code == kBFloat16)
    return launch<__nv_bfloat16>(qkv, dout, bias, mask, dqkv, dbias_part,
                                 dbias, W, H, C, nW, group, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
