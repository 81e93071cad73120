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
// with any strides but a contiguous D axis; the shift mask is a table of
// P distinct (64, 64) patterns and a pattern id per window:
//   out[w, h] = softmax(q * D^-1/2 k^T + bias[h] + table[ids[w]]) v
// with q, k, v upcast to f32, q scaled in f32, P kept in f32, and only the
// output rounded to the input type.
//
// What bounds them on the H100: at the Swin-S bench shapes (W = 1521
// windows x 3 heads and 245 x 6, N = 64, D = 32) the op moves ~56 MB of qkv
// plus ~19 MB of output and does ~1.2 GFLOP of products, so it sits below
// the bf16 ridge point: memory traffic and, in this simple form, shared-
// memory bandwidth of the f32 CUDA-core products bound it.  The design keeps
// the (64, 64) logits and probabilities of a (window, head) pair in shared
// memory and registers (they never reach device memory, which is what the
// TPU kernels kept in VMEM), reads each q/k/v element once, and takes the
// shift mask without a per-window copy: (nW, 64, 64) indexed by w % nW for
// K1, the pattern table for K4, whose block loads its own pattern id (no
// scalar prefetch on Hopper).  K4 reads q/k/v straight from the K5 output
// through strides, so no head-split copy exists.  Tensor-core (mma/wgmma)
// products and a multi-head block are later work.
//
// Layout: one block of 256 threads per (window, head); thread t owns query
// row i = t / 4 and key columns j = t % 4 + 4m (m < 16); the 4 threads of a
// row are adjacent lanes and reduce the row max / sum with shuffles.
#include "common.cuh"

namespace {

constexpr int kN = 64;         // tokens per 4x4x4 window
constexpr int kThreads = 256;  // 4 threads per query row
constexpr int kMaxD = 64;      // head width limit of this kernel

// element strides of a (W, H, N, D) operand whose D axis is contiguous
struct Strides {
  long long w, h, n;
  __device__ __forceinline__ long long at(int wi, int hi, int ni) const {
    return wi * w + hi * h + ni * n;
  }
};

// kTable = false: K1 (q and P rounded to T, mask[w % nW]);
// kTable = true:  K4 (f32 q and P, table[ids[w]])
template <typename T, bool kTable>
__global__ void __launch_bounds__(kThreads)
    window_attention_kernel(const T* __restrict__ qg, const T* __restrict__ kg,
                            const T* __restrict__ vg, Strides sq, Strides sk,
                            Strides sv, Strides so,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            const int* __restrict__ ids, T* __restrict__ out,
                            int H, int D, int nW, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // padded row stride: no bank conflicts on k / v
  float* q = smem;
  float* k = q + kN * ld;
  float* v = k + kN * ld;
  float* p = v + kN * ld;  // (kN, kN + 1)
  const int pld = kN + 1;

  const int w = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const float scale_q = kTable ? scale : round_to<T>(scale);

  for (int idx = tid; idx < kN * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const float qv = to_f32(qg[sq.at(w, h, i) + d]) * scale_q;
    q[i * ld + d] = kTable ? qv : round_to<T>(qv);
    k[i * ld + d] = to_f32(kg[sk.at(w, h, i) + d]);
    v[i * ld + d] = to_f32(vg[sv.at(w, h, i) + d]);
  }
  __syncthreads();

  const int i = tid >> 2;
  const int sub = tid & 3;
  const float* brow = bias + (static_cast<size_t>(h) * kN + i) * kN;
  const float* mrow = nullptr;
  if (mask) {
    const int pat = kTable ? ids[w] : w % nW;
    mrow = mask + (static_cast<size_t>(pat) * kN + i) * kN;
  }

  float s[kN / 4];
  float mx = -INFINITY;
#pragma unroll
  for (int m = 0; m < kN / 4; ++m) {
    const int j = sub + 4 * m;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += q[i * ld + d] * k[j * ld + d];
    acc += brow[j];
    if (mrow) acc += mrow[j];
    s[m] = acc;
    mx = fmaxf(mx, acc);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float sum = 0.f;
#pragma unroll
  for (int m = 0; m < kN / 4; ++m) {
    s[m] = expf(s[m] - mx);
    sum += s[m];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
  for (int m = 0; m < kN / 4; ++m) {
    const float pm = s[m] / sum;
    p[i * pld + sub + 4 * m] = kTable ? pm : round_to<T>(pm);
  }
  __syncthreads();

  T* orow = out + so.at(w, h, i);
  for (int d = sub; d < D; d += 4) {
    float acc = 0.f;
    for (int j = 0; j < kN; ++j) acc += p[i * pld + j] * v[j * ld + d];
    orow[d] = from_f32<T>(acc);
  }
}

template <typename T, bool kTable>
int launch(const void* q, const void* k, const void* v, Strides sq, Strides sk,
           Strides sv, Strides so, const void* bias, const void* mask,
           const int* ids, void* out, int W, int H, int D, int nW, float scale,
           cudaStream_t stream) {
  const size_t smem =
      (3 * static_cast<size_t>(kN) * (D + 1) + kN * (kN + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T, kTable>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_kernel<T, kTable><<<W * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sq, sk, sv, so,
      static_cast<const float*>(bias), static_cast<const float*>(mask), ids,
      static_cast<T*>(out), H, D, nW, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1.  qkv (W, 64, 3C) f32|bf16, bias (H, 64, 64) f32, mask (nW, 64, 64)
// f32 or NULL, out (W, 64, C) of the qkv type; all contiguous.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int window_attention_fwd(const void* qkv, const void* bias,
                                    const void* mask, void* out, int W, int H,
                                    int C, int nW, int dtype_code, float scale,
                                    void* stream) {
  if (W <= 0 || H <= 0 || C % H != 0 || C / H > kMaxD || nW <= 0 ||
      W % nW != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = C / H;
  const Strides sqkv{static_cast<long long>(kN) * 3 * C, D, 3LL * C};
  const Strides so{static_cast<long long>(kN) * C, D, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kFloat32) {
    const float* b = static_cast<const float*>(qkv);
    return launch<float, false>(b, b + C, b + 2 * C, sqkv, sqkv, sqkv, so,
                                bias, mask, nullptr, out, W, H, D, nW, scale,
                                s);
  }
  if (dtype_code == kBFloat16) {
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(qkv);
    return launch<__nv_bfloat16, false>(b, b + C, b + 2 * C, sqkv, sqkv, sqkv,
                                        so, bias, mask, nullptr, out, W, H, D,
                                        nW, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4.  q, k, v (W, H, 64, D) f32|bf16 with element strides
// strides[0:3], [3:6], [6:9] for (W, H, N) and a contiguous D axis; out
// (W, H, 64, D) of their type with strides [9:12] (`strides` is a host
// array of 12 int64); bias (H, 64, 64) f32, table (P, 64, 64) f32 and ids
// (W,) int32 in [0, P), contiguous.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int fused_window_attention(const void* q, const void* k,
                                      const void* v, const long long* strides,
                                      const void* bias, const void* table,
                                      const void* ids, void* out, int W, int H,
                                      int D, int P, int dtype_code,
                                      float scale, void* stream) {
  if (W <= 0 || H <= 0 || D <= 0 || D > kMaxD || P <= 0 || !table || !ids)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const int* pid = static_cast<const int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kFloat32)
    return launch<float, true>(q, k, v, sq, sk, sv, so, bias, table, pid, out,
                               W, H, D, P, scale, s);
  if (dtype_code == kBFloat16)
    return launch<__nv_bfloat16, true>(q, k, v, sq, sk, sv, so, bias, table,
                                       pid, out, W, H, D, P, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
