// Kernel K5: LayerNorm -> (pad, cyclic shift) -> window partition -> qkv
// projection, the prologue of every eval Swin block's attention.
//
// Replaces nerf_rpn_tpu/ops/fused_ln_qkv.py : _kernel (the Pallas TPU kernel
// behind ln_partition_qkv).  For window w and its token p:
//   out[w, p, :] = round(LN(x)[src(w, p)] . Wqkv + b)
// LN over C with two-pass f32 statistics, eps 1e-5, affine in f32, rounded
// to the input type; the product accumulated in f32, the bias added in f32,
// one rounding at the end.  The JAX kernel takes an already padded and
// rolled grid; this one takes the unpadded (B, SX, SY, SZ, C) grid, the
// padded size P and the shift s, and maps window token p to the source
// voxel (coordinate + s) mod P.  A voxel at or past the real size is a zero
// LN output (its qkv row is just b), as the model pads after the LayerNorm.
// With shift 0 and a divisible grid it is exactly the JAX kernel.
//
// What bounds it on the H100: at the Swin-S bench shape, stage 0 reads
// 18.7 MB of x and writes 56 MB of qkv (bf16) for 5.4 GFLOP of products:
// bytes bound it (~22 us at 3.35 TB/s).  The design reads each token once
// per column split, keeps the LN'd (rows x C) tile in shared memory (never
// in device memory: no LN output, no padded or rolled copy, no partition
// transpose), and runs the bf16 product on the tensor cores (wmma
// 16x16x16, f32 accumulation) with the weight read from L2; f32 runs true
// f32 FMA (tile_mma.cuh).  A block owns `rows` tokens of one window and a
// split of the 3C output columns; splits are added when there are too few
// windows to fill 132 SMs.  cp.async/TMA staging of the weight and wgmma
// are later work.
#include <algorithm>

#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-5f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_partition_qkv_kernel(const T* __restrict__ x,
                            const float* __restrict__ ln_scale,
                            const float* __restrict__ ln_bias,
                            const T* __restrict__ w,
                            const float* __restrict__ bias,
                            T* __restrict__ out, int SX, int SY, int SZ, int C,
                            int PX, int PY, int PZ, int shx, int shy, int shz,
                            int wx, int wy, int wz, int rows, int splits) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lda = C + row_pad<T>();
  T* a = reinterpret_cast<T*>(smem_raw);  // (rows, lda) LN'd tokens
  float* stage = reinterpret_cast<float*>(a + rows * lda);  // (warps, 256)
  long long* src = reinterpret_cast<long long*>(stage + kWarps * 256);

  const int n_tok = wx * wy * wz;
  const int parts = n_tok / rows;
  const int win = blockIdx.x / parts;
  const int tok0 = (blockIdx.x % parts) * rows;
  const int nx = PX / wx, ny = PY / wy, nz = PZ / wz;
  const int iz = win % nz, iy = (win / nz) % ny, ix = (win / nz / ny) % nx;
  const int b = win / (nx * ny * nz);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N3 = 3 * C;

  for (int i = tid; i < rows; i += kThreads) {
    const int p = tok0 + i;
    int X = ix * wx + p / (wy * wz) + shx;
    int Y = iy * wy + (p / wz) % wy + shy;
    int Z = iz * wz + p % wz + shz;
    X -= X >= PX ? PX : 0;
    Y -= Y >= PY ? PY : 0;
    Z -= Z >= PZ ? PZ : 0;
    src[i] = (X < SX && Y < SY && Z < SZ)
                 ? (((static_cast<long long>(b) * SX + X) * SY + Y) * SZ + Z) * C
                 : -1;
  }
  __syncthreads();

  // LayerNorm, one warp per token: mean, then the variance about it
  for (int i = warp; i < rows; i += kWarps) {
    T* arow = a + i * lda;
    if (src[i] < 0) {
      for (int c = lane; c < C; c += 32) arow[c] = from_f32<T>(0.f);
      continue;
    }
    const T* xr = x + src[i];
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += to_f32(xr[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f32(xr[c]) - mean;
      sq += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = 1.f / sqrtf(sq / C + kEps);
    for (int c = lane; c < C; c += 32)
      arow[c] = from_f32<T>((to_f32(xr[c]) - mean) * rstd * ln_scale[c] +
                            ln_bias[c]);
  }
  __syncthreads();

  // (rows x 3C) = A (rows x C) . W (C x 3C): this block's column tiles
  const int n_ct = N3 / 16;
  const int per = (n_ct + splits - 1) / splits;
  const int ct0 = blockIdx.y * per;
  const int ct1 = min(n_ct, ct0 + per);
  const int n_rt = rows / 16;
  float* st = stage + warp * 256;
  for (int tile = warp; tile < n_rt * (ct1 - ct0); tile += kWarps) {
    const int rt = tile % n_rt;
    const int col0 = (ct0 + tile / n_rt) * 16;
    Tile16<T> acc;
    acc.zero();
    for (int k = 0; k < C; k += 16)
      acc.mma(a + rt * 16 * lda + k, lda, w + static_cast<size_t>(k) * N3 + col0,
              N3);
    acc.store(st, 16);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      const size_t row = static_cast<size_t>(win) * n_tok + tok0 + rt * 16 + r;
      out[row * N3 + col0 + c] = from_f32<T>(st[e] + bias[col0 + c]);
    }
    __syncwarp();
  }
}

template <typename T>
size_t smem_bytes(int C, int rows) {
  return static_cast<size_t>(rows) * (C + row_pad<T>()) * sizeof(T) +
         kWarps * 256 * sizeof(float) + rows * sizeof(long long);
}

template <typename T>
int launch(const void* x, const void* s, const void* t, const void* w,
           const void* b, void* out, int B, int SX, int SY, int SZ, int C,
           int PX, int PY, int PZ, int shx, int shy, int shz, int wx, int wy,
           int wz, cudaStream_t stream) {
  constexpr size_t kMaxSmem = 232448;
  const int n_tok = wx * wy * wz;
  int rows = n_tok;  // a whole window per block where its tile fits
  while (rows > 16 && (smem_bytes<T>(C, rows) > kMaxSmem || n_tok % rows))
    rows /= 2;
  if (smem_bytes<T>(C, rows) > kMaxSmem || n_tok % rows || rows % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long windows =
      static_cast<long long>(B) * (PX / wx) * (PY / wy) * (PZ / wz);
  const long long blocks = windows * (n_tok / rows);
  // split the 3C columns until ~2 blocks per SM are in flight
  const int n_ct = 3 * C / 16;
  const int splits = static_cast<int>(std::min<long long>(
      n_ct, std::max<long long>(1, (264 + blocks - 1) / blocks)));
  const size_t smem = smem_bytes<T>(C, rows);
  cudaError_t err = cudaFuncSetAttribute(
      ln_partition_qkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_partition_qkv_kernel<T><<<dim3(static_cast<unsigned>(blocks), splits),
                               kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(out), SX, SY, SZ, C, PX,
      PY, PZ, shx, shy, shz, wx, wy, wz, rows, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, SX, SY, SZ, C) f32|bf16, ln scale / bias (C,) f32, w (C, 3C) of x's
// type, b (3C,) f32, out (B * nW, wx*wy*wz, 3C) of x's type with
// nW = (PX/wx)(PY/wy)(PZ/wz); all contiguous.  P >= S and divisible by the
// window, 0 <= shift < P, C a multiple of 16.  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int ln_partition_qkv(const void* x, const void* ln_scale,
                                const void* ln_bias, const void* w,
                                const void* b, void* out, int B, int SX,
                                int SY, int SZ, int C, int PX, int PY, int PZ,
                                int shx, int shy, int shz, int wx, int wy,
                                int wz, int dtype_code, void* stream) {
  if (B <= 0 || C <= 0 || C % 16 || wx <= 0 || wy <= 0 || wz <= 0 ||
      PX % wx || PY % wy || PZ % wz || SX > PX || SY > PY || SZ > PZ ||
      SX <= 0 || SY <= 0 || SZ <= 0 || shx < 0 || shy < 0 || shz < 0 ||
      shx >= PX || shy >= PY || shz >= PZ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kFloat32)
    return launch<float>(x, ln_scale, ln_bias, w, b, out, B, SX, SY, SZ, C, PX,
                         PY, PZ, shx, shy, shz, wx, wy, wz, s);
  if (dtype_code == kBFloat16)
    return launch<__nv_bfloat16>(x, ln_scale, ln_bias, w, b, out, B, SX, SY,
                                 SZ, C, PX, PY, PZ, shx, shy, shz, wx, wy, wz,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
