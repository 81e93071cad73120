// Kernel K5: LayerNorm -> (pad, cyclic shift) -> window partition -> qkv
// projection, the prologue of every eval Swin block's attention.
//
// Replaces nerf_rpn_tpu/ops/fused_ln_qkv.py : _kernel (the Pallas TPU kernel
// behind ln_partition_qkv).  For window w and its token p:
//   out[w, p, :] = round(LN(x)[src(w, p)] . Wqkv^T + b)
// LN over C with two-pass f32 statistics, eps 1e-5, affine in f32, rounded
// to the input type; the product accumulated in f32, the bias added in f32,
// one rounding at the end.  The JAX kernel takes an already padded and
// rolled grid; this one takes the unpadded (B, SX, SY, SZ, C) grid, the
// padded size P and the shift s, and maps window token p to the source
// voxel (coordinate + s) mod P.  A voxel at or past the real size is a zero
// LN output (its qkv row is just b), as the model pads after the LayerNorm.
// With shift 0 and a divisible grid it is exactly the JAX kernel.
//
// A slab of the grid along x (the space axis, parallel/space.py) is placed
// by (X0, RX, WX0, NWX): P and s stay the global grid's; x's local row i
// holds global row (X0 + i) mod PX; the block grid covers the rolled
// frame's window columns WX0 .. WX0 + NWX - 1; a token at global rolled row
// j reads global row q = (j + shx) mod PX, a pad row (zero LN output) where
// q >= RX -- wherever it lies in the slab, the last rank's wrapped rows
// included -- else local row (q - X0) mod PX, which the wrapper checks lies
// in x.  The whole grid is (0, SX, 0, PX / wx): the same arithmetic as
// without a slab.
//
// What bounds it on the H100: at the Swin-S bench shape, stage 0 reads
// 18.7 MB of x and writes 56 MB of qkv (bf16) for 5.4 GFLOP of products:
// bytes bound it (~22 us at 3.35 TB/s); at stage 2 (48 windows, C = 384)
// the bound is ~3 us, and the work has to spread over the 132 SMs with
// short serial chains to get anywhere near it.  The design:
//
// - Grid: one block of 4 warps per (R tokens of one window, a group of G
//   tiles of BN of the 3C output columns).  The block normalises its rows
//   once and then streams the weight chunks of its G tiles through one
//   ring without a break, storing each tile when its last chunk is done.
//   The wrapper's planner (ops/fused_ln_qkv.py : ln_qkv_plan) picks R in
//   {64, 32, 16} (the LN'd tile must fit at C up to 1536), BN (a multiple
//   of 16 dividing 3C), G and the weight k-chunk BK by a cost model
//   fitted to the device times of measured plans (plan_cost there).
// - The weight is read in nn.Linear's layout (3C, C), K contiguous, which
//   is mma.sync's "col" B operand: the model's stored weight, no transposed
//   copy.  Its (BN x BK) k-chunks go through a ring of four padded shared
//   tiles by 16-byte cp.async (gemm_sm90.cuh); the first three are issued
//   before the LayerNorm and land behind it, and each chunk's products run
//   with the next three in flight.
// - LayerNorm: each warp copies its own x rows by 16-byte cp.async into
//   the A tile (one copy group, first of all), then normalises them in
//   place, up to 8 rows a pass with a group of 4 or 8 lanes per row (a row
//   a pass, as first written, left the LayerNorm half of the kernel's time
//   at stages 0-3): two-pass f32 statistics (the mean, then the variance
//   about it), the affine in f32 and one rounding to T.  Nothing of LN(x)
//   reaches device memory: no padded or rolled copy, no partition
//   transpose.
// - Products: each warp owns 16 rows x 8 NT columns of a tile; bf16 on
//   mma.sync m16n8k16 from ldmatrix A and B fragments, f32 as 3xTF32
//   m16n8k8 (hi.hi + hi.lo + lo.hi, ~f32 parity).
// - Epilogue: bias in f32, one rounding, stored from the accumulator
//   fragments so that each row's four lanes fill whole 32-byte sectors
//   (bf16 lanes swap halves with their neighbour first).
// The row copies, the LayerNorm (two-pass form here), the chunk products
// and the fragment stores are gemm_sm90.cuh's, shared with K6.

#include "gemm_sm90.cuh"

namespace {

constexpr int kMaxC = 1536;      // widest LayerNorm (Swin-L's last stage)
constexpr float kEps = 1e-5f;

struct Geometry {
  int SX, SY, SZ, C, PX, PY, PZ, shx, shy, shz, wx, wy, wz;
  int X0, RX, WX0, NWX;  // the x slab: origin, real size, window columns
};

template <typename T>
size_t smem_bytes(int C, int R, int BN, int BK) {
  constexpr int kPad = pad_elems<T>();
  return (static_cast<size_t>(R) * (C + kPad) +
          static_cast<size_t>(kRing) * BN * (BK + kPad)) *
         sizeof(T);
}

// element offset in x of window `win`'s token p, or -1 for a pad voxel
__device__ __forceinline__ long long token_source(const Geometry& g, int win,
                                                  int p) {
  const int nx = g.NWX, ny = g.PY / g.wy, nz = g.PZ / g.wz;
  const int iz = win % nz, iy = (win / nz) % ny, ix = (win / nz / ny) % nx;
  const int b = win / (nx * ny * nz);
  int X = (g.WX0 + ix) * g.wx + p / (g.wy * g.wz) + g.shx;
  int Y = iy * g.wy + (p / g.wz) % g.wy + g.shy;
  int Z = iz * g.wz + p % g.wz + g.shz;
  X -= X >= g.PX ? g.PX : 0;
  Y -= Y >= g.PY ? g.PY : 0;
  Z -= Z >= g.PZ ? g.PZ : 0;
  if (X >= g.RX || Y >= g.SY || Z >= g.SZ) return -1;
  X -= g.X0;
  X += X < 0 ? g.PX : 0;
  return (((static_cast<long long>(b) * g.SX + X) * g.SY + Y) * g.SZ + Z) *
         g.C;
}

// Block b: column group b % n_grp (G tiles of BN columns from
// (b % n_grp) G BN), token part (b / n_grp) % parts, window
// b / n_grp / parts.  Warp w: rows 16 (w % (R / 16)), columns
// 8 NT (w / (R / 16)) of each tile (R * BN = 512 NT).  The block streams
// the G x C / BK weight chunks of its tiles through the ring without a
// break, and stores each tile when its last chunk is done.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 4)
    ln_partition_qkv_kernel(const T* __restrict__ x,
                            const float* __restrict__ ln_scale,
                            const float* __restrict__ ln_bias,
                            const T* __restrict__ w,
                            const float* __restrict__ bias,
                            T* __restrict__ out, Geometry geo, int R, int BN,
                            int BK, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kPad = pad_elems<T>();
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int C = geo.C, N3 = 3 * C;
  const int lda = C + kPad, ldb = BK + kPad;
  T* a = reinterpret_cast<T*>(smem_raw);  // (R, lda): x, then LN(x)
  T* ring = a + R * lda;                  // kRing x (BN, ldb) weight chunks
  const int n_tok = geo.wx * geo.wy * geo.wz;
  const int n_grp = N3 / (BN * G), parts = n_tok / R;
  const int grp = blockIdx.x % n_grp;
  const int part = (blockIdx.x / n_grp) % parts;
  const int win = blockIdx.x / n_grp / parts;
  const int n_base = grp * G * BN, tok0 = part * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = C / BK, nv = C / kVec, total = G * nk;
  const T* wblk = w + static_cast<size_t>(n_base) * C;
  const size_t tile_step = static_cast<size_t>(BN) * C;

  // copy group 0: this warp's x rows; groups 1 .. kRing - 1: weight chunks
  // 0 .. kRing - 2 of the block's stream (chunk q: tile q / nk, k-chunk
  // q % nk)
  const RowMap rows(R, warp, lane);
  const long long src =
      lane < rows.rows ? token_source(geo, win, tok0 + rows.first + lane) : -1;
  copy_rows_async(a, lda, x, rows, nv, src);
  cp_async_commit();
  int fj = 0, fk = 0;  // tile and k-chunk of the next chunk to fetch
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < total) {
      copy_tile_async(ring + s * BN * ldb, ldb, wblk + fj * tile_step + fk * BK,
                      C, BN, BK, tid, kThreads);
      if (++fk == nk) fk = 0, ++fj;
    }
    cp_async_commit();
  }
  cp_async_wait<kRing - 1>();
  __syncwarp();
  layer_norm_rows<Variance::kTwoPass>(a, lda, ln_scale, ln_bias, rows, C, nv,
                                      src, kEps);

  const int wm = R / 16;
  const int wr = (warp % wm) * 16, wc = (warp / wm) * 8 * NT;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  T* dst = out + (static_cast<size_t>(win) * n_tok + tok0 + wr) * N3 + n_base + wc;
  int j = 0, kc = 0;  // tile and k-chunk of chunk q
  for (int q = 0; q < total; ++q) {
    // chunk q landed; every warp is past chunk q - 1 (its buffer is free)
    // and, the first time, past its LayerNorm
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (q + kRing - 1 < total) {
      copy_tile_async(ring + ((q + kRing - 1) % kRing) * BN * ldb, ldb,
                      wblk + fj * tile_step + fk * BK, C, BN, BK, tid, kThreads);
      if (++fk == nk) fk = 0, ++fj;
    }
    cp_async_commit();
    warp_chunk_mma<NT>(acc, a + wr * lda + kc * BK, lda,
                       ring + (q % kRing) * BN * ldb + wc * ldb, ldb, BK,
                       lane);
    if (++kc == nk) {
      const float* bj = bias + n_base + j * BN + wc;
      store_warp_tile<NT>(dst + j * BN, N3, acc, lane, 16,
                          [bj](float2 v, int, int c) {
                            const float2 b = load_pair(bj + c);
                            return make_float2(v.x + b.x, v.y + b.y);
                          });
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      kc = 0;
      ++j;
    }
  }
}

template <typename T, int NT>
int launch_nt(const T* x, const float* s, const float* t, const T* w,
              const float* b, T* out, const Geometry& geo, int R, int BN,
              int BK, int G, long long blocks, size_t smem,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ln_partition_qkv_kernel<T, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_partition_qkv_kernel<T, NT>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          x, s, t, w, b, out, geo, R, BN, BK, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* s, const void* t, const void* w,
           const void* b, void* out, int B, const Geometry& geo, int R, int BN,
           int BK, int G, cudaStream_t stream) {
  const int C = geo.C, n_tok = geo.wx * geo.wy * geo.wz;
  if ((R != 16 && R != 32 && R != 64) || n_tok % R || BN <= 0 || BN % 16 ||
      (3 * C) % BN || (BK != 16 && BK != 32 && BK != 64) || C % BK ||
      (R * BN) % 512 || G <= 0 || (3 * C / BN) % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(C, R, BN, BK);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * geo.NWX *
                           (geo.PY / geo.wy) * (geo.PZ / geo.wz) *
                           (n_tok / R) * (3 * C / BN / G);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* st = static_cast<const float*>(s);
  const float* tt = static_cast<const float*>(t);
  const float* bt = static_cast<const float*>(b);
  T* ot = static_cast<T*>(out);
  switch (R * BN / 512) {  // n8 column tiles a warp holds
    case 2:
      return launch_nt<T, 2>(xt, st, tt, wt, bt, ot, geo, R, BN, BK, G, blocks,
                             smem, stream);
    case 4:
      return launch_nt<T, 4>(xt, st, tt, wt, bt, ot, geo, R, BN, BK, G, blocks,
                             smem, stream);
    case 6:
      return launch_nt<T, 6>(xt, st, tt, wt, bt, ot, geo, R, BN, BK, G, blocks,
                             smem, stream);
    case 8:
      return launch_nt<T, 8>(xt, st, tt, wt, bt, ot, geo, R, BN, BK, G, blocks,
                             smem, stream);
    case 12:
      return launch_nt<T, 12>(xt, st, tt, wt, bt, ot, geo, R, BN, BK, G, blocks,
                              smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (B, SX, SY, SZ, C) f32|bf16, ln scale / bias (C,) f32, w (3C, C) of x's
// type (nn.Linear's layout), b (3C,) f32, out (B * nW, wx*wy*wz, 3C) of x's
// type with nW = NWX (PY/wy)(PZ/wz); all contiguous and 16-byte aligned.
// P >= S (x: P >= RX and P >= SX) and divisible by the window, 0 <= shift
// < P, C a multiple of 16 and at most 1536; the x slab (X0, RX, WX0, NWX)
// as the header says, with 0 <= X0 < PX, NWX >= 1 and (WX0 + NWX) wx <= PX
// (the wrapper checks that every real row read lies in x).  The plan: `rows` (R) tokens of a window and `group`
// (G) tiles of `cols` (BN) output columns a block, weight k-chunks of
// `k_chunk` (BK): R in {16, 32, 64} dividing the window volume, BN a
// multiple of 16 dividing 3C, G dividing 3C / BN, BK in {16, 32, 64}
// dividing C, R * BN / 512 in {2, 4, 6, 8, 12}, shared memory within a
// block's 227 KB.  Returns the CUDA error code of the launch (0 on
// success; cudaErrorInvalidValue for arguments it does not take).
extern "C" int ln_partition_qkv(const void* x, const void* ln_scale,
                                const void* ln_bias, const void* w,
                                const void* b, void* out, int B, int SX,
                                int SY, int SZ, int C, int PX, int PY, int PZ,
                                int shx, int shy, int shz, int wx, int wy,
                                int wz, int X0, int RX, int WX0, int NWX,
                                int rows, int cols, int k_chunk, int group,
                                int dtype_code, void* stream) {
  if (B <= 0 || C <= 0 || C % 16 || C > kMaxC || wx <= 0 || wy <= 0 ||
      wz <= 0 || PX % wx || PY % wy || PZ % wz || SX > PX || SY > PY ||
      SZ > PZ || SX <= 0 || SY <= 0 || SZ <= 0 || shx < 0 || shy < 0 ||
      shz < 0 || shx >= PX || shy >= PY || shz >= PZ || X0 < 0 ||
      X0 >= PX || RX <= 0 || RX > PX || WX0 < 0 || NWX <= 0 ||
      (WX0 + NWX) * wx > PX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{SX, SY, SZ, C,  PX, PY, PZ,  shx, shy,
                     shz, wx, wy, wz, X0, RX, WX0, NWX};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kFloat32)
    return launch<float>(x, ln_scale, ln_bias, w, b, out, B, geo, rows, cols,
                         k_chunk, group, s);
  if (dtype_code == kBFloat16)
    return launch<__nv_bfloat16>(x, ln_scale, ln_bias, w, b, out, B, geo, rows,
                                 cols, k_chunk, group, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
