// Greedy AABB NMS on the device, batched over problems: kernel K3 builds
// the packed suppression graph, the resolve kernel takes the keep-set from
// it.  Neither involves the host; nms_mask launches the two back to back.
//
// K3 replaces nerf_rpn_tpu/ops/nms_graph.py : _kernel (the Pallas TPU
// kernel behind suppression_graph).  For problem p with score-sorted boxes
// (Np, 6), Np a multiple of 32:
//   bit c of word w in row j is set  iff  32w + c < j  and  IoU(j, 32w+c) > t
// (strict), written as int32 words with the bits of uint32.
//
// What bounds K3 on the H100: the bench problem (4 x 2560 boxes) is 13 M
// pair IoUs below the diagonal (~0.24 GFLOP, each with an IEEE division)
// against 3.3 MB of output; the arithmetic, not the bytes, sets the floor.
// The design: a block of 8 warps takes a tile of kRows = 32 rows by
// kWords = 8 column words.  The tile's 256 column boxes are staged once in
// shared memory in struct-of-arrays form with their volumes, and its rows
// with theirs.  Warp k computes word k of every row: each lane holds its
// row box in registers and builds the word in a register loop over the
// word's 32 columns, read four at a time (a 16-byte load a field) by all
// lanes at once (a shared-memory broadcast).  On the H100 this measured
// faster than one __ballot_sync per (row, word) with a column box per
// lane, and than two or four rows a lane (PERF.md).  The words go to a
// shared tile and leave in 32-byte row segments.  Tiles wholly above the
// diagonal compute nothing and store their zero words, as do warps whose
// word lies at or above every row of the tile.  Arithmetic as
// nerf_rpn_tpu/ops/nms_graph.py:56-68, with
// round-to-nearest intrinsics and --fmad=false so that no FMA contraction
// changes a bit: inter = (ex*ey)*ez, union = (va + vb) - inter, the
// union > 0 guard, the IEEE division and a float (not double) threshold.
// Where inter is not > 0 the IoU is 0 whatever the union (0 / u, or the
// guard), so the division runs only for boxes that meet: the same bits.
//
// The resolve kernel replaces the fixpoint of nerf_rpn_tpu/ops/nms.py
// (the lax.while_loop over alive <- valid & ~any(graph & packed(alive))).
// The graph is strictly lower-triangular, so that fixpoint is unique and
// equals sequential greedy NMS: box j is kept iff it is valid and no kept
// box i < j has its bit set in row j.  One block per problem walks the
// tiles of 32 rows in order, kSpan = 4 tiles a step, one barrier a step.
// At step S:
//   - warp 0 (the resolver) takes tiles 4S .. 4S+3 in order.  A row of
//     tile t is a candidate if it is valid, no puller has marked it
//     suppressed, and its words of columns 4S-4 .. t-1 miss those columns'
//     alive words (the previous step's four and this step's, kept in
//     registers).  The diagonal word (column t) is lower-triangular too,
//     so sweeping it from the candidates (one ballot a sweep) reaches the
//     tile's greedy keep-set: alive word t.  A chain inside a tile costs a
//     sweep a link.
//   - warps 1..31 (the pullers) take the rows of the next step's tiles
//     against columns 0 .. 4S-1, whose alive words are known, in tasks of
//     4 rows x 32 columns (each row's 128 bytes one coalesced load), and
//     mark a row suppressed where its words meet the alive words.  Rows
//     that are invalid or already suppressed read nothing.
// The resolver loads its words a step before it uses them (the chain of
// steps is latency-bound).  A row's suppressed flag is only ever
// set, so the result does not depend on the order in which threads run.
// What bounds it: Np/32 dependent tiles on one SM per problem; the bytes
// it must read are the lower triangle up to the last valid row, once, from
// L2 where K3 left them.  Rows past the last valid one are dead, so the
// walk stops there.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- K3 -------------------------------------------------------------------

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kWarps;      // column words of a tile: warp k computes w0 + k
constexpr int kRows = 32;           // rows of a tile: one a lane
constexpr int kCols = 32 * kWords;  // 256 column boxes
static_assert(kCols == kThreads, "one column box staged per thread");

struct Box {
  float x0, y0, z0, x1, y1, z1, vol;
};

__device__ __forceinline__ float extent(float lo, float hi) {
  return fmaxf(__fsub_rn(hi, lo), 0.f);
}

__device__ __forceinline__ float volume(const float* b) {
  return __fmul_rn(__fmul_rn(extent(b[0], b[3]), extent(b[1], b[4])),
                   extent(b[2], b[5]));
}

// IoU(a, b) > t in the reference's order (a: the row box, b: the column)
__device__ __forceinline__ bool iou_above(const Box& a, const Box& b,
                                          float t) {
  const float ex = fmaxf(__fsub_rn(fminf(a.x1, b.x1), fmaxf(a.x0, b.x0)), 0.f);
  const float ey = fmaxf(__fsub_rn(fminf(a.y1, b.y1), fmaxf(a.y0, b.y0)), 0.f);
  const float ez = fmaxf(__fsub_rn(fminf(a.z1, b.z1), fmaxf(a.z0, b.z0)), 0.f);
  const float inter = __fmul_rn(__fmul_rn(ex, ey), ez);
  const float uni = __fsub_rn(__fadd_rn(a.vol, b.vol), inter);
  float iou = 0.f;
  if (inter > 0.f && uni > 0.f) iou = __fdiv_rn(inter, fmaxf(uni, 1e-30f));
  return iou > t;
}

// four boxes as seven float4 fields
struct Box4 {
  float4 f[7];

  __device__ __forceinline__ Box box(int e) const {
    auto at = [e](const float4& v) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; };
    return Box{at(f[0]), at(f[1]), at(f[2]), at(f[3]), at(f[4]), at(f[5]), at(f[6])};
  }
};

// shared-memory boxes, struct of arrays: field f of box i at [f][i]
template <int N>
struct alignas(16) BoxesSoA {
  float f[7][N];

  __device__ __forceinline__ void put(int i, const float* b) {
    if (b != nullptr) {
      for (int k = 0; k < 6; ++k) f[k][i] = b[k];
      f[6][i] = volume(b);
    } else {
      for (int k = 0; k < 7; ++k) f[k][i] = 0.f;
    }
  }
  __device__ __forceinline__ Box get(int i) const {
    return Box{f[0][i], f[1][i], f[2][i], f[3][i], f[4][i], f[5][i], f[6][i]};
  }
  // boxes i .. i+3 (i a multiple of 4)
  __device__ __forceinline__ Box4 get4(int i) const {
    Box4 b;
#pragma unroll
    for (int k = 0; k < 7; ++k) b.f[k] = *reinterpret_cast<const float4*>(&f[k][i]);
    return b;
  }
};

__global__ void __launch_bounds__(kThreads)
    aabb_suppression_graph_kernel(const float* __restrict__ boxes,
                                  int* __restrict__ out, int Np,
                                  float thresh) {
  __shared__ BoxesSoA<kCols> cols;
  __shared__ BoxesSoA<kRows> rows;
  __shared__ unsigned tile[kRows][kWords + 1];

  const int words = Np / 32;
  const int w0 = blockIdx.x * kWords;  // first column word of the tile
  const int j0 = blockIdx.y * kRows;   // first row of the tile
  const long long p = blockIdx.z;
  const float* pb = boxes + p * Np * 6;
  const int t = threadIdx.x;
  const int row_end = min(j0 + kRows, Np);
  const int word_end = min(w0 + kWords, words);

  // a word w of row j can hold a bit only if 32w < j
  const bool compute = 32 * w0 < row_end - 1;
  if (compute) {
    const int c0 = 32 * w0 + t;
    cols.put(t, c0 < Np ? pb + static_cast<long long>(c0) * 6 : nullptr);
    if (t < kRows) {
      const int j = j0 + t;
      rows.put(t, j < Np ? pb + static_cast<long long>(j) * 6 : nullptr);
    }
    __syncthreads();

    // warp k: word w = w0 + k of every row of the tile, lane r row j0 + r:
    // a register loop over the word's 32 columns, read four at a time (a
    // 16-byte load a field) by all lanes at once (a shared-memory broadcast)
    const int k = t >> 5, lane = t & 31;
    const int w = w0 + k, j = j0 + lane;
    unsigned bits = 0u;
    if (w < word_end && 32 * w < row_end - 1) {  // warp-uniform
      const Box rb = rows.get(lane);
#pragma unroll
      for (int c4 = 0; c4 < 32; c4 += 4) {
        const Box4 cb4 = cols.get4(32 * k + c4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hit = iou_above(rb, cb4.box(e), thresh);
          bits |= hit && 32 * w + c4 + e < j ? 1u << (c4 + e) : 0u;
        }
      }
    }
    tile[lane][k] = bits;
    __syncthreads();
  }

  // kWords words of a row are one 32-byte segment: 8 threads a row
  for (int idx = t; idx < kRows * kWords; idx += kThreads) {
    const int r = idx / kWords, k = idx % kWords;
    const int j = j0 + r, w = w0 + k;
    if (j < row_end && w < word_end)
      out[(p * Np + j) * words + w] = compute ? static_cast<int>(tile[r][k]) : 0;
  }
}

// ---- resolve --------------------------------------------------------------

constexpr int kResolveThreads = 1024;
constexpr int kPullWarps = kResolveThreads / 32 - 1;  // warps 1..31
constexpr int kSpan = 4;  // tiles a step resolves, one barrier a step; their columns: a Quad
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int resolve_smem_bytes(int Np) {
  return 4 * (Np / 32) + Np;  // alive words, then a dead flag per row
}

struct Quad {
  unsigned w[4];
};

// words c0 .. c0+3 of a row (c0 a multiple of 4): one 16-byte load.  The
// rows are whole 16-byte units (Np a multiple of 128) from a 16-byte
// aligned graph, as nms_resolve requires
__device__ __forceinline__ Quad load_quad(const unsigned* row, int c0) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + c0));
  return Quad{{x.x, x.y, x.z, x.w}};
}

// the block's barrier, reached from the two roles' separate loops
__device__ __forceinline__ void step_barrier() { asm volatile("barrier.sync 0;" ::: "memory"); }

__global__ void __launch_bounds__(kResolveThreads)
    nms_resolve_kernel(const int* __restrict__ graph,
                       const unsigned char* __restrict__ svalid,
                       unsigned char* __restrict__ alive, int Np) {
  extern __shared__ unsigned smem_words[];
  __shared__ int last_valid;
  const int words = Np / 32;
  unsigned* alive_words = smem_words;
  // dead[j]: row j is invalid or suppressed by a kept box of an earlier tile
  unsigned char* dead = reinterpret_cast<unsigned char*>(smem_words + words);

  const long long p = blockIdx.x;
  const unsigned* g = reinterpret_cast<const unsigned*>(graph) + p * Np * words;
  const unsigned char* valid = svalid + p * Np;
  unsigned char* out = alive + p * Np;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  if (t == 0) last_valid = -1;
  __syncthreads();
  int last = -1;
  for (int j = t; j < Np; j += kResolveThreads) {
    const bool v = valid[j] != 0;
    dead[j] = v ? 0 : 1;
    if (v) last = j;
  }
  if (last >= 0) atomicMax(&last_valid, last);
  __syncthreads();
  // tiles past the one of the last valid row hold no candidate
  const int tiles = last_valid < 0 ? 0 : last_valid / 32 + 1;
  for (int j = 32 * tiles + t; j < Np; j += kResolveThreads) out[j] = 0;
  const int steps = (tiles + kSpan - 1) / kSpan;
  auto row = [&](int j) { return g + static_cast<long long>(j) * words; };

  if (warp == 0) {
    // the resolver: tiles kSpan*S .. kSpan*S + kSpan-1 at step S.  Its row
    // of tile t needs columns kSpan*(S-1) .. t: the previous step's words
    // `back` and this step's `here` (the diagonal among them; the words
    // past it come in the same 16-byte loads, unused), loaded a step ahead
    Quad back[kSpan], here[kSpan];
    unsigned back_alive[kSpan] = {}, here_alive[kSpan];
    auto fetch = [&](int S) {
#pragma unroll
      for (int d = 0; d < kSpan; ++d) {
        const int tile = kSpan * S + d;
        const bool in = tile < tiles;
        back[d] = in && S > 0 ? load_quad(row(32 * tile + lane), kSpan * (S - 1)) : Quad{};
        here[d] = in ? load_quad(row(32 * tile + lane), kSpan * S) : Quad{};
      }
    };
    fetch(0);
    for (int S = 0; S < steps; ++S) {
#pragma unroll
      for (int d = 0; d < kSpan; ++d) {
        const int tile = kSpan * S + d;
        here_alive[d] = 0u;
        if (tile < tiles) {  // warp-uniform
          const int j = 32 * tile + lane;
          unsigned hit = 0u;
#pragma unroll
          for (int e = 0; e < kSpan; ++e) hit |= back[d].w[e] & back_alive[e];
#pragma unroll
          for (int e = 0; e < d; ++e) hit |= here[d].w[e] & here_alive[e];
          const unsigned cand = __ballot_sync(kFull, dead[j] == 0 && hit == 0u);
          // greedy inside the tile: the diagonal word is lower-triangular,
          // so sweeping it from the candidates reaches its one fixpoint
          const unsigned diag = here[d].w[d];
          unsigned a = cand;
          for (;;) {  // warp-uniform
            const unsigned next = cand & ~__ballot_sync(kFull, (diag & a) != 0u);
            if (next == a) break;
            a = next;
          }
          out[j] = static_cast<unsigned char>((a >> lane) & 1u);
          if (lane == 0) alive_words[tile] = a;
          here_alive[d] = a;
        }
      }
#pragma unroll
      for (int d = 0; d < kSpan; ++d) back_alive[d] = here_alive[d];
      fetch(S + 1);
      step_barrier();
    }
  } else {
    // the pullers: at step S, the rows of the next step's tiles against
    // columns 0 .. kSpan*S - 1 (alive words known).  Task (r, b) is rows
    // 4r .. 4r+3 of those 128 against columns 32b .. 32b+31: lane (g, k)
    // reads words 4k .. 4k+3 of row 4r + g, so each row's 128 bytes are
    // one coalesced load, and a ballot ORs the row's 8 lanes.  The step's
    // issue slots bound the pullers more than their bytes: few
    // instructions a task
    const int g = lane >> 3, k = lane & 7;
    for (int S = 0; S < steps; ++S) {
      const int limit = kSpan * S;  // a multiple of 4, as is every c below
      const int row0 = 32 * kSpan * (S + 1);
      const int row_end = min(row0 + 32 * kSpan, 32 * tiles);
      const int tasks = row_end > row0 ? 32 * ((limit + 31) / 32) : 0;
      for (int task = warp - 1; task < tasks; task += kPullWarps) {
        const int j = row0 + 4 * (task & 31) + g, c = 32 * (task >> 5) + 4 * k;
        unsigned hit = 0u;
        if (j < row_end && c < limit && dead[j] == 0) {
          const Quad v = load_quad(row(j), c);
          const uint4 a = *reinterpret_cast<const uint4*>(alive_words + c);
          hit = (v.w[0] & a.x) | (v.w[1] & a.y) | (v.w[2] & a.z) | (v.w[3] & a.w);
        }
        const unsigned rows_hit = __ballot_sync(kFull, hit != 0u) >> (8 * g);
        if (k == 0 && (rows_hit & 0xffu) != 0u) dead[j] = 1;  // every writer writes 1
      }
      step_barrier();
    }
  }
}

}  // namespace

// boxes (P, Np, 6) f32 contiguous, out (P, Np, Np/32) int32.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int aabb_suppression_graph(const void* boxes, void* out, int P,
                                      int Np, float thresh, void* stream) {
  if (P <= 0 || P > 65535 || Np <= 0 || Np % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Np / 32 + kWords - 1) / kWords, (Np + kRows - 1) / kRows, P);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  aabb_suppression_graph_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<int*>(out), Np, thresh);
  return static_cast<int>(cudaGetLastError());
}

// graph (P, Np, Np/32) int32 from aabb_suppression_graph, Np a multiple of
// 128 (nms_mask pads to 256) and the graph 16-byte aligned; svalid (P, Np)
// bool (one byte each), alive (P, Np) bool out: greedy NMS's keep-set in
// the sorted order.  One block per problem.  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int nms_resolve(const void* graph, const void* svalid, void* alive,
                           int P, int Np, void* stream) {
  if (P <= 0 || Np <= 0 || Np % 128 != 0 ||
      reinterpret_cast<uintptr_t>(graph) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = resolve_smem_bytes(Np);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_resolve_kernel<<<P, kResolveThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(graph), static_cast<const unsigned char*>(svalid),
      static_cast<unsigned char*>(alive), Np);
  return static_cast<int>(cudaGetLastError());
}
