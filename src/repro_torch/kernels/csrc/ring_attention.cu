// Attention of a call's queries over each batch row's K/V ring: the serving
// engine's slot decode ticks, prefill chunks and speculative verify calls,
// and the fixed-batch decode step.
//
// It replaces no TPU kernel. The reference computes this with two XLA
// einsums (repro/models/layers.py, attention_decode_slots), and so does the
// port's plain version (kernels/ref.py, ring_attention_ref). On the card
// cuBLAS picks a product's kernel, and with it the order of its sums, by the
// call's shape, so one query's output rounded differently in a decode tick
// (one query a row), a verify call (k + 1) and a prefill chunk (hundreds):
// a speculative or a resumed stream could part from the plain one at a
// near-tie. Here every sum of a query runs in an order set by the query's
// own positions: its output has the same bits in any call, whatever the
// call's other queries, its T, its B and its plan.
//
// Layout: q and out (B, T, H, D), k and v (B, S, KV, D), contiguous, f32 or
// bf16 (H a multiple of KV, D <= 256); plan (2, B) int64 on the device, the
// positions pos[b] and the counts n[b] of the call's tokens. Row b's newest
// cached position is last = pos[b] + n[b] - 1 and ring slot s holds
// position last - ((last - s) mod S). Query t of row b sits at qp = pos[b]
// + t and reads the positions j with max(0, last - S + 1) <= j <= min(qp,
// last), j > qp - window (window > 0) and j / chunk == qp / chunk (chunk >
// 0): the plain version's mask, an interval [lo, hi] (query_range). A
// query with no such position writes zeros (the plain version averages V
// there; no caller reads such a row). Like the plain version, which
// multiplies every slot's V by its weight, the kernel takes every slot of
// the rings to hold finite values.
//
// Arithmetic, the plain version's up to the order of its sums: a score is
// the f32 dot of q and k rounded to the input type, then divided by sqrt(D)
// in f32; p_j = exp(s_j - m) / l over the valid positions, rounded to the
// input type; out = sum_j p_j v_j in f32, rounded once.
//
// Bound: bytes at the decode shapes, operations at the prefill chunks. The
// bytes are q and out once, and each K and V row that some query of its
// batch row reads, once; the operations 4 D per (query head, valid position)
// pair, at the dense bf16 tensor-core rate (ring_attention.work counts both
// from a call's plan; PERF.md's bound note). Phase 10's decode tick, 8 rows
// at about 1,300 positions of MiniCPM-2B's 36 heads of 64: 96 MB, 0.028 ms
// at 3.35 TB/s; its 512-token chunk over 1,536 positions: 6.0e9 operations,
// 0.006 ms at 989 TFLOP/s.
//
// Three routes, chosen by the wrapper from the dtype, D and S alone (never
// from T, B or the plan); the copy route never changes the arithmetic:
//   bf16, D <= 128 and even: the tensor-core kernel (tc::), with K and V
//     brought in by TMA where D is 64 or 128 and S a multiple of the key
//     block (a block's slots are then contiguous), else by cp.async of 16,
//     8 or 4 bytes a piece (the widest that divides a row);
//   f32, or D odd or above 128: the CUDA-core kernel (cores::) below. TF32
//     tensor cores would break f32's 2e-5 limit, and no config has such a D.
// TMA earns its second route: on an H100 at the main path's shapes (D 64,
// rings of 4096 and 8192) the same kernel with cp.async copies took 1.7 to
// 1.9 times as long at the decode ticks and the prefill chunks, where one
// thread's TMA request leaves the other 127 to the products and the
// softmax (tools/torch_ring_ab.py, its cp_async entry; PERF.md).
//
// The tensor-core kernel. One CTA, one warpgroup, takes one (batch row, K/V
// head) and 64 query rows: the call's queries times the H / KV query heads
// that share the K/V head (row r: query r / rep, head kvh * rep + r % rep),
// so grouped-query configs fill the rows. Key blocks are the 64 positions
// [c, c + 64) with c a multiple of 64, visited in ascending order from the
// block of the tile's least lo to that of its largest hi; the rows' ranges
// are intervals whose union has no gap (a row's lo and hi never fall as its
// query moves on), so no visited block is outside every row's range and no
// other block is visited. Position j lives in slot j mod S: with S a
// multiple of 64 a block is 64 contiguous slots, one TMA box of (64
// columns, 1 head, 64 slots, 1 row) per 64 columns, with the 128-byte
// swizzle; otherwise each row comes by cp.async into the same swizzled
// place (the tensor maps are encoded once per ring and host thread). Q is
// staged once by cp.async; K and V go through a ring of stages (4 at D <=
// 64, 2 at 128) with a full mbarrier each on the TMA route and a cp.async
// group per stage otherwise, the next stages in flight while a block is
// computed. Head dims under 64 are padded with zeros in shared memory (Q's
// and K's columns past D; V's are read into output columns that are not
// stored), as are Q's rows past the call's. The CTAs start heaviest tile
// first, and the K/V heads of a batch row side by side, so CTAs in flight
// read neighbouring 128-byte pieces of the same slots. Two passes over the
// tile's blocks, as the plain softmax takes them:
//   pass 1: S = Q K^T (wgmma m64n64k16, Q and K from shared memory, the
//     head dim in k16 steps in order); each row's values v, which order as
//     its logits x (row_values); over the row's valid columns of the block,
//     its max bm and, with mn = max(m, bm), the sum of exp(x - mn), each a
//     thread's 16 columns in order and then a butterfly over the row's four
//     threads; m = mn, l = l * f + sum, where f = 1 if mn == m, else
//     exp(m - mn);
//   pass 2: S again (recomputing it on the tensor cores costs less than
//     keeping it), p = exp(x - m) / l on the valid columns and 0 elsewhere,
//     rounded to bf16 into the A fragment, and O += P V (wgmma m64nDk16, P
//     from registers, V from shared memory MN-major, the block's keys in
//     k16 steps in order).
// A warp none of whose 16 rows has a valid column in the block skips its
// softmax (a decode tick's tile holds a few real rows), and one whose rows
// all cover the block skips the mask. A one-pass online softmax would
// rescale O and round P against a running max: other bits than the plain
// version's form, so the kernel keeps two.
// exp(x - m) is ex2.approx of v c - m c (c = log2 e, or log2 e / sqrt(D)
// where v is the unscaled dot) and p is ex2.approx of v c - (m c + log2
// l): within a few f32 ulp of the plain version's exp and division before
// the rounding to bf16.
//
// Why a query's output has the same bits in any call. (1) Its blocks and
// their order are set by its own [lo, hi] and the fixed 64-position grid:
// the blocks that meet [lo, hi], in ascending order. (2) A block the tile
// visits that lies wholly outside the row's range is an exact no-op for the
// row: pass 1 finds no valid column, so bm = -inf, mn = m, f = 1 and sum =
// +0, and l * 1 + 0 = l; pass 2 gives the row p = 0 in every column, and O
// + 0 * v = O for the finite slots (a -0 sum becomes +0 at the store); a
// warp that skips such a block leaves the same state and the same zeros. (3)
// Each element of a wgmma's result is a function of its row of A, its
// column of B and its accumulator alone: the instruction defines the result
// element by element, and the tensor core computes every element with the
// same datapath whichever of the 64 rows it is in. So a query's S row, and
// its O row, do not depend on which tile row it lands in or on the queries
// that share its tile (their rows of Q and P differ, not its own), and the
// padded zeros it meets are the same in every call. (4) The softmax of a
// row reads only that row's S elements, in an order fixed by the
// accumulator layout, which is the same for every row; the mask only sets
// a row's invalid columns to -inf, so a row computes the same values with
// or without it. (5) The route, the stage count and the pad widths depend
// on the dtype, D and S alone, and they move bytes only; the CTA order
// moves time only.
//
// The CUDA-core kernel (f32, odd D, D in (128, 256]). A block of 256
// threads takes up to 8 consecutive queries of one batch row and head, so a
// prefill chunk's queries share their K and V loads. Pass 1: thread i takes
// the positions j = i (mod 256) in order and keeps each query's running max
// and sum of exponentials over those in the query's range, merged across
// each warp by a butterfly (each merge symmetric, so every lane ends with
// the same pair) and then over the warps in order. Pass 2: for each 256
// positions aligned to a multiple of 256, every thread computes each
// query's p_j for one position into shared memory (0 outside the query's
// range); then the threads, as G = 256 / D groups of one thread per dim,
// add p_j v_j[d] over the chunk's positions g, g + G, ... in order, and the
// groups' sums are added in group order at the end. Every split is set by
// absolute positions and the query's own range, and a zero p adds an exact
// zero, so a query's sums run the same way in a block of one query or of
// eight.
//
// What holds the tensor-core kernel back (PERF.md, measured on an H100 in
// turns with SDPA and the CUDA-core kernel by tools/torch_ring_ab.py): at
// the decode shapes it reaches about 40 % of the bytes bound, since K is
// read twice, a ring row is a 128-byte piece KV * D * 2 bytes from the
// next, and 2 to 4 CTAs an SM each take one block at a time (wait, S,
// softmax, P V, barrier), so too few bytes are in flight (more stages cost
// occupancy and ran slower). At the prefill chunks it reaches about 10 % of
// the operations bound: one warpgroup runs the products, the softmax and
// the barriers in series, each 64-row tile reads its head's K twice and V
// once from L2, and ex2 runs twice an element. Issuing the next block's S
// before the softmax took 162 registers and ran slower. Two consumer
// warpgroups sharing each stage, and a split of a decode row's key span at
// absolute block boundaries merged in a fixed order, are the next designs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro_torch::hopper;

constexpr int kMaxD = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Geo {
  int B, T, H, KV, D, S, window, chunk;
  float sqrt_d;
};

// Each query's valid positions: [lo, hi], empty when hi < lo.
__device__ __forceinline__ void query_range(const Geo& g, int64_t last,
                                            int64_t qp, int64_t* lo,
                                            int64_t* hi) {
  int64_t a = last - g.S + 1 > 0 ? last - g.S + 1 : 0;
  if (g.window > 0 && qp - g.window + 1 > a) a = qp - g.window + 1;
  if (g.chunk > 0 && (qp / g.chunk) * g.chunk > a) a = (qp / g.chunk) * g.chunk;
  *lo = a;
  *hi = qp < last ? qp : last;
}

// ------------------------------------------------ the CUDA-core kernel

namespace cores {

constexpr int kThreads = 256;   // a block: kQ queries of one (b, h)
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 8;

__device__ __forceinline__ float load1(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load1(const uint16_t* p, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const uint16_t*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store1(float* p, int64_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store1(uint16_t* p, int64_t i, float x) {
  p[i] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Merge two (max, sum of exponentials) pairs; symmetric in its arguments.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mm = fmaxf(m, m2);
  l = (m == -INFINITY ? 0.f : l * expf(m - mm)) +
      (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mm));
  m = mm;
}

// The f32 dots of K row kr with the block's nq queries (qs, kQ rows of
// kMaxD), d = 0..D-1 in order for each, 16-byte loads where D allows.
__device__ __forceinline__ void dots(const float (*qs)[kMaxD], int nq,
                                     const float* kr, int D, float* s) {
#pragma unroll
  for (int i = 0; i < kQ; ++i) s[i] = 0.f;
  if ((D & 3) == 0) {
    for (int d = 0; d < D; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        if (i >= nq) break;
        s[i] += qs[i][d] * x.x;
        s[i] += qs[i][d + 1] * x.y;
        s[i] += qs[i][d + 2] * x.z;
        s[i] += qs[i][d + 3] * x.w;
      }
    }
  } else {
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int i = 0; i < kQ; ++i)
        if (i < nq) s[i] += qs[i][d] * kr[d];
  }
}
__device__ __forceinline__ void dots(const float (*qs)[kMaxD], int nq,
                                     const uint16_t* kr, int D, float* s) {
#pragma unroll
  for (int i = 0; i < kQ; ++i) s[i] = 0.f;
  if ((D & 7) == 0) {
    for (int d = 0; d < D; d += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(kr + d);
      float f[8];
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[2 * e] = __uint_as_float(w[e] << 16);
        f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        if (i >= nq) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) s[i] += qs[i][d + e] * f[e];
      }
    }
  } else {
    for (int d = 0; d < D; ++d) {
      const float x = load1(kr, d);
#pragma unroll
      for (int i = 0; i < kQ; ++i)
        if (i < nq) s[i] += qs[i][d] * x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      const int64_t* __restrict__ plan, Geo g) {
  __shared__ float qs[kQ][kMaxD];
  __shared__ float ps[kQ][kThreads];
  __shared__ float red_m[kQ][kWarps], red_l[kQ][kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = g.D;
  // block: (b, h, a tile of kQ consecutive queries t)
  const int tiles = (g.T + kQ - 1) / kQ;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int64_t bh = blockIdx.x / tiles;
  const int h = static_cast<int>(bh % g.H);
  const int b = static_cast<int>(bh / g.H);
  const int t0 = tile * kQ;
  const int nq = g.T - t0 < kQ ? g.T - t0 : kQ;
  const int kvh = h / (g.H / g.KV);
  const int64_t last = plan[b] + plan[g.B + b] - 1;
  int64_t lo[kQ], hi[kQ];
  int64_t jmin = INT64_MAX, jmax = -1;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    lo[i] = 1;
    hi[i] = 0;
    if (i < nq) {
      query_range(g, last, plan[b] + t0 + i, &lo[i], &hi[i]);
      if (hi[i] >= lo[i]) {
        jmin = lo[i] < jmin ? lo[i] : jmin;
        jmax = hi[i] > jmax ? hi[i] : jmax;
      }
    }
  }
  const int64_t row0 = ((static_cast<int64_t>(b) * g.T + t0) * g.H + h) * D;
  const int64_t qstride = static_cast<int64_t>(g.H) * D;
  for (int i = 0; i < nq; ++i)
    for (int d = tid; d < D; d += kThreads)
      qs[i][d] = load1(q + row0 + i * qstride, d);
  __syncthreads();
  const int64_t base_b = static_cast<int64_t>(b) * g.S;
  auto krow = [&](const T* a, int64_t j) {
    return a + ((base_b + j % g.S) * g.KV + kvh) * D;
  };

  // pass 1: thread tid takes the positions j = tid (mod kThreads), in
  // order, keeping each query's running max and sum of exponentials;
  // merged by a butterfly in each warp, then over the warps in order
  float m[kQ], l[kQ], s[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  if (jmax >= 0) {
    const int64_t first =
        jmin + ((tid - jmin % kThreads) % kThreads + kThreads) % kThreads;
    for (int64_t j = first; j <= jmax; j += kThreads) {
      dots(qs, nq, krow(k, j), D, s);
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        if (i >= nq || j < lo[i] || j > hi[i]) continue;
        const float x = round_to(s[i], k) / g.sqrt_d;
        if (x > m[i]) {
          l[i] = (m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - x)) + 1.f;
          m[i] = x;
        } else {
          l[i] += expf(x - m[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      merge(m[i], l[i], __shfl_xor_sync(kFull, m[i], off),
            __shfl_xor_sync(kFull, l[i], off));
    if (lane == 0) {
      red_m[i][warp] = m[i];
      red_l[i][warp] = l[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    m[i] = red_m[i][0];
    l[i] = red_l[i][0];
    for (int w = 1; w < kWarps; ++w) merge(m[i], l[i], red_m[i][w], red_l[i][w]);
  }

  // pass 2: per kThreads positions aligned to multiples of kThreads,
  // thread tid computes each query's p for position c + tid; then thread
  // (group gi, dim d) adds p_j v_j[d] over the positions c + gi, c + gi +
  // G, ... in order; the G groups' sums are added in group order at the
  // end. A position outside a query's range adds p = 0.
  const int G = kThreads / D;                      // >= 1: D <= kThreads
  const int gi = tid / D, d = tid % D;
  float acc[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) acc[i] = 0.f;
  if (jmax >= 0) {
    for (int64_t c = jmin / kThreads * kThreads; c <= jmax; c += kThreads) {
      const int64_t j = c + tid;
      if (j >= jmin && j <= jmax) dots(qs, nq, krow(k, j), D, s);
#pragma unroll
      for (int i = 0; i < kQ; ++i)
        if (i < nq)
          ps[i][tid] = (j >= lo[i] && j <= hi[i])
                           ? round_to(expf(round_to(s[i], k) / g.sqrt_d -
                                           m[i]) / l[i], k)
                           : 0.f;
      __syncthreads();
      if (gi < G)
        for (int r = gi; r < kThreads; r += G) {
          const int64_t jj = c + r;
          if (jj < jmin || jj > jmax) continue;
          const float x = load1(krow(v, jj), d);
#pragma unroll
          for (int i = 0; i < kQ; ++i)
            if (i < nq) acc[i] += ps[i][r] * x;
        }
      __syncthreads();
    }
  }
  // the groups' sums, in group order (ps is free again)
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    if (i < nq) ps[i][tid] = acc[i];
  __syncthreads();
  for (int i = 0; i < nq; ++i)
    if (tid < D) {
      float o = 0.f;
      if (hi[i] >= lo[i]) {
        o = ps[i][tid];
        for (int gg = 1; gg < G; ++gg) o += ps[i][gg * D + tid];
      }
      store1(out + row0 + i * qstride, tid, o);
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           const int64_t* plan, const Geo& g, cudaStream_t st) {
  const int64_t blocks =
      static_cast<int64_t>(g.B) * g.H * ((g.T + kQ - 1) / kQ);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  ring_attention_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), plan, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cores

// ------------------------------------------------ the tensor-core kernel

namespace tc {

constexpr int kBN = 64;          // a key block: positions [c, c + 64), 64 | c
constexpr int kRows = 64;        // query rows of a CTA: one wgmma m64 tile
constexpr int kThreads = 128;    // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  Geo g;
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  uint16_t* out;
  const int64_t* plan;
  int rep;            // query heads per K/V head
  int tiles;          // CTAs per (row, K/V head): ceil(T * rep / kRows)
  int width;          // bytes per cp.async: 16, 8 or 4 (D * 2 divisible)
  int pow2;           // sqrt(D) a power of two (see row_values)
  float c;            // log2 e / sqrt(D) where pow2, else log2 e
};

// Shared memory, from a 1024-byte aligned base, in boxes of 64 columns (128
// bytes a row, one 128-byte swizzle atom wide): Q as DP / 64 boxes of 64
// rows; then kStages stages, each a K block and a V block of DP / 64 boxes
// of kBN rows; then a full barrier per stage (the TMA route's).
template <int DP>
struct Layout {
  static constexpr int kBoxes = DP / 64;
  static constexpr int kStages = DP == 64 ? 4 : 2;
  static constexpr int kQBox = kRows * 128;
  static constexpr int kBox = kBN * 128;
  static constexpr int kTile = kBoxes * kBox;     // a K or a V block
  static constexpr int kQ = 0;
  static constexpr int kStage0 = kQ + kBoxes * kQBox;
  static constexpr int kBar = kStage0 + kStages * 2 * kTile;
  static constexpr int kBytes = kBar + 8 * kStages + 1024;
  // CTAs an SM holds: 3 at DP = 64 (73 KB each), 2 at 128 (81 KB)
  static constexpr int kMinBlocks = DP == 64 ? 3 : 2;
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int width) {
  if (width == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte `off` of row `row` of a swizzled tile of boxes `box` bytes apart:
// the 16-byte chunk c of a row r sits at chunk c ^ (r mod 8), as TMA's
// 128-byte swizzle writes it and the wgmma descriptors read it.
__device__ __forceinline__ uint32_t swizzled(uint32_t tile, int box, int row,
                                             int off) {
  return tile + (off >> 7) * box + row * 128 +
         ((((off >> 4) & 7) ^ (row & 7)) << 4) + (off & 15);
}

// Every thread's share of 16-byte zero stores over [addr, addr + bytes).
__device__ __forceinline__ void zero_smem(uint32_t addr, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr + i),
                 "r"(0)
                 : "memory");
}

// cp.async of the ring rows of positions c .. c + kBN - 1 (slot j mod S) of
// K/V head kvh of batch row b into a swizzled block, D values a row, in
// pieces of a.width bytes spread over the CTA's threads.
template <int DP>
__device__ __forceinline__ void copy_block(const Args& a, uint32_t tile,
                                           const uint16_t* ring, int b,
                                           int kvh, int64_t c) {
  const int per_row = a.g.D * 2 / a.width;
  const int slot0 = static_cast<int>(c % a.g.S);
  for (int i = threadIdx.x; i < kBN * per_row; i += kThreads) {
    const int row = i / per_row, off = (i - row * per_row) * a.width;
    int slot = slot0 + row;
    if (slot >= a.g.S) slot %= a.g.S;
    const uint16_t* src =
        ring + ((static_cast<int64_t>(b) * a.g.S + slot) * a.g.KV + kvh) *
                   a.g.D;
    cp_async(swizzled(tile, Layout<DP>::kBox, row, off),
             reinterpret_cast<const char*>(src) + off, a.width);
  }
}

// Row i's 16 elements of an S accumulator as values v that order as its
// logits: the f32 dot rounded to bf16 (in pairs), and, unless sqrt(D) is a
// power of two, divided by sqrt(D) in f32 (the logit itself). Where it is,
// the logit is v / sqrt(D) exactly, and exp(x - m) = 2^(v c - m_v c) with
// c = log2 e / sqrt(D) and m_v the max of v; else c = log2 e.
__device__ __forceinline__ void row_values(const Args& a,
                                           const float (&sc)[32], int i,
                                           float (&v)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t w = pack_bf16(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
    v[2 * j] = lo_f32(w);
    v[2 * j + 1] = hi_f32(w);
  }
  if (!a.pow2)
#pragma unroll
    for (int q = 0; q < 16; ++q) v[q] = __fdiv_rn(v[q], a.g.sqrt_d);
}

// One CTA: batch row b, K/V head kvh, query rows r0 .. r0 + 63 of the
// call's T * rep rows (row r: query t = r / rep, head kvh * rep + r % rep).
// Thread (warp w, lane = 4 g + t4) holds rows 16 w + g + 8 i, i = 0, 1, and
// of each the columns 8 j + 2 t4 + e (j < N / 8, e = 0, 1) of a wgmma m64nN
// accumulator: element 4 j + 2 i + e. Packed in bf16 pairs, pair 2 j + i
// holds columns 8 j + 2 t4, +1 of row i, and pairs 4 kk .. 4 kk + 3 are the
// A fragment of k-step kk of P V, so P goes from S's registers to the A
// operand within the thread.
template <int DP, bool kTma>
__global__ void __launch_bounds__(kThreads, Layout<DP>::kMinBlocks)
ring_attention_wgmma(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const Args a) {
  using L = Layout<DP>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int64_t span[2][4];       // per warp: least lo, largest hi
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::kBar;
  const CUtensorMap* const kmp = &kmap;
  const CUtensorMap* const vmp = &vmap;
  auto stage_k = [&](int s) { return base + L::kStage0 + s * 2 * L::kTile; };
  auto stage_v = [&](int s) { return stage_k(s) + L::kTile; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // the last (heaviest causal) tile of every (row, K/V head) first, and
  // within a tile the K/V heads of a row side by side: their CTAs read
  // neighbouring bytes of the same ring slots at about the same time
  const int bks = a.g.B * a.g.KV;
  const int tile = a.tiles - 1 - static_cast<int>(blockIdx.x / bks);
  const int bk = static_cast<int>(blockIdx.x % bks);
  const int kvh = bk % a.g.KV, b = bk / a.g.KV;
  const int R = a.g.T * a.rep, r0 = tile * kRows;
  const int64_t pos = a.plan[b], last = pos + a.plan[a.g.B + b] - 1;

  // this thread's two rows and their positions [lo, hi] (empty: lo > hi)
  int64_t lo[2], hi[2];
  int64_t jmin = INT64_MAX, jmax = -1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * warp + g + 8 * i;
    lo[i] = 1;
    hi[i] = 0;
    if (r < R) query_range(a.g, last, pos + r / a.rep, &lo[i], &hi[i]);
    if (hi[i] >= lo[i]) {
      jmin = lo[i] < jmin ? lo[i] : jmin;
      jmax = hi[i] > jmax ? hi[i] : jmax;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t x = __shfl_xor_sync(kFull, jmin, off);
    const int64_t y = __shfl_xor_sync(kFull, jmax, off);
    jmin = x < jmin ? x : jmin;
    jmax = y > jmax ? y : jmax;
  }
  if (lane == 0) {
    span[0][warp] = jmin;
    span[1][warp] = jmax;
  }
  if (tid == 0 && kTma) {
    for (int s = 0; s < kStages; ++s) bar_init(bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // zeros where no copy writes: Q's rows past the call's and its columns
  // past D, and K's columns past D (so the padded k-steps add 0 * 0)
  if (a.g.D < DP || r0 + kRows > R) zero_smem(base + L::kQ, L::kBoxes * L::kQBox);
  if (a.g.D < DP)
    for (int s = 0; s < kStages; ++s) zero_smem(stage_k(s), L::kTile);
  __syncthreads();
  jmin = span[0][0];
  jmax = span[1][0];
#pragma unroll
  for (int w = 1; w < 4; ++w) {
    jmin = span[0][w] < jmin ? span[0][w] : jmin;
    jmax = span[1][w] > jmax ? span[1][w] : jmax;
  }
  const int64_t c0 = jmax >= 0 ? jmin / kBN * kBN : 0;
  const int nblk = jmax >= 0 ? static_cast<int>(jmax / kBN - jmin / kBN) + 1
                             : 0;
  const int items = 2 * nblk;   // pass 1: K of each block; pass 2: K and V

  // item e into stage s: the block's K (pass 1) or K and V (pass 2)
  auto issue = [&](int e, int s) {
    const bool second = e >= nblk;
    const int64_t c = c0 + static_cast<int64_t>(second ? e - nblk : e) * kBN;
    if constexpr (kTma) {
      if (tid == 0) {
        const int slot = static_cast<int>(c % a.g.S);
        bar_expect_tx(bar + 8 * s, (second ? 2 : 1) * L::kTile);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load(stage_k(s) + x * L::kBox, kmp, bar + 8 * s, 64 * x, kvh,
                   slot, b);
        if (second)
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(stage_v(s) + x * L::kBox, vmp, bar + 8 * s, 64 * x,
                     kvh, slot, b);
      }
    } else {
      copy_block<DP>(a, stage_k(s), a.k, b, kvh, c);
      if (second) copy_block<DP>(a, stage_v(s), a.v, b, kvh, c);
      cp_async_commit();
    }
  };

  if (nblk > 0) {
    // Q: the tile's rows, D values each, by cp.async on both routes
    {
      const int per_row = a.g.D * 2 / a.width;
      const int rows = R - r0 < kRows ? R - r0 : kRows;
      for (int i = tid; i < rows * per_row; i += kThreads) {
        const int row = i / per_row, off = (i - row * per_row) * a.width;
        const int r = r0 + row;
        const uint16_t* src =
            a.q + ((static_cast<int64_t>(b) * a.g.T + r / a.rep) * a.g.H +
                   kvh * a.rep + r % a.rep) *
                      a.g.D;
        cp_async(swizzled(base + L::kQ, L::kQBox, row, off),
                 reinterpret_cast<const char*>(src) + off, a.width);
      }
      cp_async_commit();
    }
    for (int e = 0; e < kStages; ++e) {
      if (e < items) issue(e, e);
      else if (!kTma) cp_async_commit();
    }
  }

  // m: each row's running max of its values v (row_values); l: the sum
  // of exp(x - m) over its valid positions
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float sc[32];                  // S of a block (m64n64)
  float o[DP / 2];               // O (m64nDP)
  uint32_t pp[16];               // P of a block, bf16 pairs
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) pp[i] = 0u;

  for (int e = 0; e < items; ++e) {
    const int s = e % kStages;
    if constexpr (kTma) {
      if (e == 0) {
        cp_async_wait<0>();      // Q
        fence_proxy_async();
        __syncthreads();
      }
      bar_wait(bar + 8 * s, (e / kStages) & 1);
    } else {
      cp_async_wait<kStages - 1>();   // Q and the item's block
      fence_proxy_async();
      __syncthreads();
    }
    const bool second = e >= nblk;
    const int64_t c = c0 + static_cast<int64_t>(second ? e - nblk : e) * kBN;
    // S = Q K^T: the head dim in k16 steps, in order
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(sc,
                   descriptor(base + L::kQ + (kk / 4) * L::kQBox +
                                  (kk % 4) * 32,
                              16, 1024),
                   descriptor(stage_k(s) + (kk / 4) * L::kBox + (kk % 4) * 32,
                              16, 1024),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    hold(sc);
    // each row's valid columns of this block, [ca, cz] (empty: ca > cz);
    // a warp none of whose rows has one skips the block (pass 1: an exact
    // no-op; pass 2: p = 0), and one whose rows all cover it needs no mask
    int ca[2], cz[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t dl = lo[i] - c, dh = hi[i] - c;
      ca[i] = static_cast<int>(dl < 0 ? 0 : (dl > kBN ? kBN : dl));
      cz[i] = static_cast<int>(dh < -1 ? -1 : (dh >= kBN ? kBN - 1 : dh));
    }
    const bool busy = __any_sync(kFull, ca[0] <= cz[0] || ca[1] <= cz[1]);
    const bool whole = __all_sync(kFull, ca[0] == 0 && cz[0] == kBN - 1 &&
                                             ca[1] == 0 && cz[1] == kBN - 1);
    if (busy) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v[16];
        row_values(a, sc, i, v);
        if (!whole)
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const int col = 8 * (q >> 1) + 2 * t4 + (q & 1);
            if (col < ca[i] || col > cz[i]) v[q] = -INFINITY;
          }
        if (!second) {
          // pass 1: the block's max over the row's valid columns, then its
          // sum of exp(x - max); a block without one keeps m, and l * 1 + 0
          float bm = v[0];
#pragma unroll
          for (int q = 1; q < 16; ++q) bm = fmaxf(bm, v[q]);
          bm = fmaxf(bm, __shfl_xor_sync(kFull, bm, 1));
          bm = fmaxf(bm, __shfl_xor_sync(kFull, bm, 2));
          const float mn = fmaxf(m[i], bm);
          float sum = 0.f;
          if (mn != -INFINITY) {
            const float sh = -mn * a.c;
#pragma unroll
            for (int q = 0; q < 16; ++q) sum += ex2(fmaf(v[q], a.c, sh));
          }
          sum += __shfl_xor_sync(kFull, sum, 1);
          sum += __shfl_xor_sync(kFull, sum, 2);
          const float f = mn == m[i] ? 1.f : ex2((m[i] - mn) * a.c);
          l[i] = l[i] * f + sum;
          m[i] = mn;
        } else {
          // pass 2: p = exp(x - m) / l on the valid columns, 0 elsewhere,
          // as 2^(v c - (m c + log2 l)), rounded to bf16 in pairs
          const float sh = m[i] == -INFINITY
                               ? -INFINITY
                               : -fmaf(m[i], a.c, __log2f(l[i]));
#pragma unroll
          for (int j = 0; j < 8; ++j)
            pp[2 * j + i] = pack_bf16(ex2(fmaf(v[2 * j], a.c, sh)),
                                      ex2(fmaf(v[2 * j + 1], a.c, sh)));
        }
      }
    } else if (second) {
#pragma unroll
      for (int q = 0; q < 16; ++q) pp[q] = 0u;
    }
    if (second) {
      // O += P V: the block's keys in k16 steps, in order
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t frag[4] = {pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2],
                                  pp[4 * kk + 3]};
        const uint64_t vd =
            descriptor(stage_v(s) + kk * 16 * 128, L::kBox, 1024);
        if constexpr (DP == 64)
          wgmma_rs_n64(o, frag, vd);
        else
          wgmma_rs_n128(o, frag, vd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      hold(o);
      hold(pp);
    }
    __syncthreads();             // every warp is done with stage s
    if (e + kStages < items) issue(e + kStages, s);
    else if (!kTma) cp_async_commit();
  }

  // out = O rounded once to bf16 (+ 0 turns a -0 sum into +0); zeros for
  // a query with no position to read
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * warp + g + 8 * i;
    if (r >= R) continue;
    const bool any = hi[i] >= lo[i];
    uint16_t* orow = a.out + ((static_cast<int64_t>(b) * a.g.T + r / a.rep) *
                                  a.g.H +
                              kvh * a.rep + r % a.rep) *
                                 a.g.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col >= a.g.D) break;
      const uint32_t w = any ? pack_bf16(o[4 * j + 2 * i] + 0.f,
                                         o[4 * j + 2 * i + 1] + 0.f)
                             : 0u;
      *reinterpret_cast<uint32_t*>(orow + col) = w;
    }
  }
}

// The card's kernel attribute, set once per device: the dynamic shared
// memory above 48 KB.
template <int DP, bool kTma>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(ring_attention_wgmma<DP, kTma>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Layout<DP>::kBytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// A ring's tensor map, (D, KV, S, B) in boxes of 64 columns by kBN slots.
// A map is a function of the pointer and the shape alone, so each host
// thread keeps its last few and encodes only a new one (the serving paths
// call the kernel on a few rings over and over).
int ring_map(CUtensorMap* map, const void* ptr, const Geo& g) {
  struct Entry {
    const void* ptr;
    int D, KV, S, B;
    CUtensorMap map;
  };
  constexpr int kEntries = 8;
  thread_local Entry cache[kEntries] = {};
  thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.ptr == ptr && e.D == g.D && e.KV == g.KV && e.S == g.S &&
        e.B == g.B) {
      *map = e.map;
      return 0;
    }
  const int rc = tensor_map(map, ptr, g.D, g.KV, g.S, g.B, kBN);
  if (rc) return rc;
  cache[next] = Entry{ptr, g.D, g.KV, g.S, g.B, *map};
  next = (next + 1) % kEntries;
  return 0;
}

template <int DP, bool kTma>
int launch(const Args& a, cudaStream_t st) {
  CUtensorMap km{}, vm{};
  if constexpr (kTma) {
    int rc = ring_map(&km, a.k, a.g);
    if (!rc) rc = ring_map(&vm, a.v, a.g);
    if (rc) return rc;
  }
  const cudaError_t e = allow_smem<DP, kTma>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = static_cast<int64_t>(a.g.B) * a.g.KV * a.tiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  ring_attention_wgmma<DP, kTma>
      <<<static_cast<unsigned>(blocks), kThreads, Layout<DP>::kBytes, st>>>(
          km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// route: 0 = the CUDA-core kernel, 1 = the tensor-core kernel with TMA
// copies, 2 = the tensor-core kernel with cp.async copies (the wrapper's
// ring_attention.route). dtype codes: 0 = f32, 1 = bf16. geo: B, T, H, KV,
// D, S, window, chunk (0 for none). plan: (2, B) int64 on the device,
// positions then counts.
extern "C" int ra_forward(int route, int dtype, const void* q, const void* k,
                          const void* v, void* out, const long long* geo,
                          const void* plan, float sqrt_d, void* stream) {
  Geo g{};
  g.B = static_cast<int>(geo[0]);
  g.T = static_cast<int>(geo[1]);
  g.H = static_cast<int>(geo[2]);
  g.KV = static_cast<int>(geo[3]);
  g.D = static_cast<int>(geo[4]);
  g.S = static_cast<int>(geo[5]);
  g.window = static_cast<int>(geo[6]);
  g.chunk = static_cast<int>(geo[7]);
  g.sqrt_d = sqrt_d;
  if (g.B < 0 || g.T < 0 || g.KV < 1 || g.H % g.KV != 0 || g.D < 1 ||
      g.D > kMaxD || g.S < 1 || g.window < 0 || g.chunk < 0 ||
      dtype < 0 || dtype > 1 || route < 0 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* p = static_cast<const int64_t*>(plan);
  if (route == 0)
    return dtype == 0 ? cores::launch<float>(q, k, v, out, p, g, st)
                      : cores::launch<uint16_t>(q, k, v, out, p, g, st);
  // the tensor-core kernel: bf16, D even and <= 128; TMA: D 64 or 128, S a
  // multiple of the key block, 16-byte aligned rings
  const int width = g.D % 8 == 0 ? 16 : (g.D % 4 == 0 ? 8 : 4);
  if (dtype != 1 || g.D % 2 != 0 || g.D > 128 ||
      (route == 1 && ((g.D != 64 && g.D != 128) || g.S % tc::kBN != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned need = route == 1 ? 16u : static_cast<unsigned>(width);
  if (!repro_torch::aligned(q, width) || !repro_torch::aligned(k, need) ||
      !repro_torch::aligned(v, need) || !repro_torch::aligned(out, 4))
    return static_cast<int>(cudaErrorMisalignedAddress);
  tc::Args a{};
  a.g = g;
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.out = static_cast<uint16_t*>(out);
  a.plan = p;
  a.rep = g.H / g.KV;
  a.tiles = static_cast<int>(
      (static_cast<int64_t>(g.T) * a.rep + tc::kRows - 1) / tc::kRows);
  a.width = width;
  int e2 = 0;
  a.pow2 = frexpf(sqrt_d, &e2) == 0.5f;
  a.c = a.pow2 ? tc::kLog2e / sqrt_d : tc::kLog2e;
  if (g.D <= 64)
    return route == 1 ? tc::launch<64, true>(a, st)
                      : tc::launch<64, false>(a, st);
  return route == 1 ? tc::launch<128, true>(a, st)
                    : tc::launch<128, false>(a, st);
}

extern "C" const char* ra_error_string(int err) {
  if (err == repro_torch::hopper::kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (err == repro_torch::hopper::kBadMap)
    return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
