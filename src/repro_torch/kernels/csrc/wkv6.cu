// The RWKV-6 WKV recurrence, token by token: the serving paths' time mix
// (the fixed-batch decode step, the engine's decode ticks, prefill chunks
// and speculative verify calls).
//
// It replaces no TPU kernel. The reference runs the exact recurrence as a
// lax.scan over tokens (repro/models/ssm.py, wkv_recurrent, lines 112-152),
// which XLA compiles into a loop; the port's plain version
// (kernels/ref.py, wkv6_recurrent_ref) is the same scan in PyTorch, some
// seven launches per token and layer. A 1,024-token prefill chunk through
// RWKV-6 7B's 32 layers would be about 230,000 launches; here it is one
// per layer.
//
// Layout: r, k, v and out (B, T, H, K), contiguous, f32 or bf16 (one dtype);
// w_log (B, T, H, K) f32; u (H, K) f32; state (B, H, K, K) f32, indexed
// [k][v]; valid (B, T) bytes (0 or 1) or null (every token valid); the new
// state (B, H, K, K), or with collect the state after every token (B, T, H,
// K, K). Every pointer but valid 16-byte aligned. In f32, with w =
// exp(w_log), for each token t of row b, head h:
//   a       = sum_k r[k] * u[k] * k[k]                  (the bonus, O(K))
//   o[v]    = sum_k r[k] * S[k][v] + a * v[v]
//   S[k][v] = w[k] * S[k][v] + k[k] * v[v]       (only where valid[b, t])
// o rounds once to the input type. This is the plain version's function
// (o = r . (S + diag(u) k v^T)) up to the order of its sums and its
// roundings: every operation here is an explicit __f*_rn intrinsic, never
// contracted otherwise, in an order fixed as follows.
//
// The order, and why a token has the same bits in any call. A thread owns
// R = rows_for(K) state rows (2 at K = 16, 4 at 64) by C columns, in
// registers for the whole call. Its share of o[v] is p_g[v] = r[gR]
// S[gR][v] (a product), then + r[i] S[i][v] for the rows i of its group g
// in order (fused multiply-adds); o[v] = (((p_0 + p_1) + p_2) + ... +
// p_{K/R-1}) then a * v[v] fused onto that. The bonus a is, for each quad
// of k (4q .. 4q + 3), the products (r[k] u[k]) k[k] summed in k order (a
// product, then fused multiply-adds), then the K / 4 quads' partials by a
// butterfly of xor shuffles over K / 4 lanes. The update is one product
// k[k] v[v] and one fused multiply-add per element, where valid (an
// invalid token's select keeps S's bits). R, the quads and the butterfly
// depend on K alone: no sum's order depends on B, T, the column grouping,
// the columns a thread owns, the tile length, the threads a block has,
// valid or collect, and nothing is shared between rows or heads. So a
// decode tick, a verify call and a prefill chunk round a token's o and
// state alike, and a prompt split across chunks leaves the bits of one
// call; the slot paths' bitwise streams rest on it, as they do on
// ring_attention's. (The launch plan depends on B and T, as
// ring_attention.route depends on dtype, head dim and ring length; like
// it, the plan changes no sum.)
//
// Design (the launch plan is wkv.plan's, in Python; this file checks it):
// - Grid: one block per (row, head, column group of G columns). The K
//   columns of S are independent (o[v] and S[.][v] read only column v), so
//   G cuts the state without touching any column's arithmetic. wkv.plan
//   takes G = 32 at one row of 64 heads (128 blocks on 132 SMs for a
//   prefill chunk) and G = 64 from 128 (row, head) pairs on (decode ticks,
//   verify calls) where r, k, v are bf16.
// - Block: owner warps and helper warps. The owners, (K / R) x (G / C),
//   hold R x C state elements each (C = 4; C = 16 at G = 64, so a tick's
//   512 blocks fit in one wave), read and write them once with 16-byte
//   accesses, and with collect store every token's state from registers.
//   Per token an owner reads its rows of r, k, w and its columns of v from
//   shared memory (bf16 r, k, v as they landed, widened in registers),
//   does 3 R C operations, two tokens a round with the next token's inputs
//   loaded before the current token's arithmetic, and writes its C
//   partials of o. A tile whose tokens are all valid runs a loop without
//   the valid select.
// - The helpers (as many as the owners where C = 4, else one warp) bring
//   each tile of at most 32 tokens (r, k, the block's v columns, w_log) by
//   cp.async into one of 3 stages, two tiles ahead; valid comes by a load
//   a tile ahead. They take exp(w_log) once per element and token in the
//   block and the bonus a per token, and after the owners' tile, sum its
//   partials in the fixed order and store o. Named barriers pass each tile
//   between the two (ready: prepared; done: partials written), with 2
//   buffers of w and of the partials, so the helpers prepare tile i + 1
//   and sum tile i - 1 while the owners run tile i.
//
// Bound: at a decode tick the state's bytes (B H K^2 f32, read and written
// once), 16.8 MB at 8 slots of RWKV-6 7B's 64 heads of 64: 0.005 ms at 3.35
// TB/s. At a 1,024-token prefill chunk the operations the recurrence needs:
// 5 K^2 + 5 K a token and head, 1.4e9 at 64 heads, 0.020 ms at the card's
// 67 TFLOP/s of f32 outside the tensor cores (wkv.work counts both). The
// owners issue 3 instructions an element and token (a product and two
// fused multiply-adds) and about a third more for loads, widening and
// stores: 0.030 ms at one instruction a cycle per scheduler. At one row,
// B H K^2 = 262,144 elements are 15.5 a lane of the card, so one owner
// warp a scheduler, which nothing else can hide the latency of, and the
// helpers' exp, bonus and sums share its issue slots (PERF.md: what holds
// the chunk at 0.09 ms).
//
// Why no tensor cores: the chunked form (S carried across chunks of C
// tokens by matrix products) would let a tensor core do most of a chunk's
// work, but a token's o would then depend on where its call's chunk
// begins: a decode tick, a verify call and a prefill chunk would round the
// same token differently, and the slot paths' bitwise contract would fail.
// The exact recurrence is K^2-parallel per token and head and needs no
// product of matrices, so it stays on the CUDA cores in a fixed order.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxTile = 32;          // tokens a tile, at most
constexpr int kMaxSmem = 232448;      // 227 KB, a block's most on sm_90
// named barriers (0 is __syncthreads): the helpers among themselves, then
// a tile's inputs ready and its partials done, one of each per buffer
constexpr int kBarHelpers = 1, kBarReady = 2, kBarDone = 4;

// The state rows a thread owns and sums in order: K alone fixes it.
__host__ __device__ constexpr int rows_for(int K) { return K == 16 ? 2 : 4; }
// The state columns a thread owns: 16 where a block holds all 64 columns
// (enough blocks, few tokens), else 4.
__host__ __device__ constexpr int cols_for(int G) { return G == 64 ? 16 : 4; }
// Threads: the state owners, K / R by G / C; the helpers (copies, the
// prepare and o's sum), as many where C = 4, else one warp.
__host__ __device__ constexpr int owners_for(int K, int G) {
  return (K / rows_for(K)) * (G / cols_for(G));
}
__host__ __device__ constexpr int helpers_for(int K, int G) {
  return cols_for(G) == 4 ? owners_for(K, G) : 32;
}
// Blocks an SM must hold: 4 where the owners hold 16 columns (a decode
// tick's 512 blocks in one wave on 132 SMs), else 2.
__host__ __device__ constexpr int min_blocks_for(int G) {
  return cols_for(G) == 16 ? 4 : 2;
}

// Byte offsets of a block's shared memory: `raws` stages (3, or fewer
// where the call has fewer tiles) of a tile's raw inputs, as the copies
// land: a record of 2 K + G elements a token (r, k, the block's v columns)
// and w_log; `bufs` buffers (2, or 1 for one tile) of w = exp(w_log) (K
// floats a token), a and valid a token; and `bufs` of the o partials
// (tile, K / R, G). wkv.plan computes the same total.
struct Layout {
  int raw_w, raw;                       // within a stage; records at 0
  int fa, fm, work;                     // within work; w at 0
  int part;                             // bytes of one partials buffer
  int work0, part0, bytes;              // the first buffer of each
};

__host__ __device__ inline Layout layout(int K, int G, int tile, int isz,
                                         int tiles) {
  const int raws = tiles < 3 ? tiles : 3, bufs = tiles < 2 ? tiles : 2;
  Layout L;
  L.raw_w = tile * (2 * K + G) * isz;
  L.raw = L.raw_w + tile * K * 4;
  L.fa = tile * K * 4;
  L.fm = L.fa + tile * 4;
  L.work = (L.fm + tile + 15) & ~15;
  L.part = tile * (K / rows_for(K)) * G * 4;
  L.work0 = raws * L.raw;
  L.part0 = L.work0 + bufs * L.work;
  L.bytes = L.part0 + bufs * L.part;
  return L;
}

template <class S>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};

// bf16 travels as its raw 16 bits and widens exactly; the output rounds to
// nearest even, as PyTorch's cast does.
template <>
struct Io<uint16_t> {
  static __device__ __forceinline__ float4 load4(const uint16_t* p) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  }
  static __device__ __forceinline__ float2 load2(const uint16_t* p) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
  static __device__ __forceinline__ unsigned bf(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store4(uint16_t* p, float4 x) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf(x.x) | (bf(x.y) << 16), bf(x.z) | (bf(x.w) << 16));
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One token's inputs to an owner's tile: its R rows of r, k and w, its C
// columns of v, and valid.
template <int R, int C>
struct In {
  float r[R], k[R], w[R];
  float4 v[C / 4];
  bool keep;
};

// R consecutive values, widened to f32.
template <int R, class S>
__device__ __forceinline__ void load_rows(const S* p, float (&x)[R]) {
  if constexpr (R == 4) {
    const float4 a = Io<S>::load4(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  } else {
    const float2 a = Io<S>::load2(p);
    x[0] = a.x, x[1] = a.y;
  }
}

__device__ __forceinline__ float comp(float4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// `rows` rows of `row_bytes` (a multiple of 16), `stride` bytes apart in
// device memory, to rows `pitch` bytes apart in shared memory: helper
// `ht`'s share of the 16-byte copies.
template <int kHelpers>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const void* src,
                                          int rows, int row_bytes, int pitch,
                                          int64_t stride, int ht) {
  const int per = row_bytes / 16;
  const char* s = static_cast<const char*>(src);
  for (int i = ht; i < rows * per; i += kHelpers) {
    const int t = i / per, j = i - t * per;
    cp_async16(dst + t * pitch + j * 16, s + t * stride + j * 16);
  }
}

// A block: owners (threads 0 .. NO - 1) hold R x C of the state of one
// (row, head) and its column group in registers and run the recurrence;
// helpers (the next NH threads) copy tiles in, prepare them and sum o.
// Tile i lands in raw stage i % 3 and uses buffer i % 2 of w and of the
// partials: while the owners run tile i, the helpers prepare tile i + 1,
// sum tile i - 1's o and copy tile i + 2 in.
template <class S, int K, int G, bool kCollect>
__global__ void __launch_bounds__(owners_for(K, G) + helpers_for(K, G),
                                  min_blocks_for(G))
wkv6_kernel(const S* __restrict__ r, const S* __restrict__ k,
            const S* __restrict__ v, const float* __restrict__ w_log,
            const float* __restrict__ u, const float* __restrict__ state,
            const uint8_t* __restrict__ valid, S* __restrict__ out,
            float* __restrict__ state_out, int T, int H, int tile) {
  constexpr int R = rows_for(K), C = cols_for(G);
  constexpr int NG = K / R;             // row groups: o's partials a column
  constexpr int NC = G / C;             // owners along the columns
  constexpr int NO = owners_for(K, G), NH = helpers_for(K, G);
  constexpr int NQ = K / 4;             // quads of k in the bonus
  constexpr int GQ = G / 4;             // quads of the block's columns
  constexpr int REC = 2 * K + G;        // elements of a token's raw record
  static_assert(NO % 32 == 0 && NH % 32 == 0 && 32 % NQ == 0,
                "whole warps, whole quads");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = (T + tile - 1) / tile;
  const Layout L = layout(K, G, tile, sizeof(S), tiles);

  const int groups = K / G;
  const int bh = blockIdx.x / groups;   // b * H + h
  const int cg = blockIdx.x - bh * groups;
  const int b = bh / H, h = bh - b * H;
  const int64_t row_tok = static_cast<int64_t>(b) * T;
  const int all = NO + NH;
  auto raw_of = [&](int i) { return smem + (i % 3) * L.raw; };
  auto work_of = [&](int i) { return smem + L.work0 + (i & 1) * L.work; };
  auto part_of = [&](int i) {
    return reinterpret_cast<float*>(smem + L.part0 + (i & 1) * L.part);
  };

  if (threadIdx.x >= NO) {
    // ------------------------------------------------------------ helpers
    const int ht = threadIdx.x - NO;
    const int q = ht % NQ;              // its quad in the prepare
    const int64_t stride = static_cast<int64_t>(H) * K;
    auto issue = [&](int i) {           // tile i's copies, one group
      if (i < tiles) {
        const int t0 = i * tile, n = min(tile, T - t0);
        unsigned char* dst = raw_of(i);
        const int64_t at = ((row_tok + t0) * H + h) * K;
        constexpr int pitch = REC * sizeof(S);
        copy_rows<NH>(dst, r + at, n, K * sizeof(S), pitch,
                      stride * sizeof(S), ht);
        copy_rows<NH>(dst + K * sizeof(S), k + at, n, K * sizeof(S), pitch,
                      stride * sizeof(S), ht);
        copy_rows<NH>(dst + 2 * K * sizeof(S), v + at + cg * G, n,
                      G * sizeof(S), pitch, stride * sizeof(S), ht);
        copy_rows<NH>(dst + L.raw_w, w_log + at, n, K * 4, K * 4, stride * 4,
                      ht);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    auto keep_of = [&](int i) -> uint8_t {  // valid, a tile ahead
      const int t = i * tile + ht;
      return valid != nullptr && i < tiles && ht < min(tile, T - i * tile)
                 ? valid[row_tok + t]
                 : 1;
    };
    // o of tile m: its partials in row-group order, then a v
    auto sum = [&](int m) {
      const int m0 = m * tile, nm = min(tile, T - m0);
      const S* rv = reinterpret_cast<const S*>(raw_of(m)) + 2 * K;
      const float* fa = reinterpret_cast<const float*>(work_of(m) + L.fa);
      const float* part = part_of(m);
      for (int it = ht; it < nm * GQ; it += NH) {
        const int t = it / GQ, c = it - t * GQ;
        const float* pp = part + t * NG * G + c * 4;
        float4 acc = ld4(pp);
#pragma unroll
        for (int gg = 1; gg < NG; ++gg) {
          const float4 x = ld4(pp + gg * G);
          acc = make_float4(__fadd_rn(acc.x, x.x), __fadd_rn(acc.y, x.y),
                            __fadd_rn(acc.z, x.z), __fadd_rn(acc.w, x.w));
        }
        const float a = fa[t];
        const float4 vv = Io<S>::load4(rv + t * REC + c * 4);
        Io<S>::store4(out + ((row_tok + m0 + t) * H + h) * K + cg * G + c * 4,
                      make_float4(__fmaf_rn(a, vv.x, acc.x),
                                  __fmaf_rn(a, vv.y, acc.y),
                                  __fmaf_rn(a, vv.z, acc.z),
                                  __fmaf_rn(a, vv.w, acc.w)));
      }
    };
    issue(0);
    issue(1);
    issue(2);
    uint8_t keep = keep_of(0);
    const float4 u4 = ld4(u + h * K + q * 4);
    for (int i = 0; i <= tiles; ++i) {
      if (i < tiles) {
        const int n = min(tile, T - i * tile);
        // tile i's copies: the groups of the tiles after it may still fly
        if (i == 0)
          asm volatile("cp.async.wait_group 2;\n" ::: "memory");
        else
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        bar_sync(kBarHelpers, NH);      // every helper's copies are in
        const uint8_t keep_next = keep_of(i + 1);
        const S* rr = reinterpret_cast<const S*>(raw_of(i));
        const float* rw = reinterpret_cast<const float*>(raw_of(i) + L.raw_w);
        unsigned char* work = work_of(i);
        float* fw = reinterpret_cast<float*>(work);
        float* fa = reinterpret_cast<float*>(work + L.fa);
        // valid a token, 1 past n up to a whole word (the owners read words)
        if (ht < ((n + 3) & ~3)) work[L.fm + ht] = ht < n ? keep : 1;
        // w = exp(w_log) and the bonus a per token
        const int items = (n * NQ + 31) & ~31;   // whole warps shuffle
        for (int it = ht; it < items; it += NH) {
          const int t = it / NQ;         // it % NQ == q
          float4 r4 = make_float4(0.f, 0.f, 0.f, 0.f), k4 = r4;
          if (t < n) {
            r4 = Io<S>::load4(rr + t * REC + q * 4);
            k4 = Io<S>::load4(rr + t * REC + K + q * 4);
            const float4 wl = ld4(rw + t * K + q * 4);
            st4(fw + t * K + q * 4, make_float4(expf(wl.x), expf(wl.y),
                                                expf(wl.z), expf(wl.w)));
          }
          float p = __fmul_rn(__fmul_rn(r4.x, u4.x), k4.x);
          p = __fmaf_rn(__fmul_rn(r4.y, u4.y), k4.y, p);
          p = __fmaf_rn(__fmul_rn(r4.z, u4.z), k4.z, p);
          p = __fmaf_rn(__fmul_rn(r4.w, u4.w), k4.w, p);
#pragma unroll
          for (int off = 1; off < NQ; off <<= 1)
            p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
          if (t < n && q == 0) fa[t] = p;
        }
        keep = keep_next;
        bar_arrive(kBarReady + (i & 1), all);
      }
      if (i > 0) {
        bar_sync(kBarDone + ((i - 1) & 1), all);
        sum(i - 1);
        bar_sync(kBarHelpers, NH);      // raw stage (i - 1) % 3 is read
        issue(i + 2);
      }
    }
    return;
  }

  // -------------------------------------------------------------- owners
  const int tid = threadIdx.x;
  const int g = tid / NC, cq = tid - g * NC;
  const int row0 = g * R;               // the thread's rows; its column
  // quads are cq + NC j, j < C / 4 (neighbours on neighbouring quads)
  float s[R][C];
  const float* s0 = state + static_cast<int64_t>(bh) * K * K + cg * G;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      const float4 x = ld4(s0 + (row0 + i) * K + (cq + NC * j) * 4);
      s[i][4 * j] = x.x, s[i][4 * j + 1] = x.y, s[i][4 * j + 2] = x.z,
      s[i][4 * j + 3] = x.w;
    }
  for (int i = 0; i < tiles; ++i) {
    const int t0 = i * tile, n = min(tile, T - t0);
    // a token's r and k rows and v columns from its raw record, w from
    // the prepared buffer: three bases a thread, the rest immediate offsets
    const S* prow = reinterpret_cast<const S*>(raw_of(i)) + row0;
    const S* pcol = reinterpret_cast<const S*>(raw_of(i)) + 2 * K + cq * 4;
    const float* pw = reinterpret_cast<const float*>(work_of(i)) + row0;
    const uint8_t* fm = work_of(i) + L.fm;
    float* part = part_of(i) + g * G + cq * 4;
    auto load = [&](int t) {
      In<R, C> x;
      load_rows<R>(prow + t * REC, x.r);
      load_rows<R>(prow + t * REC + K, x.k);
      load_rows<R>(pw + t * K, x.w);
#pragma unroll
      for (int j = 0; j < C / 4; ++j)
        x.v[j] = Io<S>::load4(pcol + t * REC + NC * j * 4);
      x.keep = fm[t] != 0;
      return x;
    };
    // one token; with `masked`, valid may skip its update (S keeps its
    // bits)
    auto step = [&](const In<R, C>& x, int t, auto masked) {
      float p[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p[c] = __fmul_rn(x.r[0], s[0][c]);
#pragma unroll
        for (int ii = 1; ii < R; ++ii)
          p[c] = __fmaf_rn(x.r[ii], s[ii][c], p[c]);
      }
#pragma unroll
      for (int ii = 0; ii < R; ++ii)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float nxt = __fmaf_rn(
              x.w[ii], s[ii][c], __fmul_rn(x.k[ii], comp(x.v[c / 4], c % 4)));
          if constexpr (decltype(masked)::value)
            s[ii][c] = x.keep ? nxt : s[ii][c];
          else
            s[ii][c] = nxt;
        }
      float* pp = part + t * NG * G;
#pragma unroll
      for (int j = 0; j < C / 4; ++j)
        st4(pp + NC * j * 4,
            make_float4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]));
      if constexpr (kCollect) {
        float* dst = state_out + ((row_tok + t0 + t) * H + h) *
                                     static_cast<int64_t>(K) * K + cg * G;
#pragma unroll
        for (int ii = 0; ii < R; ++ii)
#pragma unroll
          for (int j = 0; j < C / 4; ++j)
            st4(dst + (row0 + ii) * K + (cq + NC * j) * 4,
                make_float4(s[ii][4 * j], s[ii][4 * j + 1], s[ii][4 * j + 2],
                            s[ii][4 * j + 3]));
      }
    };
    // two tokens a round, each's inputs loaded a token ahead of its use
    auto run = [&](auto masked) {
      In<R, C> a = load(0);
      int t = 0;
      for (; t + 1 < n; t += 2) {
        const In<R, C> nb = load(t + 1);
        step(a, t, masked);
        a = load(t + 2 < n ? t + 2 : t + 1);
        step(nb, t + 1, masked);
      }
      if (t < n) step(a, t, masked);
    };
    bar_sync(kBarReady + (i & 1), all);
    bool every = true;                  // every token of the tile valid
    for (int w = 0; w < (n + 3) / 4; ++w)
      every &= reinterpret_cast<const uint32_t*>(fm)[w] == 0x01010101u;
    if (every)
      run(std::false_type());
    else
      run(std::true_type());
    bar_arrive(kBarDone + (i & 1), all);
  }
  if constexpr (!kCollect) {
    float* dst = state_out + static_cast<int64_t>(bh) * K * K + cg * G;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C / 4; ++j)
        st4(dst + (row0 + i) * K + (cq + NC * j) * 4,
            make_float4(s[i][4 * j], s[i][4 * j + 1], s[i][4 * j + 2],
                        s[i][4 * j + 3]));
  }
}

// Raise an instantiation's dynamic shared memory limit to kMaxSmem, once
// per device (each card holds its own function attributes).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (*done & (1u << dev)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess) *done |= 1u << dev;
  return e;
}

template <class S, int K, int G>
int launch(bool collect, const void* r, const void* k, const void* v,
           const void* w_log, const void* u, const void* state,
           const void* valid, void* out, void* state_out, int B, int T, int H,
           int tile, int threads, int smem, cudaStream_t stream) {
  constexpr int NT = owners_for(K, G) + helpers_for(K, G);
  const Layout L = layout(K, G, tile, sizeof(S), (T + tile - 1) / tile);
  if (threads != NT || tile < 1 || tile > kMaxTile || smem != L.bytes ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned done[2];
  auto kernel = collect ? wkv6_kernel<S, K, G, true>
                        : wkv6_kernel<S, K, G, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem(kernel, &done[collect]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B * H * (K / G), NT, smem, stream>>>(
      static_cast<const S*>(r), static_cast<const S*>(k),
      static_cast<const S*>(v), static_cast<const float*>(w_log),
      static_cast<const float*>(u), static_cast<const float*>(state),
      static_cast<const uint8_t*>(valid), static_cast<S*>(out),
      static_cast<float*>(state_out), T, H, tile);
  return static_cast<int>(cudaGetLastError());
}

template <class S>
int dispatch(bool collect, const void* r, const void* k, const void* v,
             const void* w_log, const void* u, const void* state,
             const void* valid, void* out, void* state_out, int B, int T,
             int H, int K, int group, int tile, int threads, int smem,
             cudaStream_t stream) {
#define WKV6_CASE(KK, GG)                                                   \
  if (K == KK && group == GG)                                               \
    return launch<S, KK, GG>(collect, r, k, v, w_log, u, state, valid, out, \
                             state_out, B, T, H, tile, threads, smem, stream);
  WKV6_CASE(16, 16)
  WKV6_CASE(64, 16)
  WKV6_CASE(64, 32)
  // 16 columns of f32 v an owner would not fit its registers: f32 inputs
  // stop at groups of 32
  if constexpr (sizeof(S) == 2) {
    WKV6_CASE(64, 64)
  }
#undef WKV6_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 f32, 1 bf16 (r, k, v and out). valid may be null. The launch
// plan (wkv.plan): group, the state columns a block owns (16, 32 or, for
// bf16, 64; at most K); tile, the tokens staged at a time (1 to 32); threads, the
// owners and helpers of a block; smem, the dynamic shared memory bytes of
// that layout. Another plan is refused. K in {16, 64}; T >= 1; every
// pointer but valid 16-byte aligned.
extern "C" int wkv6_forward(int dtype, int collect, const void* r,
                            const void* k, const void* v, const void* w_log,
                            const void* u, const void* state,
                            const void* valid, void* out, void* state_out,
                            int B, int T, int H, int K, int group, int tile,
                            int threads, int smem, void* stream) {
  const void* ptrs[] = {r, k, v, w_log, u, state, out, state_out};
  for (const void* p : ptrs)
    if (!repro_torch::aligned(p, 16))
      return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || T < 1 || H < 1 || dtype < 0 || dtype > 1 || group < 1 ||
      K % group != 0 ||
      static_cast<int64_t>(B) * H * (K / group) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch<float>(collect != 0, r, k, v, w_log, u, state, valid,
                               out, state_out, B, T, H, K, group, tile,
                               threads, smem, st)
             : dispatch<uint16_t>(collect != 0, r, k, v, w_log, u, state,
                                  valid, out, state_out, B, T, H, K, group,
                                  tile, threads, smem, st);
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
