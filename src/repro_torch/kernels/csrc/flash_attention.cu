// Flash attention forward for Hopper: blocked online-softmax attention over
// the model's own layouts, q (B, T, H, dh) and k, v (B, T, KV, dh), with
// grouped-query heads read in place (query head h reads K/V head h / rep).
//
// Replaces the Pallas TPU kernel _kernel of src/repro/kernels/flash_attention.py
// (:30, via flash_attention :70, pallas_call at :86), which is the VMEM-tiled
// form of the model's XLA scan layers._flash_sdpa (layers.py:324). The Pallas
// kernel takes GQA heads pre-broadcast to (B*H, T, dh); this one does not copy
// K and V per query head.
//
// Semantics, as _flash_sdpa's: masks from positions (causal k <= q; window
// k > q - window; chunk k / chunk == q / chunk; keys past T), running max m,
// denominator l and accumulator in f32, out = acc / max(l, 1e-30). It also
// writes lse = m + log(l) per row, f32 (B, H, T), which the backward needs.
// In bf16 the logit tile is rounded to bf16 before the f32 scale, and P to
// bf16 before the PV product, as the reference rounds; the PV products
// accumulate in f32 across key tiles (the reference rounds each 512-key
// tile's product to bf16; the tiles differ, so the two agree within a
// tolerance, not bitwise). The running max starts at the reference's finite
// sentinel -1e30. The reference also gives masked logits -1e30, so a row's
// fully masked tiles before its first visible key give p = 1 there, which
// that key's alpha = exp(-1e30 - m) = 0 then erases: the f32 kernel does the
// same; the bf16 kernel gives masked logits -2^100 (below the sentinel) and
// p = 0 directly, which is the same result for every row that sees a key,
// and every real row sees itself. Tiles that the mask leaves empty for every
// row of the block are skipped (causal: keys past the block's last query;
// window and chunk: keys before or after their range). head_dim is 64 or
// 128; the wrapper zero-pads any other width up to 128 and passes the true
// width's scale.
//
// Bound: operations. At the training path's shape, (4, 4096, 36, 64) bf16
// causal, the products take 4 * B * H * dh * T (T + 1) / 2 = 3.1e11 FLOP
// (0.31 ms at the dense bf16 tensor-core peak) against 302 MB of q, k, v and
// out (0.09 ms at the HBM rate). At head_dim 64 the softmax is as large as
// the products: per (query, key) pair the products take 1/16 of an SM clock
// on the tensor cores and the exp 1/16 on the SFUs (4 lanes a clock per SM
// sub-partition), so the softmax has to run beside the products.
//
// bf16 design (flash_fwd_wgmma): one CTA per kBQ query rows of one (batch,
// head), with one producer warpgroup and kConsumers consumer warpgroups of
// 64 rows each: three at head_dim 64 (192 rows, 160 registers a thread),
// two at 128 (128 rows, 232 registers), where the O accumulator is twice
// the size. The producer gives up registers (setmaxnreg) and one of its
// threads issues TMA copies: boxes of 64 columns (128 bytes, one 128-byte
// swizzle atom) by kBQ rows (Q) or 128 rows (K, V) from a 4-D tensor map
// over (dh, heads, T, B), so K/V head h / rep is read in place and keys
// past T arrive as zeros (and are masked). Q is loaded once; K and V go
// through a ring of kStages stages with full and empty barriers for each,
// the empty ones arrived at by every consumer thread: K once its S is
// computed, V once its P V is. TMA over cp.async: one thread issues each
// 16 KB box, with no registers or address arithmetic in the consumers, and
// the swizzle the wgmma descriptors read is the one the hardware writes.
// S = Q K^T is wgmma m64n128k16 with Q and K both read from shared memory
// (K-major, 128-byte swizzle); the softmax turns S into p in place (f32),
// and once the previous tile's P V is done p is rounded to bf16 and packed
// into the A operand of O += P V (wgmma m64nDHk16, register A), with V read
// from shared memory as an MN-major B, so wgmma transposes it and no pass
// of ours does. Each consumer issues S of tile i and P V of tile i - 1
// together (FlashAttention-3's order); the first tile is peeled off, so
// every wait has a depth fixed at compile time: a wait whose depth is
// chosen at run time makes ptxas serialize every wgmma. The softmax takes
// the row max on bf16 pairs (the rounded logits) and exp as ex2.approx(b *
// scale * log2 e - m * scale * log2 e) in one FFMA, with m the max of the
// unscaled bf16 logits b (the scale is positive, so m * scale is the
// reference's max exactly); its error (a few ulp of p) is far inside
// FLASH_TOL's bf16 limit and adds under 1e-6 to lse (FLASH_LSE_TOL is
// 1e-5). The per-element mask runs only on tiles that cross the diagonal,
// a window or chunk edge, or T, as one key interval per row. The query
// blocks of a (batch, head) launch together, heaviest causal block first,
// so the CTAs in flight share K and V in L2 and the tail is short.
// ptxas schedules register-only work after the next wgmma wait when
// nothing ties it there, which would take the softmax out of P V's shadow;
// each consumer therefore stores its row sums (which depend on every p of
// the tile) to a scratch word just before the wait.
//
// What holds it back (PERF.md §6): 0.82-0.86 ms at the path's shape,
// 37 % of its bound, against SDPA's 0.73 ms. Copies are not the limit
// (taking the K and V reloads out changes nothing); a warpgroup's products
// and softmax still overlap only in part, and the exp alone and the
// products alone each need about as long as the bound.
//
// f32 inputs (the tests' precision check, not on the main path) take the
// simpler kernel flash_fwd_f32: one CTA of four warps per 64 query rows, K
// and V staged through padded shared memory by all threads, the products in
// scalar f32 FMAs, expf.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, T, H, KV, rep;
  int causal, window, chunk;   // window, chunk: 0 = none
  float scale;
};

// The keys [kbeg, kend) that any query in [q0, q_last] can see, kbeg rounded
// down to a multiple of `tile`.
__device__ __forceinline__ void key_range(const Params& p, int q0, int q_last,
                                          int tile, int& kbeg, int& kend) {
  kbeg = 0;
  kend = p.T;
  if (p.causal) kend = min(kend, q_last + 1);
  if (p.window > 0) kbeg = max(kbeg, q0 - p.window + 1);
  if (p.chunk > 0) {
    kbeg = max(kbeg, (q0 / p.chunk) * p.chunk);
    kend = min(kend, (q_last / p.chunk + 1) * p.chunk);
  }
  kbeg = (kbeg / tile) * tile;
}

// The keys [lo, hi] that query qp sees: every mask kind is an interval.
__device__ __forceinline__ void visible_keys(const Params& p, int qp, int& lo,
                                             int& hi) {
  lo = 0;
  hi = p.T - 1;
  if (p.causal) hi = min(hi, qp);
  if (p.window > 0) lo = max(lo, qp - p.window + 1);
  if (p.chunk > 0) {
    const int c0 = (qp / p.chunk) * p.chunk;
    lo = max(lo, c0);
    hi = min(hi, c0 + p.chunk - 1);
  }
}

// ------------------------------------------------------------------ f32 path

namespace f32 {

constexpr int kBQ = 64;        // query rows per CTA, 16 per warp
constexpr int kBK = 64;        // keys per tile
constexpr int kWarps = 4;
constexpr int kPad = 4;

template <int DH>
constexpr size_t smem_bytes() {
  return 3u * kBQ * (DH + kPad) * sizeof(float) +
         kBQ * (kBK + kPad) * sizeof(float);
}

// 64 rows of DH values from global memory (row stride `stride` elements)
// into shared memory (row stride DH + kPad), rows at or past `valid` zeroed.
template <int DH>
__device__ __forceinline__ void load_tile(float* s, const float* g, int valid,
                                          size_t stride) {
  constexpr int LD = DH + kPad;
  constexpr int PER_ROW = DH / 4;
  for (int i = threadIdx.x; i < kBQ * PER_ROW; i += kWarps * 32) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = *reinterpret_cast<const float4*>(g + r * stride + c);
    *reinterpret_cast<float4*>(s + r * LD + c) = val;
  }
}

// A thread holds elements (row g, cols 2t, 2t+1) in [0], [1] and (row g + 8,
// the same cols) in [2], [3] of each 8-column tile (g = lane / 4, t = lane %
// 4), the layout of an mma m16n8 accumulator.
template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_f32(const Params p) {
  constexpr int LD = DH + kPad;
  constexpr int NT = kBK / 8;        // 8-key tiles of S
  constexpr int DT = DH / 8;         // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int T_ = p.T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;                 // local rows r0, r0 + 8
  const size_t qstride = static_cast<size_t>(p.H) * DH;
  const size_t kstride = static_cast<size_t>(p.KV) * DH;
  const float* qg = static_cast<const float*>(p.q) +
                    (static_cast<size_t>(b) * T_ + q0) * qstride +
                    static_cast<size_t>(h) * DH;
  const size_t kv_off = static_cast<size_t>(b) * T_ * kstride +
                        static_cast<size_t>(h / p.rep) * DH;
  const float* kg = static_cast<const float*>(p.k) + kv_off;
  const float* vg = static_cast<const float*>(p.v) + kv_off;

  load_tile<DH>(Qs, qg, min(kBQ, T_ - q0), qstride);
  int kbeg, kend;
  key_range(p, q0, min(q0 + kBQ, T_) - 1, kBK, kbeg, kend);
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;

  __syncthreads();
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();                   // every warp is done with the last tile
    const int valid = min(kBK, T_ - k0);
    load_tile<DH>(Ks, kg + static_cast<size_t>(k0) * kstride, valid, kstride);
    load_tile<DH>(Vs, vg + static_cast<size_t>(k0) * kstride, valid, kstride);
    __syncthreads();

    // ---- S = Q K^T, scaled, masked
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* qr = Qs + (r0 + (i >> 1) * 8) * LD;
        const float* kr = Ks + (nt * 8 + 2 * t + (i & 1)) * LD;
        float acc = 0.f;
        for (int d = 0; d < DH; ++d) acc = fmaf(qr[d], kr[d], acc);
        s[nt][i] = acc * p.scale;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + nt * 8 + 2 * t + (i & 1);
        const int qp = qpos[i >> 1];
        bool ok = kp < T_;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        if (p.chunk > 0) ok = ok && (kp / p.chunk) == (qp / p.chunk);
        if (!ok) s[nt][i] = kNeg;
      }
    }

    // ---- online softmax; l is this thread's share of the row sum
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * rr], s[nt][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = expf(m[rr] - mx);
      m[rr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][2 * rr] = expf(s[nt][2 * rr] - mx);
        s[nt][2 * rr + 1] = expf(s[nt][2 * rr + 1] - mx);
        sum += s[nt][2 * rr] + s[nt][2 * rr + 1];
      }
      l[rr] = l[rr] * alpha + sum;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * rr] *= alpha;
        o[d][2 * rr + 1] *= alpha;
      }
    }

    // ---- O += P V
    float* pw = Ps + warp * 16 * (kBK + kPad);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pw[(g + (i >> 1) * 8) * (kBK + kPad) + nt * 8 + 2 * t + (i & 1)] =
            s[nt][i];
    __syncwarp();
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* pr = pw + (g + (i >> 1) * 8) * (kBK + kPad);
        const int col = d * 8 + 2 * t + (i & 1);
        float acc = 0.f;
        for (int j = 0; j < kBK; ++j) acc = fmaf(pr[j], Vs[j * LD + col], acc);
        o[d][i] += acc;
      }
    __syncwarp();
  }

  // ---- epilogue: full row sums, out = acc / max(l, 1e-30), lse
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int qp = qpos[rr];
    if (qp >= T_) continue;
    const float inv_l = 1.f / fmaxf(l[rr], 1e-30f);
    float* orow = static_cast<float*>(p.o) +
                  (static_cast<size_t>(b) * T_ + qp) * qstride +
                  static_cast<size_t>(h) * DH;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(orow + d * 8 + 2 * t) =
          make_float2(o[d][2 * rr] * inv_l, o[d][2 * rr + 1] * inv_l);
    if (t == 0)
      p.lse[(static_cast<size_t>(b) * p.H + h) * T_ + qp] =
          m[rr] + logf(l[rr]);
  }
}

template <int DH>
int launch(const Params& p, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.T + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_f32<DH><<<grid, kWarps * 32, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ----------------------------------------------------------------- bf16 path

namespace hopper {

constexpr int kBK = 128;             // keys per tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kBox = kBK * 128;      // bytes of a K or V box: 128 rows x 64 bf16
constexpr float kLog2e = 1.4426950408889634f;
// a masked key's logit: below the -1e30 sentinel the running max starts
// from, and a bf16 value, so rounding keeps it
constexpr float kMasked = -0x1p100f;

// Per head_dim: consumer warpgroups (64 query rows each) and registers.
// At head_dim 64 three consumers (192 rows) hide the latencies that two
// leave open there; at 128 the O accumulator's 64 registers allow two.
// The producer warpgroup drops to kProducerRegs so the consumers can take
// kConsumerRegs: 128 kProducerRegs + 128 kConsumers kConsumerRegs <= 64 K.
// Shared memory, from a 1024-byte aligned base (128-byte swizzle atoms are
// 8 rows of 128 bytes), in boxes of 64 columns (128 bytes a row): Q as
// DH / 64 boxes of kBQ rows; K and V as kStages stages of DH / 64 boxes of
// kBK rows; then the barriers: Q full, and per stage K full, V full, K
// empty, V empty; then a scratch word (see the note at the top).
template <int DH>
struct Tile {
  static constexpr int kConsumers = DH == 64 ? 3 : 2;
  static constexpr int kBQ = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = DH == 64 ? 32 : 40;
  static constexpr int kConsumerRegs = DH == 64 ? 160 : 232;
  static constexpr int kBoxes = DH / 64;
  static constexpr int kQBox = kBQ * 128;      // bytes
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBoxes * kQBox;
  static constexpr int kV = kK + kStages * kBoxes * kBox;
  static constexpr int kBar = kV + kStages * kBoxes * kBox;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 16 + 1024;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                65536, "register split");
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the 4-D map at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory at `dst`; completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (128B).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching registers that an in-flight wgmma owns:
// each use after this point depends on it, and it follows the wait.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void set_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void set_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t w) {
  return *reinterpret_cast<__nv_bfloat162*>(&w);
}

__device__ __forceinline__ uint32_t pa_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 of a pair as f32: the low half, the high half
__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// D (64 x 128, f32) = [D +] A (64 x 16, shared, K-major) * B (16 x 128,
// shared, K-major); `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16 bf16, registers) * B (16 x 64, shared,
// MN-major: the last immediate transposes B).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 128, f32) += A (64 x 16 bf16, registers) * B (16 x 128, shared,
// MN-major: the last immediate transposes B).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Accumulator layout of wgmma m64nN f32 (warp w of the warpgroup, g = lane /
// 4, t = lane % 4): d[4j + 2r + c] is row 16w + g + 8r, column 8j + 2t + c.
// Packed in bf16 pairs, pair q = 2j + r holds columns 8j + 2t, +1 of row r;
// pairs 4kk .. 4kk + 3 are, in that order, the A fragment (a0..a3) of k-step
// kk of P V, so P goes from S's registers to the A operand in the thread.
template <int DH>
__global__ void __launch_bounds__(Tile<DH>::kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Tile<DH>;
  constexpr int kBoxes = L::kBoxes, kConsumers = L::kConsumers;
  constexpr int kPairs = kBK / 4;          // bf16 pairs of S per thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // barriers, 8 bytes each (+ 8 * stage): Q full; K, V full; K, V empty
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_kf = bar_q + 8, bar_vf = bar_kf + 8 * kStages,
                 bar_ke = bar_vf + 8 * kStages, bar_ve = bar_ke + 8 * kStages;

  // the query blocks of one (batch, head) are neighbours in the launch
  // order, so the CTAs in flight share its K and V in L2; within a head
  // the block index runs backwards, heaviest causal block first
  const int n_qb = (p.T + L::kBQ - 1) / L::kBQ;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x) % n_qb;
  const int hb = static_cast<int>(blockIdx.x) / n_qb;
  const int h = hb % p.H, b = hb / p.H;
  const int q0 = qb * L::kBQ;
  int kbeg, kend;
  key_range(p, q0, min(q0 + L::kBQ, p.T) - 1, kBK, kbeg, kend);
  const int n_tiles = (kend - kbeg + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(bar_kf + 8 * s, 1);
      bar_init(bar_vf + 8 * s, 1);
      bar_init(bar_ke + 8 * s, kConsumers * 128);
      bar_init(bar_ve + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps both rings full. K of a tile is
    // released once its S is computed, V once its P V is.
    set_regs_dec<L::kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      bar_expect_tx(bar_q, kBoxes * L::kQBox);
      for (int x = 0; x < kBoxes; ++x)
        tma_load(base + L::kQ + x * L::kQBox, &qmap, bar_q, 64 * x, h, q0,
                 b);
      const int kvh = h / p.rep;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = kbeg + it * kBK;
        bar_wait(bar_ke + 8 * s, ph ^ 1);
        bar_expect_tx(bar_kf + 8 * s, kBoxes * kBox);
        for (int x = 0; x < kBoxes; ++x)
          tma_load(base + L::kK + (s * kBoxes + x) * kBox, &kmap,
                   bar_kf + 8 * s, 64 * x, kvh, k0, b);
        bar_wait(bar_ve + 8 * s, ph ^ 1);
        bar_expect_tx(bar_vf + 8 * s, kBoxes * kBox);
        for (int x = 0; x < kBoxes; ++x)
          tma_load(base + L::kV + (s * kBoxes + x) * kBox, &vmap,
                   bar_vf + 8 * s, 64 * x, kvh, k0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  set_regs_inc<L::kConsumerRegs>();
  const int tid = threadIdx.x % 128;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int qa = q0 + 64 * wg;                 // the warpgroup's first row
  const int row = qa + 16 * (tid >> 5) + g;    // this thread's rows: +0, +8
  // exp(x - m) = 2^((b - b_max) * scale * log2 e) for bf16 logits b
  const float sl = p.scale * kLog2e;

  // sc: S of the tile, then its p in f32; pp: P of the tile whose P V is
  // in flight, packed (the A operand)
  float o[DH / 2];
  float sc[kBK / 2];
  uint32_t pp[kPairs];
  // m: the running max of the bf16 logits b (before the scale, which is
  // positive, so the max of b * scale is m * scale exactly); l: this
  // thread's share of the row sum
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;

  // S = Q K^T of tile it, issued and committed (not waited for)
  auto issue_s = [&](int it) {
    const int s = it % kStages;
    bar_wait(bar_kf + 8 * s, (it / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t qd = base + L::kQ + (kk / 4) * L::kQBox +
                          wg * 64 * 128 + (kk % 4) * 32;
      const uint32_t kd = base + L::kK + (s * kBoxes + kk / 4) * kBox +
                          (kk % 4) * 32;
      wgmma_ss_n128(sc, descriptor(qd, 16, 1024), descriptor(kd, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile it, P in pp, issued and committed (not waited for)
  auto issue_pv = [&](int it) {
    const int s = it % kStages;
    bar_wait(bar_vf + 8 * s, (it / kStages) & 1);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // keys 16kk.. of the stage; the next 64 columns one box further on
      const uint32_t vd = base + L::kV + s * kBoxes * kBox + kk * 16 * 128;
      const uint32_t a[4] = {pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2],
                             pp[4 * kk + 3]};
      if constexpr (DH == 64)
        wgmma_rs_n64(o, a, descriptor(vd, kBox, 1024));
      else
        wgmma_rs_n128(o, a, descriptor(vd, kBox, 1024));
    }
    wgmma_commit();
  };
  // the softmax of tile it from its finished S, in sc: the reference's
  // logits (the product rounded to bf16; masked keys below every logit),
  // the new row maxima, the rescale factors alpha, the row sums, and
  // p = exp(logit - max) in f32, in place
  auto softmax = [&](int it, float (&alpha)[2]) {
    const int k0 = kbeg + it * kBK;
    const int qz = qa + 63, kz = k0 + kBK - 1;
    bool inside = kz < p.T;
    if (p.causal) inside = inside && kz <= qa;
    if (p.window > 0) inside = inside && k0 > qz - p.window;
    if (p.chunk > 0)
      inside = inside && k0 / p.chunk == kz / p.chunk &&
               qa / p.chunk == qz / p.chunk && k0 / p.chunk == qa / p.chunk;
    if (!inside) {
      int lo[2], hi[2];
      visible_keys(p, row, lo[0], hi[0]);
      visible_keys(p, row + 8, lo[1], hi[1]);
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int kp = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (kp < lo[r] || kp > hi[r]) sc[i] = kMasked;
      }
    }
    uint32_t hv[kPairs];               // the logits, bf16 pairs
#pragma unroll
    for (int q = 0; q < kPairs; ++q) hv[q] = pack_bf16(sc[2 * q], sc[2 * q + 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __nv_bfloat162 mx2 = as_bf162(hv[r]);
#pragma unroll
      for (int j = 1; j < kPairs / 2; ++j)
        mx2 = __hmax2(mx2, as_bf162(hv[2 * j + r]));
      float mx = fmaxf(m[r], fmaxf(lo_f32(pa_bits(mx2)),
                                   hi_f32(pa_bits(mx2))));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = ex2((m[r] - mx) * sl);
      // a row with no visible key yet keeps the sentinel max; its masked
      // keys then give p = 0 (the reference gives 1 there and multiplies it
      // by 0 at the row's first visible key: the same result)
      const float shift = mx == kNeg ? 0.f : -mx * sl;
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPairs / 2; ++j) {
        const uint32_t w = hv[2 * j + r];
        const float p0 = ex2(fmaf(lo_f32(w), sl, shift));
        const float p1 = ex2(fmaf(hi_f32(w), sl, shift));
        sum += p0 + p1;
        sc[4 * j + 2 * r] = p0;
        sc[4 * j + 2 * r + 1] = p1;
      }
      l[r] = l[r] * alpha[r] + sum;
    }
  };
  // once P V of the previous tile is done: O rescaled by alpha, and this
  // tile's p rounded to bf16 and packed into pp
  auto rescale_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
#pragma unroll
    for (int q = 0; q < kPairs; ++q) pp[q] = pack_bf16(sc[2 * q], sc[2 * q + 1]);
  };

  bar_wait(bar_q, 0);
  {
    // tile 0: no P V in flight yet
    float alpha[2];
    issue_s(0);
    wgmma_wait<0>();
    hold(sc);
    bar_arrive(bar_ke);
    softmax(0, alpha);
    rescale_pack(alpha);
  }
  for (int it = 1; it < n_tiles; ++it) {
    // S of tile it and P V of tile it - 1 in flight together; this tile's
    // softmax runs while P V does
    float alpha[2];
    issue_s(it);
    issue_pv(it - 1);
    wgmma_wait<1>();                   // S done, P V may still run
    hold(sc);
    bar_arrive(bar_ke + 8 * (it % kStages));
    softmax(it, alpha);
    hold(sc);
    hold(alpha);
    hold(m);
    hold(l);
    // the row sums need every p of the tile: storing them to the scratch
    // word before the wait keeps ptxas from moving the softmax below it
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(bar_ve + 8 * kStages),
                 "f"(l[0] + l[1])
                 : "memory");
    wgmma_wait<0>();
    hold(o);
    hold(pp);
    bar_arrive(bar_ve + 8 * ((it - 1) % kStages));
    rescale_pack(alpha);
  }
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  hold(o);

  // ---- epilogue: full row sums, out = acc / max(l, 1e-30), lse = the
  // scaled max + log(l)
  const size_t qstride = static_cast<size_t>(p.H) * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qp = row + 8 * r;
    if (qp >= p.T) continue;
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.o) +
                          (static_cast<size_t>(b) * p.T + qp) * qstride +
                          static_cast<size_t>(h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv_l,
                                o[4 * j + 2 * r + 1] * inv_l);
    if (t == 0)
      p.lse[(static_cast<size_t>(b) * p.H + h) * p.T + qp] =
          m[r] * p.scale + logf(l[r]);
  }
}

// cuTensorMapEncodeTiled, a driver-API call, fetched through the runtime so
// that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kNoEncoder = -1;   // errors of our own, beside CUDA's codes
constexpr int kBadMap = -2;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The map of a (B, T, heads, DH) bf16 tensor as the 4-D (DH, heads, T, B),
// boxes of (64, 1, rows, 1) with 128-byte swizzle; reads past T are zeros.
int tensor_map(CUtensorMap* map, const void* ptr, int dh, int heads, int T,
               int B, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * dh;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * T};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kBadMap;
}

template <int DH>
int launch(const Params& p, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  int rc = tensor_map(&qm, p.q, DH, p.H, p.T, p.B, Tile<DH>::kBQ);
  if (!rc) rc = tensor_map(&km, p.k, DH, p.KV, p.T, p.B, kBK);
  if (!rc) rc = tensor_map(&vm, p.v, DH, p.KV, p.T, p.B, kBK);
  if (rc) return rc;
  constexpr int smem = Tile<DH>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks =
      static_cast<long long>((p.T + Tile<DH>::kBQ - 1) / Tile<DH>::kBQ) *
      p.H * p.B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_wgmma<DH><<<static_cast<unsigned>(blocks), Tile<DH>::kThreads,
                        smem, st>>>(
      qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

}  // namespace

// dtype codes: 0 = f32, 1 = bf16. head_dim 64 or 128. window, chunk: 0 =
// none. q, k, v, out contiguous in the layouts above; lse (B, H, T) f32.
extern "C" int fa_forward(int dtype, int head_dim, const void* q,
                          const void* k, const void* v, void* out, void* lse,
                          int B, int T, int H, int KV, int causal, int window,
                          int chunk, float scale, void* stream) {
  if (dtype < 0 || dtype > 1 || (head_dim != 64 && head_dim != 128) ||
      KV < 1 || H % KV != 0 || window < 0 || chunk < 0 ||
      !repro_torch::aligned(q, 16) || !repro_torch::aligned(k, 16) ||
      !repro_torch::aligned(v, 16) || !repro_torch::aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  const Params p{q, k, v, out, static_cast<float*>(lse), B, T, H, KV, H / KV,
                 causal, window, chunk, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return head_dim == 64 ? hopper::launch<64>(p, st)
                          : hopper::launch<128>(p, st);
  return head_dim == 64 ? f32::launch<64>(p, st) : f32::launch<128>(p, st);
}

extern "C" const char* fa_error_string(int err) {
  if (err == hopper::kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (err == hopper::kBadMap)
    return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
