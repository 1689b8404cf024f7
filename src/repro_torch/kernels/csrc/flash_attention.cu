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
// k > q - window; chunk k / chunk == q / chunk; keys past T), the finite
// sentinel -1e30 for masked logits (a tile masked for every key of a row
// gives p = 1 there, and the first tile with a real logit scales that to 0,
// so no NaN), running max m, denominator l and accumulator in f32, out =
// acc / max(l, 1e-30). It also writes lse = m + log(l) per row, f32 (B, H, T),
// which the backward needs. In bf16 the logit tile is rounded to bf16 before
// the f32 scale, and P to bf16 before the PV product, as the reference rounds;
// the PV products accumulate in f32 across key tiles (the reference rounds
// each 512-key tile's product to bf16; the tiles differ, so the two agree
// within a tolerance, not bitwise). Tiles that the mask leaves empty for
// every row of the block are skipped (causal: keys past the block's last
// query; window and chunk: keys before or after their range); a real row
// always sees itself, so skipping changes no result.
//
// Bound: operations. At the training path's shape, (4, 4096, 36, 64) causal,
// the products take 4 * B * H * dh * T (T + 1) / 2 = 3.1e11 FLOP (0.31 ms at
// the bf16 tensor-core peak) against 302 MB of q, k, v and out (0.09 ms at
// the HBM rate). Design (FlashAttention-2's, simple form): one CTA of four
// warps per (64-query block, head, batch); each warp owns 16 query rows, its
// Q fragments in registers; 64-key K and V tiles staged in padded shared
// memory (no bank conflicts on the fragment loads); S = Q K^T and O += P V on
// the tensor cores with mma.sync m16n8k16 bf16 -> f32, P reused from the S
// accumulators' registers as the A operand. No cp.async pipelining, no
// wgmma or TMA yet. f32 inputs (the tests' precision check) take the same
// structure with the products done in scalar f32 FMAs from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per CTA, 16 per warp
constexpr int kBK = 64;        // keys per tile
constexpr int kWarps = 4;
constexpr float kNeg = -1e30f;

template <typename T>
__host__ __device__ constexpr int pad() {
  return std::is_same<T, float>::value ? 4 : 8;
}

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

template <typename T, int DH>
constexpr size_t smem_bytes() {
  return 3u * kBQ * (DH + pad<T>()) * sizeof(T) +
         (std::is_same<T, float>::value ? kBQ * (kBK + 4) * sizeof(float) : 0);
}

// 64 rows of DH values from global memory (row stride `stride` elements)
// into shared memory (row stride DH + pad), rows at or past `valid` zeroed.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* s, const T* g, int valid,
                                          size_t stride) {
  constexpr int LD = DH + pad<T>();
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = DH / VEC;
  for (int i = threadIdx.x; i < kBQ * PER_ROW; i += kWarps * 32) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(g + r * stride + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout (mma.sync m16n8k16, g = lane / 4, t = lane % 4): a thread
// holds accumulator elements (row g, cols 2t, 2t+1) in [0], [1] and (row
// g + 8, the same cols) in [2], [3] of each 8-column tile.
template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const Params p) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LD = DH + pad<T>();
  constexpr int NT = kBK / 8;        // 8-key tiles of S
  constexpr int DT = DH / 8;         // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBQ * LD;
  T* Vs = Ks + kBK * LD;
  float* Ps = reinterpret_cast<float*>(Vs + kBK * LD);   // f32 path only

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int T_ = p.T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;                 // local rows r0, r0 + 8
  const size_t qstride = static_cast<size_t>(p.H) * DH;
  const size_t kstride = static_cast<size_t>(p.KV) * DH;
  const T* qg = static_cast<const T*>(p.q) +
                (static_cast<size_t>(b) * T_ + q0) * qstride +
                static_cast<size_t>(h) * DH;
  const size_t kv_off = static_cast<size_t>(b) * T_ * kstride +
                        static_cast<size_t>(h / p.rep) * DH;
  const T* kg = static_cast<const T*>(p.k) + kv_off;
  const T* vg = static_cast<const T*>(p.v) + kv_off;

  load_tile<T, DH>(Qs, qg, min(kBQ, T_ - q0), qstride);

  // the keys any row of this block can see, rounded out to whole tiles
  const int q_last = min(q0 + kBQ, T_) - 1;
  int kbeg = 0, kend = T_;
  if (p.causal) kend = min(kend, q_last + 1);
  if (p.window > 0) kbeg = max(kbeg, q0 - p.window + 1);
  if (p.chunk > 0) {
    kbeg = max(kbeg, (q0 / p.chunk) * p.chunk);
    kend = min(kend, (q_last / p.chunk + 1) * p.chunk);
  }
  kbeg = (kbeg / kBK) * kBK;
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;

  __syncthreads();
  uint32_t qf[DH / 16][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const T* base = Qs + r0 * LD + kk * 16 + 2 * t;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
    }
  }

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();                   // every warp is done with the last tile
    const int valid = min(kBK, T_ - k0);
    load_tile<T, DH>(Ks, kg + static_cast<size_t>(k0) * kstride, valid,
                     kstride);
    load_tile<T, DH>(Vs, vg + static_cast<size_t>(k0) * kstride, valid,
                     kstride);
    __syncthreads();

    // ---- S = Q K^T, scaled, masked
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (kBf16) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const T* kb = Ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
          mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                   *reinterpret_cast<const uint32_t*>(kb + 8));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)     // the reference's bf16 logits
          s[nt][i] = __bfloat162float(__float2bfloat16_rn(s[nt][i])) *
                     p.scale;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* qr = reinterpret_cast<const float*>(Qs) +
                            (r0 + (i >> 1) * 8) * LD;
          const float* kr = reinterpret_cast<const float*>(Ks) +
                            (nt * 8 + 2 * t + (i & 1)) * LD;
          float acc = 0.f;
          for (int d = 0; d < DH; ++d) acc = fmaf(qr[d], kr[d], acc);
          s[nt][i] = acc * p.scale;
        }
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
    if constexpr (kBf16) {
      const uint16_t* vs = reinterpret_cast<const uint16_t*>(Vs);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint16_t* v0 = vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const uint16_t* vc = v0 + d * 8;
          mma_bf16(o[d], a, pack_raw(vc[0], vc[LD]),
                   pack_raw(vc[8 * LD], vc[9 * LD]));
        }
      }
    } else {
      float* pw = Ps + warp * 16 * (kBK + 4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pw[(g + (i >> 1) * 8) * (kBK + 4) + nt * 8 + 2 * t + (i & 1)] =
              s[nt][i];
      __syncwarp();
      const float* vs = reinterpret_cast<const float*>(Vs);
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* pr = pw + (g + (i >> 1) * 8) * (kBK + 4);
          const int col = d * 8 + 2 * t + (i & 1);
          float acc = 0.f;
          for (int j = 0; j < kBK; ++j) acc = fmaf(pr[j], vs[j * LD + col], acc);
          o[d][i] += acc;
        }
      __syncwarp();
    }
  }

  // ---- epilogue: full row sums, out = acc / max(l, 1e-30), lse
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int qp = qpos[rr];
    if (qp >= T_) continue;
    const float inv_l = 1.f / fmaxf(l[rr], 1e-30f);
    T* orow = static_cast<T*>(p.o) + (static_cast<size_t>(b) * T_ + qp) *
                                         qstride + static_cast<size_t>(h) * DH;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const float x0 = o[d][2 * rr] * inv_l, x1 = o[d][2 * rr + 1] * inv_l;
      if constexpr (kBf16) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(orow + d * 8 + 2 * t) = make_float2(x0, x1);
      }
    }
    if (t == 0)
      p.lse[(static_cast<size_t>(b) * p.H + h) * T_ + qp] =
          m[rr] + logf(l[rr]);
  }
}

template <typename T, int DH>
int launch(const Params& p, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, DH>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.T + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<T, DH><<<grid, kWarps * 32, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

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
    return head_dim == 64 ? launch<__nv_bfloat16, 64>(p, st)
                          : launch<__nv_bfloat16, 128>(p, st);
  return head_dim == 64 ? launch<float, 64>(p, st) : launch<float, 128>(p, st);
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
