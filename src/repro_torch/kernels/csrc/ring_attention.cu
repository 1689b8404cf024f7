// Attention of a call's queries over each batch row's K/V ring: the serving
// engine's slot decode ticks, prefill chunks and speculative verify calls.
//
// It replaces no TPU kernel. The reference computes this with two XLA
// einsums (repro/models/layers.py, attention_decode_slots), and so does the
// port's plain version (kernels/ref.py, ring_attention_ref). On the card
// cuBLAS picks a product's kernel, and with it the order of its sums, by the
// call's shape, so one query's output rounded differently in a decode tick
// (one query a row), a verify call (k + 1) and a prefill chunk (hundreds):
// a speculative or a resumed stream could part from the plain one at a
// near-tie. Here a query's sums run over its valid positions in an order
// set by the query alone: its output has the same bits in any call,
// whatever the call's other queries.
//
// Layout: q and out (B, T, H, D), k and v (B, S, KV, D), contiguous, f32 or
// bf16 (H a multiple of KV, D <= 256); plan (2, B) int64 on the device, the
// positions pos[b] and the counts n[b] of the call's tokens. Row b's newest
// cached position is last = pos[b] + n[b] - 1 and ring slot s holds
// position last - ((last - s) mod S). Query t of row b sits at qp = pos[b]
// + t and reads the positions j with max(0, last - S + 1) <= j <= min(qp,
// last), j > qp - window (window > 0) and j / chunk == qp / chunk (chunk >
// 0): the plain version's mask. A query with no such position writes zeros
// (the plain version averages V there; no caller reads such a row).
//
// Arithmetic, the plain version's up to the order of its sums: a score is
// the f32 dot of q and k rounded to the input type, then divided by sqrt(D)
// in f32; p_j = exp(s_j - m) / l over the valid positions, rounded to the
// input type; out = sum_j p_j v_j in f32, rounded once. A block of 256
// threads takes up to 8 consecutive queries of one batch row and head, so
// a prefill chunk's queries share their K and V loads. Pass 1: thread i
// takes the positions j = i (mod 256) in order and keeps each query's
// running max and sum of exponentials over those in the query's range,
// merged across each warp by a butterfly (each merge symmetric, so every
// lane ends with the same pair) and then over the warps in order. Pass 2:
// for each 256 positions aligned to a multiple of 256, every thread
// computes each query's p_j for one position into shared memory (0 outside
// the query's range); then the threads, as G = 256 / D groups of one
// thread per dim, add p_j v_j[d] over the chunk's positions g, g + G, ...
// in order, and the groups' sums are added in group order at the end.
// Every split is set by absolute positions and the query's own range, and
// a zero p adds an exact zero, so a query's sums run the same way in a
// block of one query (a decode tick) or of eight (a prefill chunk).
//
// Bound: the bytes of the valid K and V rows (K read twice, from L2 after
// the first time) and of q and out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a block: kQ queries of one (b, h)
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 8;
constexpr int kMaxD = 256;      // <= kThreads: a thread per output dim
constexpr unsigned kFull = 0xffffffffu;

struct Geo {
  int B, T, H, KV, D, S, window, chunk;
  float sqrt_d;
};

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

}  // namespace

// dtype codes: 0 = f32, 1 = bf16. geo: B, T, H, KV, D, S, window, chunk
// (0 for none). plan: (2, B) int64 on the device, positions then counts.
extern "C" int ra_forward(int dtype, const void* q, const void* k,
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
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* p = static_cast<const int64_t*>(plan);
  return dtype == 0 ? launch<float>(q, k, v, out, p, g, st)
                    : launch<uint16_t>(q, k, v, out, p, g, st);
}

extern "C" const char* ra_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
