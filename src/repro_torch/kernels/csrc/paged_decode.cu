// Paged decode attention for Hopper (sm_90a): one query row per folded
// (request, q-head) row attends over the pool pages its page table names.
//
// Replaces the two Pallas kernels of the JAX package's
// src/repro/kernels/paged_decode.py:
//   * paged_decode_attention       (_paged_kernel)       -> launch_paged_decode
//   * paged_decode_attention_int8  (_paged_kernel_int8)  -> launch_paged_decode_int8
//
// Layout (the same as the TPU kernels'):
//   q           [BH, hd]          bf16 or f32
//   k/v pool    [n_rows, P, hd]   bf16 or f32; int8 codes for the int8 kernel
//   k/v scales  [n_rows]          f32 per-page dequant scales (int8 only)
//   page_table  [BH, W]           int32 pool row of each logical page
//   seq_lens    [BH]              int32 tokens to attend
//   out         [BH, hd]          q's dtype
//
// Semantics: scores are (q . k) / sqrt(hd); tokens >= seq_len score
// NEG_INF = -1e30 (finite, as in the reference), and the softmax is taken
// online in f32 with P.V accumulated in f32.  A page past
// ceil(seq_len / P) contributes exactly 0 once a real score is seen, so
// the sweep stops there.  A row with seq_len == 0 (the engine's pad rows)
// sweeps all W pages: every score is NEG_INF, so it returns the mean of V
// over the table, as the reference does, and never NaN.  Page ids are
// clamped into [0, n_rows), as the JAX gather clamps.
//
// Design (simple first): one CTA of 8 warps per row; warp w sweeps the
// row's pages w, w + 8, ...  The head dimension is cut into chunks of 8
// elements; L = next_pow2(hd / 8) lanes hold one chunk each (q in
// registers, one 16-byte load per K/V chunk for bf16, two for f32, one
// 8-byte load for int8 codes), so a warp works on R = 32 / L tokens at
// once, U = 4 of them per lane group with all their K and V loads issued
// before the arithmetic.  Each lane group keeps its own online-softmax
// state (m, l, acc[8]); the R groups merge through warp shuffles and the
// 8 warps through shared memory at the end.  (The first version, one warp
// per row, was latency-bound: the longest row's serial sweep set the time.)
//
// Bound: decode attention moves bytes, not operations.  The least time is
// the K and V bytes of the pages actually read (ceil(seq_len / P) pages per
// row, each read once) over HBM bandwidth (3.35 TB/s on the H100 SXM).
// Rows of one request that share a kv head read the same pages; the second
// read comes from L2.  Later work, not done here: wgmma over the G q-heads
// of one kv head, TMA page loads into shared memory, and splitting the page
// sweep across CTAs when BH is small.

#include "common.cuh"

namespace {

using repro_torch::kNegInf;
using repro_torch::load8;

constexpr int kVec = 8;  // elements per lane chunk
constexpr int kUnroll = 4;  // tokens per lane group in flight
constexpr int kWarps = 8;   // warps per row, each sweeping every 8th page
constexpr int kMaxHd = 256;

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[kVec]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < kVec; ++i) x[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(32 * kWarps)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ table,
                    const int* __restrict__ lens, TQ* __restrict__ out,
                    int bh, int w, int page, int hd, int n_rows,
                    float scale) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxHd];

  const int b = blockIdx.x;
  if (b >= bh) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = hd / kVec;
  int L = 1;
  while (L < chunks) L <<= 1;
  const int R = 32 / L;
  const int c = lane & (L - 1);  // this lane's chunk of the head dim
  const int g = lane / L;        // this lane's token group
  const bool has = c < chunks;

  float qv[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) qv[e] = 0.f;
  if (has) {
    const TQ* qrow = q + static_cast<size_t>(b) * hd + c * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if constexpr (sizeof(TQ) == 4) {
        qv[e] = static_cast<float>(qrow[e]);
      } else {
        qv[e] = __bfloat162float(qrow[e]);
      }
    }
  }

  const int seq = lens[b];
  const int n_pages = seq > 0 ? min((seq + page - 1) / page, w) : w;
  const int* trow = table + static_cast<size_t>(b) * w;

  float m = kNegInf, l = 0.f;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  // warp `warp` sweeps pages warp, warp + kWarps, ...
  for (int pi = warp; pi < n_pages; pi += kWarps) {
    const int pid = min(max(trow[pi], 0), n_rows - 1);
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = k_scales[pid];
      vsc = v_scales[pid];
    }
    const size_t base = static_cast<size_t>(pid) * page * hd + c * kVec;
    for (int t0 = 0; t0 < page; t0 += R * kUnroll) {
      // issue every K and V load of this step before any arithmetic
      float kx[kUnroll][kVec];
      float vx[kUnroll][kVec];
      bool in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * R + g;
        in[u] = t < page;
        if (has && in[u]) {
          load8(kp + base + static_cast<size_t>(t) * hd, kx[u]);
          load8(vp + base + static_cast<size_t>(t) * hd, vx[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kx[u][e] = vx[u][e] = 0.f;
        }
      }
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part += qv[e] * kx[u][e];
        for (int off = L >> 1; off > 0; off >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, off);
        }
        const int tok = pi * page + t0 + u * R + g;
        s[u] = tok < seq ? part * ksc * scale : kNegInf;
      }
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (in[u]) m_new = fmaxf(m_new, s[u]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!in[u]) continue;
        const float p = expf(s[u] - m_new);
        l += p;
        const float pv = p * vsc;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] += pv * vx[u][e];
      }
      m = m_new;
    }
  }

  // merge the R token groups of this warp (all groups end up equal)
  for (int off = L; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    const float a = expf(m - m_new);
    const float a_o = expf(m_o - m_new);
    l = l * a + l_o * a_o;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[e], off);
      acc[e] = acc[e] * a + acc_o * a_o;
    }
    m = m_new;
  }
  // merge the kWarps warps through shared memory; warp 0 writes the row
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (g == 0 && has) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) sm_acc[warp][c * kVec + e] = acc[e];
  }
  __syncthreads();
  if (warp != 0 || g != 0 || !has) return;
  float m_all = sm_m[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m_all = fmaxf(m_all, sm_m[i]);
  float l_all = 0.f;
  float o[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) o[e] = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const float a = expf(sm_m[i] - m_all);
    l_all += sm_l[i] * a;
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] += sm_acc[i][c * kVec + e] * a;
  }
  const float safe = l_all == 0.f ? 1.f : l_all;
  TQ* orow = out + static_cast<size_t>(b) * hd + c * kVec;
#pragma unroll
  for (int e = 0; e < kVec; ++e) store1(orow + e, o[e] / safe);
}

template <typename TQ, typename TKV, bool kQuant>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* table, const int* lens, void* out,
           int bh, int w, int page, int hd, int n_rows, float scale,
           cudaStream_t stream) {
  paged_decode_kernel<TQ, TKV, kQuant><<<bh, 32 * kWarps, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, table, lens,
      static_cast<TQ*>(out), bh, w, page, hd, n_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int launch_paged_decode(const void* q, const void* k_pool,
                                   const void* v_pool, const int* table,
                                   const int* lens, void* out, int bh, int w,
                                   int page, int hd, int n_rows, float scale,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, float, false>(q, k_pool, v_pool, nullptr, nullptr,
                                       table, lens, out, bh, w, page, hd,
                                       n_rows, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, v_pool, nullptr, nullptr, table, lens, out, bh, w, page,
        hd, n_rows, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 code pools with per-page f32 scales; q_dtype as above.
extern "C" int launch_paged_decode_int8(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const float* k_scales,
                                        const float* v_scales,
                                        const int* table, const int* lens,
                                        void* out, int bh, int w, int page,
                                        int hd, int n_rows, float scale,
                                        int q_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) {
    return launch<float, int8_t, true>(q, k_pool, v_pool, k_scales, v_scales,
                                       table, lens, out, bh, w, page, hd,
                                       n_rows, scale, s);
  }
  if (q_dtype == 1) {
    return launch<__nv_bfloat16, int8_t, true>(
        q, k_pool, v_pool, k_scales, v_scales, table, lens, out, bh, w, page,
        hd, n_rows, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
