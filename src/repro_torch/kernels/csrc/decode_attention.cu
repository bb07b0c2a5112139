// Decode attention for Hopper (sm_90a): one new token per row against a
// contiguous per-slot KV cache, each row at its own position.
//
// Replaces the Pallas kernel of the JAX package's
// src/repro/kernels/decode_attention.py (decode_attention, _decode_kernel)
// -> launch_decode_attention.  It computes what that kernel computes, on
// the layout the port's model code holds:
//
//   q        [B, H, hd]       bf16 or f32, any (batch, head) strides
//   k/v      [B, KV, S, hd]   q's dtype, a layer view of the engine's cache
//   cur_pos  [B]              int32 on the device: row b attends keys
//                             max(0, cur_pos - window + 1) .. cur_pos
//   out      [B, H, hd]       q's dtype, contiguous
//
// The TPU kernel takes one scalar position for every row (scalar
// prefetch) and K/V repeated to H heads; here each row reads its own
// position from device memory (no host sync), and q head h reads kv head
// h / (H / KV) in place.  Scores are (q . k) / sqrt(hd), the softmax is
// online in f32 and P.V accumulates in f32.
//
// The TPU kernel sweeps all S keys and masks; a masked key adds exactly 0
// once one key is kept, so this kernel visits only the kept range: at a
// chunked-prefill position of 199 in a 1024-slot cache that is a fifth of
// the cache.  A row with no kept key (cur_pos < 0) returns the mean of V
// over all S keys, as the finite NEG_INF gives in the Pallas kernel.
//
// Design (flash-decoding): the key axis [0, S) is cut into n_splits
// splits of split_len keys, a plan the wrapper makes on the host from B,
// S and the number of head groups alone (never from cur_pos, which stays
// on the device): enough splits for about two CTAs an SM, none shorter
// than 64 keys.  decode_kernel runs one CTA of 8 warps per (batch row,
// group of GT q-heads of one kv head, split), GT = 4, 2 or 1, the largest
// that divides H / KV (the wrapper's choice, with the plan); the GT heads
// share every K and V load.  Each CTA sweeps the kept keys inside its
// split.  The head dimension is cut into chunks of 8; L = next_pow2(hd /
// 8) lanes hold one chunk each, so a warp works on R = 32 / L keys at
// once, 4 of them per lane group with all their K and V loads issued
// before the arithmetic; warp w takes steps w, w + 8, ... of the range.
// Each lane group keeps (m, l, acc[8]) per head; groups merge through
// warp shuffles, warps through shared memory.
// With one split the CTA writes the normalised output; with more, each
// writes its (m, l, acc[GT][hd]) in f32 to the wrapper's workspace (a
// split with no kept key writes m = -inf, l = 0 and stops), and
// merge_kernel, in the same launch function, combines each row's splits
// in split order: the result does not depend on timing.  Registers,
// none spilled (ptxas -v, flags as flash_attention.cu's note):
// decode_kernel 107 / 127 / 167 in bf16 at GT 1 / 2 / 4 (100 / 126 /
// 166 in f32), merge_kernel 32.
//
// Bound: decode attention moves bytes.  The least time is the K and V
// bytes of the kept keys of each (row, kv head), read once, plus q and
// out, over HBM bandwidth (3.35 TB/s).  The splits put B (H / GT)
// n_splits CTAs on the card where the unsplit kernel had B (H / GT) (8
// at gemma3's global layers: B 8, one kv head), so a row's kept keys are
// read by many SMs at once.  At every serving shape the bound is under a
// microsecond, and launch latency (one or two kernels) sets the floor.

#include <math_constants.h>

#include "common.cuh"

namespace {

using repro_torch::kNegInf;
using repro_torch::load8;
using repro_torch::Strides;

constexpr int kVec = 8;     // elements per lane chunk
constexpr int kUnroll = 4;  // keys per lane group in flight
constexpr int kWarps = 8;
constexpr int kMaxHd = 256;
constexpr int kMergeThreads = 128;

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

template <typename T, int GT>
__global__ void __launch_bounds__(32 * kWarps)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ cur_pos,
              T* __restrict__ out, float* __restrict__ ws, int H, int KV,
              int S, int hd, long long q_sb, long long q_sh, Strides ks,
              Strides vs, int window, int split_len, float scale) {
  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][kMaxHd];

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * GT;
  const int kvh = h0 / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = hd / kVec;
  int L = 1;
  while (L < chunks) L <<= 1;
  const int R = 32 / L;
  const int c = lane & (L - 1);  // this lane's chunk of the head dim
  const int g = lane / L;        // this lane's key group
  const bool has = c < chunks;

  float qv[GT][kVec];
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    if (has) {
      load8(q + b * q_sb + (h0 + i) * q_sh + c * kVec, qv[i]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) qv[i][e] = 0.f;
    }
  }

  const int cur = cur_pos[b];
  int lo = window > 0 ? max(0, cur - window + 1) : 0;
  int hi = min(cur, S - 1);
  const bool uniform = lo > hi;  // no kept key: every key scores the same
  if (uniform) {
    lo = 0;
    hi = S - 1;
  }
  // this CTA's split of the key axis
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  lo = max(lo, split * split_len);
  hi = min(hi, split * split_len + split_len - 1);
  // workspace row of (batch row, head h0 + i, split): acc[hd] at
  // ws + row hd, then (m, l) at ws_ml + 2 row
  auto ws_row = [&](int i) {
    return (static_cast<long long>(b) * H + h0 + i) * n_splits + split;
  };
  float* ws_ml = ws + static_cast<long long>(gridDim.x) * H * n_splits * hd;
  if (lo > hi) {  // no kept key in this split: weight 0 in the merge
    if (threadIdx.x < GT) {
      const long long r = ws_row(threadIdx.x);
      ws_ml[2 * r] = -CUDART_INF_F;
      ws_ml[2 * r + 1] = 0.f;
    }
    return;
  }

  float m[GT], l[GT], acc[GT][kVec];
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
  }

  const T* kb = k + b * ks.b + kvh * ks.h + c * kVec;
  const T* vb = v + b * vs.b + kvh * vs.h + c * kVec;
  const int step = R * kUnroll;
  for (int t0 = lo + warp * step; t0 <= hi; t0 += kWarps * step) {
    // issue every K and V load of this step before any arithmetic
    float kx[kUnroll][kVec];
    float vx[kUnroll][kVec];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * R + g;
      in[u] = t <= hi;
      if (has && in[u]) {
        load8(kb + t * ks.s, kx[u]);
        load8(vb + t * vs.s, vx[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kx[u][e] = vx[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < GT; ++i) {
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(qv[i][e], kx[u][e], part);
        for (int off = L >> 1; off > 0; off >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, off);
        }
        s[u] = uniform ? 0.f : part * scale;
      }
      float m_new = m[i];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (in[u]) m_new = fmaxf(m_new, s[u]);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!in[u]) continue;
        const float p = expf(s[u] - m_new);
        l[i] += p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] = fmaf(p, vx[u][e], acc[i][e]);
      }
      m[i] = m_new;
    }
  }

  // merge the R key groups of this warp (all groups end up equal)
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < GT; ++i) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float m_new = fmaxf(m[i], m_o);
      const float a = expf(m[i] - m_new);
      const float a_o = expf(m_o - m_new);
      l[i] = l[i] * a + l_o * a_o;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[i][e], off);
        acc[i][e] = acc[i][e] * a + acc_o * a_o;
      }
      m[i] = m_new;
    }
  }
  // merge the warps through shared memory; warp i writes head h0 + i
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    if (lane == 0) {
      sm_m[warp][i] = m[i];
      sm_l[warp][i] = l[i];
    }
    if (g == 0 && has) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) sm_acc[warp][i][c * kVec + e] = acc[i][e];
    }
  }
  __syncthreads();
  if (warp >= GT || g != 0 || !has) return;
  const int i = warp;
  float m_all = sm_m[0][i];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w][i]);
  float l_all = 0.f;
  float o[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) o[e] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float a = expf(sm_m[w][i] - m_all);
    l_all += sm_l[w][i] * a;
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] += sm_acc[w][i][c * kVec + e] * a;
  }
  if (n_splits > 1) {  // this split's part, merged by merge_kernel
    const long long r = ws_row(i);
    if (c == 0) {
      ws_ml[2 * r] = m_all;
      ws_ml[2 * r + 1] = l_all;
    }
    store8(ws + r * hd + c * kVec, o);
    return;
  }
  const float inv = 1.f / (l_all == 0.f ? 1.f : l_all);
#pragma unroll
  for (int e = 0; e < kVec; ++e) o[e] *= inv;
  store8(out + (static_cast<long long>(b) * H + h0 + i) * hd + c * kVec, o);
}

// One thread per (batch row, head, chunk of 8 columns): the splits'
// (m, l, acc) in split order, over the splits that kept a key.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ ws, T* __restrict__ out, int B,
             int H, int hd, int n_splits) {
  const int chunks = hd / kVec;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (idx >= static_cast<long long>(B) * H * chunks) return;
  const long long row = idx / chunks;  // b * H + h
  const int c = static_cast<int>(idx % chunks);
  const float* acc = ws + row * n_splits * hd + c * kVec;
  const float* ml =
      ws + static_cast<long long>(B) * H * n_splits * hd + 2 * row * n_splits;
  float m_all = -CUDART_INF_F;
  for (int sp = 0; sp < n_splits; ++sp) {
    if (ml[2 * sp + 1] > 0.f) m_all = fmaxf(m_all, ml[2 * sp]);
  }
  float l_all = 0.f;
  float o[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) o[e] = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) {
    const float l_s = ml[2 * sp + 1];
    if (l_s == 0.f) continue;  // an empty split wrote no acc
    const float a = expf(ml[2 * sp] - m_all);
    l_all += l_s * a;
    float x[kVec];
    load8(acc + sp * hd, x);
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = fmaf(x[e], a, o[e]);
  }
  const float inv = 1.f / (l_all == 0.f ? 1.f : l_all);
#pragma unroll
  for (int e = 0; e < kVec; ++e) o[e] *= inv;
  store8(out + row * hd + c * kVec, o);
}

template <typename T, int GT>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, float* ws, int B, int H, int KV, int S, int hd,
           long long q_sb, long long q_sh, Strides ks, Strides vs,
           int window, int n_splits, int split_len, float scale,
           cudaStream_t stream) {
  const dim3 grid(B, H / GT, n_splits);
  decode_kernel<T, GT><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), ws, H, KV, S, hd,
      q_sb, q_sh, ks, vs, window, split_len, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const long long threads = static_cast<long long>(B) * H * (hd / kVec);
  merge_kernel<T><<<(threads + kMergeThreads - 1) / kMergeThreads,
                    kMergeThreads, 0, stream>>>(ws, static_cast<T*>(out), B,
                                                H, hd, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_groups(const void* q, const void* k, const void* v,
                  const int* pos, void* out, float* ws, int B, int H, int KV,
                  int S, int hd, long long q_sb, long long q_sh, Strides ks,
                  Strides vs, int window, int group_heads, int n_splits,
                  int split_len, float scale, cudaStream_t stream) {
#define REPRO_DECODE(GT)                                                    \
  return launch<T, GT>(q, k, v, pos, out, ws, B, H, KV, S, hd, q_sb, q_sh, \
                       ks, vs, window, n_splits, split_len, scale, stream)
  if (group_heads == 4) REPRO_DECODE(4);
  if (group_heads == 2) REPRO_DECODE(2);
  REPRO_DECODE(1);
#undef REPRO_DECODE
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Strides are in elements; the
// head dimension is contiguous.  window 0 disables the sliding window.
// A CTA serves group_heads (1, 2 or 4, dividing H / KV) q-heads of one kv
// head.  The key axis is cut into n_splits splits of split_len keys
// (n_splits * split_len >= S > (n_splits - 1) * split_len); with more
// than one, workspace holds B * H * n_splits * (hd + 2) floats.  Returns
// cudaGetLastError() after the launches.
extern "C" int launch_decode_attention(
    const void* q, const void* k, const void* v, const int* cur_pos,
    void* out, void* workspace, int B, int H, int KV, int S, int hd,
    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    int window, int group_heads, int n_splits, int split_len, float scale,
    int dtype, void* stream) {
  if (hd % kVec != 0 || hd < kVec || hd > kMaxHd || KV < 1 || H % KV != 0 ||
      S < 1 || B < 1 || n_splits < 1 || n_splits > 65535 || split_len < 1 ||
      static_cast<long long>(n_splits) * split_len < S ||
      static_cast<long long>(n_splits - 1) * split_len >= S ||
      (n_splits > 1 && workspace == nullptr) ||
      (group_heads != 1 && group_heads != 2 && group_heads != 4) ||
      (H / KV) % group_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss};
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_groups<float>(q, k, v, cur_pos, out, ws, B, H, KV, S, hd,
                                q_sb, q_sh, ks, vs, window, group_heads,
                                n_splits, split_len, scale, s);
  }
  if (dtype == 1) {
    return launch_groups<__nv_bfloat16>(q, k, v, cur_pos, out, ws, B, H, KV,
                                        S, hd, q_sb, q_sh, ks, vs, window,
                                        group_heads, n_splits, split_len,
                                        scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
