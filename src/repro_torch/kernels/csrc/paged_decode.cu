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
// Design: one CTA of 4 warps per (group of GT q-rows that share one kv
// head, split of the page sweep).  The wrapper folds q-heads per request
// so that the G = H / KV rows of one kv head are adjacent and carry equal
// table and length rows; GT is the largest of 4, 3, 2, 1 that divides G,
// and the CTA reads the table and length of its group's first row.
//   - The pages of a row are cut into n_splits splits of split_pages
//     pages, a plan the wrapper makes from (BH, W, GT, the card's SM
//     count) alone: enough splits for several CTAs an SM, none shorter
//     than 4 pages, none longer than kMaxSplitPages.  The lengths stay on
//     the device.  A CTA sweeps its split's pages below ceil(seq_len / P)
//     (all of them for a pad row); a split wholly past a live row's
//     length sweeps nothing and contributes l = 0.
//   - The split's page ids (clamped) go to shared memory first.  K and V
//     then stream through a cp.async ring in shared memory, a stage being
//     up to 16 tokens of one page (a 16-token page at hd 128 in bf16 is 4
//     KB of K and 4 KB of V), each loaded once for the GT rows; for int8
//     the page's two scales ride along (4-byte copies).  The ring is 8
//     stages deep for bf16 and int8 pools (a whole split of 8 pages in
//     flight at once) and 4 for f32.
//   - The head dimension is cut into chunks of 8; L = next_pow2(hd / 8)
//     lanes hold one chunk each (q of the GT rows in registers), so a
//     warp scores R = 32 / L tokens of a stage at once, in f32 on the CUDA
//     cores (at GT <= 4 an mma tile would be mostly padding), and only
//     the token slots a stage fills: one of four at hd 64, two at hd 128
//     (scoring the empty ones too left granite-moe's shape slower than
//     one CTA a row).  Each lane group keeps (m, l, acc[8]) per row;
//     groups merge through warp shuffles, warps through shared memory.
//   - With one split the CTA writes the normalised rows.  With more, each
//     writes its f32 (m, l, acc[hd]) per row to the wrapper's workspace
//     and arrives at its group's counter (an integer atomic); the last
//     to arrive merges the splits in split order, writes the rows and sets
//     the counter back to 0.  One launch a call, and the result does not
//     depend on which CTA arrives last.  A split that swept nothing wrote
//     (-1e30, 0, 0), which adds nothing at any weight, so the merge loads
//     every split's part unconditionally and all at once.
//   - Registers, none spilled (ptxas -v, flags of _build.py): 113 / 138 /
//     162 / 181 at GT 1 / 2 / 3 / 4 for bf16, 114 / 140 / 162 / 182 for
//     int8 codes with a bf16 q, 111 / 137 / 156 / 179 for f32.
//
// Bound: decode attention moves bytes, not operations.  The least time is
// the K and V bytes of the pages the rows need (ceil(seq_len / P) pages
// per (request, kv head), all W for a pad row), each read once, plus q,
// out and the table entries, over HBM bandwidth (3.35 TB/s on the H100
// SXM): 0.006 ms at 8 requests x 16 heads (8 KV heads), hd 128, 64-page
// tables, 0.0028 ms at granite-moe's 24 heads over 8, hd 64.  A group's
// CTA reads each page once for its G rows; at every serving shape the
// bound is a few microseconds, and latency (the DRAM round trips of a
// split's sweep, the launch) sets the time.

#include "common.cuh"

namespace {

using repro_torch::kNegInf;
using repro_torch::load8;

constexpr int kVec = 8;          // elements per lane chunk
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTok = 16;         // tokens a ring stage holds
constexpr int kUnroll = 4;       // tokens of a stage per lane group, at most
constexpr int kMaxHd = 256;
constexpr int kMaxSplitPages = 64;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[kVec]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < kVec; ++i) x[i] = static_cast<float>(c[i]);
}

// 8 f32 written by another CTA: read through L2
__device__ __forceinline__ void load8_cg(const float* p, float (&x)[kVec]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 c = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// N-byte global->shared copy (16: through L2 only; 4 and 8: .ca)
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(gmem), "n"(N));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ring stages: 8 for 1- and 2-byte pools (a whole split of 8 pages of 16
// tokens in flight at once), 4 for f32
template <typename TKV>
__host__ __device__ constexpr int stages() {
  return sizeof(TKV) == 4 ? 4 : 8;
}

template <typename TKV>
constexpr size_t ring_bytes() {  // the ring at the largest hd
  return static_cast<size_t>(stages<TKV>()) * 2 * kTok * kMaxHd *
         sizeof(TKV);
}

template <typename TQ, typename TKV, bool kQuant, int GT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ table,
                    const int* __restrict__ lens, TQ* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int w, int page, int hd, int n_rows, int split_pages,
                    float scale) {
  constexpr int kStages = stages<TKV>();
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int sm_pid[kMaxSplitPages];
  __shared__ float sm_scale[kStages][2];
  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][kMaxHd];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = blockIdx.x;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int row0 = grp * GT;
  const int chunks = hd / kVec;
  int L = 1;
  while (L < chunks) L <<= 1;
  const int R = 32 / L;
  const int c = lane & (L - 1);  // this lane's chunk of the head dim
  const int g = lane / L;        // this lane's token group
  const bool has = c < chunks;

  float qv[GT][kVec];
#pragma unroll
  for (int i = 0; i < GT; ++i) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) qv[i][e] = 0.f;
    if (has) {
      const TQ* qrow = q + static_cast<size_t>(row0 + i) * hd + c * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if constexpr (sizeof(TQ) == 4) {
          qv[i][e] = static_cast<float>(qrow[e]);
        } else {
          qv[i][e] = __bfloat162float(qrow[e]);
        }
      }
    }
  }

  // this split's pages below the row's need: [p_lo, p_hi)
  const int seq = lens[row0];
  const int n_pages = seq > 0 ? min((seq + page - 1) / page, w) : w;
  const int p_lo = split * split_pages;
  const int p_hi = min(n_pages, p_lo + split_pages);
  const int* trow = table + static_cast<size_t>(row0) * w;
  for (int i = tid; i < p_hi - p_lo; i += kThreads) {
    sm_pid[i] = min(max(trow[p_lo + i], 0), n_rows - 1);
  }
  __syncthreads();

  // ring stage j: tokens blk * kTok .. of page p_lo + j / blocks
  const int blocks = (page + kTok - 1) / kTok;
  const int n_stage = max(0, p_hi - p_lo) * blocks;
  const int tok_bytes = hd * static_cast<int>(sizeof(TKV));
  const int half = kTok * tok_bytes;  // K, then V, in a slot
  auto issue = [&](int slot, int j) {
    const int pid = sm_pid[j / blocks];
    const int t0 = (j % blocks) * kTok;
    const int n_bytes = min(kTok, page - t0) * tok_bytes;
    const size_t off = (static_cast<size_t>(pid) * page + t0) * hd;
    const auto* ksrc = reinterpret_cast<const unsigned char*>(kp + off);
    const auto* vsrc = reinterpret_cast<const unsigned char*>(vp + off);
    unsigned char* dst = ring + static_cast<size_t>(slot) * 2 * half;
    if (tok_bytes % 16 == 0) {
      for (int b = tid * 16; b < n_bytes; b += kThreads * 16) {
        cp_async<16>(dst + b, ksrc + b);
        cp_async<16>(dst + half + b, vsrc + b);
      }
    } else {  // int8 rows of hd % 16 == 8 bytes
      for (int b = tid * 8; b < n_bytes; b += kThreads * 8) {
        cp_async<8>(dst + b, ksrc + b);
        cp_async<8>(dst + half + b, vsrc + b);
      }
    }
    if constexpr (kQuant) {
      if (tid == 0) {
        cp_async<4>(&sm_scale[slot][0], k_scales + pid);
        cp_async<4>(&sm_scale[slot][1], v_scales + pid);
      }
    }
  };

  float m[GT], l[GT], acc[GT][kVec];
#pragma unroll
  for (int i = 0; i < GT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stage) issue(s, s);
    cp_async_commit();
  }
  for (int j = 0; j < n_stage; ++j) {
    cp_async_wait_group<kStages - 2>();  // stage j has landed
    __syncthreads();  // ... for every thread; slot (j-1) % S is free
    const int next = j + kStages - 1;
    if (next < n_stage) issue(next % kStages, next);
    cp_async_commit();

    const int slot = j % kStages;
    const TKV* ks = reinterpret_cast<const TKV*>(
        ring + static_cast<size_t>(slot) * 2 * half);
    const TKV* vs = reinterpret_cast<const TKV*>(
        ring + static_cast<size_t>(slot) * 2 * half + half);
    const int t0 = (j % blocks) * kTok;
    const int tb = min(kTok, page - t0);
    const int tok0 = (p_lo + j / blocks) * page + t0;
    // token slots u that hold a token of the stage: at hd <= 64 one of
    // kUnroll, at hd 128 two; the others are not scored at all
    const int nu = (tb + kWarps * R - 1) / (kWarps * R);
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = sm_scale[slot][0];
      vsc = sm_scale[slot][1];
    }
    float kx[kUnroll][kVec];
    float vx[kUnroll][kVec];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = (u * kWarps + warp) * R + g;
      in[u] = t < tb;
      if (has && in[u]) {
        load8(ks + t * hd + c * kVec, kx[u]);
        load8(vs + t * hd + c * kVec, vx[u]);
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
        if (u < nu) {  // the same for every lane of the CTA
#pragma unroll
          for (int e = 0; e < kVec; ++e) part += qv[i][e] * kx[u][e];
          for (int off = L >> 1; off > 0; off >>= 1) {
            part += __shfl_xor_sync(0xffffffffu, part, off);
          }
        }
        const int tok = tok0 + (u * kWarps + warp) * R + g;
        s[u] = tok < seq ? part * ksc * scale : kNegInf;
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
        const float pv = p * vsc;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] += pv * vx[u][e];
      }
      m[i] = m_new;
    }
  }
  cp_async_wait_group<0>();

  // merge the R token groups of each warp (all groups end up equal)
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
  // merge the warps through shared memory; warp i finishes row row0 + i
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
  const bool mine = warp < GT && g == 0 && has;  // holds (row, chunk c)
  const int row = row0 + warp;
  float o[kVec];
  float m_all = kNegInf, l_all = 0.f;
  if (mine) {
    const int i = warp;
    m_all = sm_m[0][i];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) m_all = fmaxf(m_all, sm_m[v][i]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float a = expf(sm_m[v][i] - m_all);
      l_all += sm_l[v][i] * a;
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] += sm_acc[v][i][c * kVec + e] * a;
    }
  }
  TQ* orow = out + static_cast<size_t>(row) * hd + c * kVec;
  if (n_splits == 1) {
    if (!mine) return;
    const float inv = 1.f / (l_all == 0.f ? 1.f : l_all);
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] *= inv;
    store8(orow, o);
    return;
  }
  // workspace: acc [BH][n_splits][hd], then (m, l) [BH][n_splits][2]
  const int bh = gridDim.x * GT;
  float* ws_ml = ws + static_cast<size_t>(bh) * n_splits * hd;
  if (mine) {
    const size_t r = static_cast<size_t>(row) * n_splits + split;
    if (c == 0) {
      ws_ml[2 * r] = m_all;
      ws_ml[2 * r + 1] = l_all;
    }
    store8(ws + r * hd + c * kVec, o);
  }
  __threadfence();  // this split's part is visible before it arrives
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + grp, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (mine) {
    // a split that swept nothing wrote m = -1e30, l = 0 and acc = 0: it
    // adds nothing whatever its weight, so every load is unconditional
    // and the loads of all splits are in flight together
    const size_t r0 = static_cast<size_t>(row) * n_splits;
    float mm = kNegInf;
#pragma unroll 8
    for (int sp = 0; sp < n_splits; ++sp) {
      mm = fmaxf(mm, __ldcg(ws_ml + 2 * (r0 + sp)));
    }
    float ll = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_splits; ++sp) {
      const float2 ml =
          __ldcg(reinterpret_cast<const float2*>(ws_ml + 2 * (r0 + sp)));
      float x[kVec];
      load8_cg(ws + (r0 + sp) * hd + c * kVec, x);
      const float a = expf(ml.x - mm);
      ll += ml.y * a;
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = fmaf(x[e], a, o[e]);
    }
    const float inv = 1.f / (ll == 0.f ? 1.f : ll);
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] *= inv;
    store8(orow, o);
  }
  if (tid == 0) counters[grp] = 0;  // ready for the next call
}

template <typename TQ, typename TKV, bool kQuant, int GT>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* table, const int* lens, void* out,
           float* ws, int* counters, int bh, int w, int page, int hd,
           int n_rows, int n_splits, int split_pages, float scale,
           cudaStream_t stream) {
  auto kernel = paged_decode_kernel<TQ, TKV, kQuant, GT>;
  // the attribute is the function's on each device: set it once per device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(ring_bytes<TKV>()));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const size_t smem =
      static_cast<size_t>(stages<TKV>()) * 2 * kTok * hd * sizeof(TKV);
  kernel<<<dim3(bh / GT, n_splits), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, table, lens,
      static_cast<TQ*>(out), ws, counters, w, page, hd, n_rows, split_pages,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool kQuant>
int launch_groups(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* table,
                  const int* lens, void* out, void* workspace,
                  void* counters, int bh, int w, int page, int hd,
                  int n_rows, int group_rows, int n_splits, int split_pages,
                  float scale, cudaStream_t stream) {
  if (hd % kVec != 0 || hd < kVec || hd > kMaxHd || bh < 1 || w < 1 ||
      page < 1 || n_rows < 1 || group_rows < 1 || group_rows > 4 ||
      bh % group_rows != 0 || bh / group_rows > 2147483647 ||
      n_splits < 1 || n_splits > 65535 || split_pages < 1 ||
      split_pages > kMaxSplitPages ||
      static_cast<long long>(n_splits) * split_pages < w ||
      static_cast<long long>(n_splits - 1) * split_pages >= w ||
      (n_splits > 1 && (workspace == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* wsf = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
#define REPRO_PAGED(GT)                                                      \
  return launch<TQ, TKV, kQuant, GT>(q, k, v, ks, vs, table, lens, out, wsf, \
                                     cnt, bh, w, page, hd, n_rows, n_splits, \
                                     split_pages, scale, stream)
  if (group_rows == 4) REPRO_PAGED(4);
  if (group_rows == 3) REPRO_PAGED(3);
  if (group_rows == 2) REPRO_PAGED(2);
  REPRO_PAGED(1);
#undef REPRO_PAGED
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Rows come in groups of
// group_rows (1-4) that share one kv head, table row and length; the page
// sweep is cut into n_splits splits of split_pages pages (n_splits *
// split_pages >= W > (n_splits - 1) * split_pages, split_pages <= 64).
// With more than one split, workspace holds BH * n_splits * (hd + 2)
// floats and counters BH / group_rows zeroed ints, left zeroed.  Returns
// cudaGetLastError().
extern "C" int launch_paged_decode(const void* q, const void* k_pool,
                                   const void* v_pool, const int* table,
                                   const int* lens, void* out,
                                   void* workspace, void* counters, int bh,
                                   int w, int page, int hd, int n_rows,
                                   int group_rows, int n_splits,
                                   int split_pages, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_groups<float, float, false>(
        q, k_pool, v_pool, nullptr, nullptr, table, lens, out, workspace,
        counters, bh, w, page, hd, n_rows, group_rows, n_splits, split_pages,
        scale, s);
  }
  if (dtype == 1) {
    return launch_groups<__nv_bfloat16, __nv_bfloat16, false>(
        q, k_pool, v_pool, nullptr, nullptr, table, lens, out, workspace,
        counters, bh, w, page, hd, n_rows, group_rows, n_splits, split_pages,
        scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 code pools with per-page f32 scales; q_dtype and the rest as above.
extern "C" int launch_paged_decode_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scales, const float* v_scales, const int* table,
    const int* lens, void* out, void* workspace, void* counters, int bh,
    int w, int page, int hd, int n_rows, int group_rows, int n_splits,
    int split_pages, float scale, int q_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) {
    return launch_groups<float, int8_t, true>(
        q, k_pool, v_pool, k_scales, v_scales, table, lens, out, workspace,
        counters, bh, w, page, hd, n_rows, group_rows, n_splits, split_pages,
        scale, s);
  }
  if (q_dtype == 1) {
    return launch_groups<__nv_bfloat16, int8_t, true>(
        q, k_pool, v_pool, k_scales, v_scales, table, lens, out, workspace,
        counters, bh, w, page, hd, n_rows, group_rows, n_splits, split_pages,
        scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
