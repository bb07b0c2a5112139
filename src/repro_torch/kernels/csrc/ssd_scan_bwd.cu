// Backward of the Mamba-2 chunked SSD scan (K6, ssd_scan.cu) for Hopper
// (sm_90a): the gradients of y with respect to x, dt, A, B and C.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel for
// its scan, and XLA differentiates the jnp twin of it,
// src/repro/models/blocks.py _ssd_scan.  This is that autodiff written
// out, in f32, as repro_torch.kernels.ref.ssd_scan_bwd_ref states it (its
// plain twin, in this order of work):
//
//   x, dy [B, S, nh, hd]   dt [B, S, nh]   A [nh]   Bm, C [B, S, ds]
//   -> dx [B, S, nh, hd], ddt [B, S, nh], dA [nh], dB, dC [B, S, ds]
//
// Per chunk c and head h, seg is the running sum of dt A in the chunk,
// total its last value, M_ij = (C_i . B_j) exp(seg_i - seg_j) dt_j for
// j <= i, H_in the state [hd, ds] entering the chunk, u_j = exp(total -
// seg_j) dt_j, S_c = sum_j u_j x_j B_j^T the chunk's own outgoing state
// and G_c = sum_i exp(seg_i) dy_i C_i^T.  B and C are shared by the
// heads, so the score tiles C_i B_j^T and the two products over ds, dC_i
// += ds B_j and dB_j += ds^T C_i, run once per (batch, chunk, tile pair)
// on ds = sum over the heads of dM_ij L_ij dt_j (dM_ij = dy_i . x_j, L
// the masked decay), summed before them.  Eight launches, none carrying
// anything between blocks, and no float atomics: every sum is taken in
// one order, so repeated launches give the same bits.
//   1. ssd_bwd_state_kernel, grid (nc, 2 nh, B): per (chunk, head) the
//      chunk's seg, summed in order by one thread as the forward does
//      (the plain cumsum's bits), its total, and S_c (blockIdx.y < nh,
//      every chunk but the last) or G_c (the rest, every chunk but the
//      first), [hd][ds], over stages of 64 positions in shared memory;
//   2. ssd_bwd_recur_kernel, one thread per (element of the state, head,
//      batch), past one chunk: H_in(c + 1) = exp(total_c) H_in(c) + S_c
//      forward and dH_in(c) = exp(total_c) dH_in(c + 1) + G_c backward,
//      each rounded as two operations, in place: S_c's slot then holds
//      H_in(c) and G_c's the outgoing state's gradient dS_c = dH_in(c+1);
//   3. ssd_bwd_scores_kernel: the chunk's score tiles, once for all heads;
//   4. ssd_bwd_pair_kernel, per (key tile jt, batch, chunk, group of 16
//      heads): each head in order over the query tiles it >= jt: dM, M,
//      ds, W = dM M and P = dM L (C . B); dx_j += M^T dy_i; W's row sums
//      (dseg_i, one array per key tile), W's and P's column sums (dseg_j,
//      ddt_j); ds summed over the group's heads, one partial per group;
//   5. ssd_bwd_row_kernel, per (role, batch, chunk, row tile, group): the
//      outgoing state (every chunk but the last), V = x_j dS, q_j = V_j .
//      B_j, dx_j += u_j B_j dS^T, the terms exp(total - seg_j) q_j (ddt)
//      and u_j q_j (dseg, dtotal), the group's sum of u_j V_j (dB); the
//      incoming state (every chunk but the first), Cin = dy_i H_in, the
//      term exp(seg_i) C_i . Cin_i (dseg), the group's sum of exp(seg_i)
//      Cin_i (dC);
//   6. ssd_bwd_dseg_kernel, per (batch, chunk, head): dseg from its terms,
//      dtotal = sum_j u_j q_j + exp(total) <dS, H_in> joining the last
//      valid position, one thread's reverse running sum d(dt A), ddt and
//      the chunk's share of dA;
//   7. ssd_bwd_dbc_kernel, per (batch, chunk, tile, dC or dB): the groups'
//      ds summed in group order, dC_i = sum_{jt <= i} ds B_jt and dB_j =
//      sum_{it >= j} ds^T C_it, plus the groups' state terms;
//   8. ssd_bwd_reduce_dA_kernel sums dA over (batch, chunk) in order.
//
// The state is recomputed, not saved: the forward keeps none of H_in
// (its scratch holds per-chunk outgoing states and dies with the call),
// so pass 1 recomputes S_c as the forward's pass 1 does, at about a tenth
// of the backward's operations; saving H_in would hold B nc nh hd ds f32
// per layer across the forward (42 MB a mamba2 layer at B 2 x S 2,048)
// and change the forward.
//
// Any S: the last chunk is ragged; its missing positions count as zero
// padding with dt = 0, every term of theirs is 0, and their rows are
// neither read nor written.  Q <= 256, hd <= 64, ds <= 128: the forward's
// limits.  kDs, the state width the tiles hold, is 64 (ds <= 64) or 128;
// any nh (the last head group may hold fewer than 16 heads).
//
// Bound: operations.  Per batch, with pairs_c the causal pairs of chunk c
// and n_c its rows: the scores, dC and dB of the intra terms once per
// chunk (6 pairs_c ds), and per head dM and dx over the pairs (4 pairs_c
// hd), dC_in and G_c for every chunk after the first (4 n_c hd ds), S_c,
// the state's dx and v for every chunk but the last (6 n_c hd ds): mamba2
// at B 2 x S 2,048 34.7 GFLOP, 0.517 ms at f32's 67 TFLOP/s on the CUDA
// cores and 0.210 ms as 3xTF32 at dense TF32's 495 TFLOP/s.  The bytes
// (x, dy, dt, B, C read, the five gradients written) are a few percent.
//
// Design.  Passes 3, 4, 5 and 7 run every tile product as 3xTF32 on the
// tensor cores (mma.sync m16n8k8: each f32 operand split into its top 19
// bits and the rest, three products summed in f32, about f32's precision;
// plain TF32's 1e-3 would be the whole of ddt's and dA's budget).
// Operands are read from shared memory at pitches of 68 (4 mod 32 banks:
// row-major fragment reads) or 72 (8 mod 32: column reads), conflict-free
// but for one 2-way pattern.  Pass 4 is a persistent grid
// of one 16-warp CTA an SM (121 KB of shared memory: x_j, dy_i, M and the
// group's ds of up to four pairs, each thread its own elements) over its
// items, heaviest key tiles first; pass 5 two 8-warp CTAs an SM (87 KB).
// ds is summed over heads inside a CTA in head order, over the groups by
// pass 7 in group order: no per-head dB or dC partial reaches device
// memory (the groups' ds and dC/dB terms are 13 and 21 MB at mamba2's
// microbatch; per-head dB and dC partials would be 335 MB).  Pass 1's
// products (S_c, G_c) are 3xTF32 too; pass 2 is element-wise.

#include "common.cuh"

namespace {

using repro_torch::in_order_sum;

constexpr int kThreads = 256;  // every kernel but pass 4
constexpr int kTile = 64;      // rows of a tile, and columns of x, dy tiles
constexpr int kMaxChunk = 256;
constexpr int kMaxHd = 64;
constexpr int kMaxDs = 128;

// ---------------------------------------------------------- 3xTF32
// Tile products on the tensor cores with the precision of f32: each f32
// operand x is split into hi, its top 19 bits (a TF32 value), and lo = x
// - hi (exact), which the tensor core reads to TF32's 19 bits; mma.sync
// m16n8k8 sums lo.hi + hi.lo + hi.hi in f32.  The dropped lo.lo term and
// lo's own truncation are each below 2^-20 of a product.  A mask and a
// subtraction, at full rate: a conversion (cvt.rna.tf32) runs at a
// quarter of it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

// The fragment map of a CTA's 64-row output tile: warp w holds the 16 rows
// from 16 (w % 4) and the 8 NT columns from 8 NT (w / 4); its thread (g,
// t4) = (lane / 4, lane % 4) holds acc[n][e] at row(e) = 16 (w % 4) + g +
// 8 (e / 2) and col(n, e) = 8 NT (w / 4) + 8 n + 2 t4 + e % 2 (the
// mma.sync C layout).
struct Frag {
  int r0, c0, g, t4, wr, wc;
  __device__ __forceinline__ explicit Frag(int nt) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    wr = w & 3;
    wc = w >> 2;
    r0 = 16 * wr;
    c0 = 8 * nt * wc;
    g = lane >> 2;
    t4 = lane & 3;
  }
  __device__ __forceinline__ int row(int e) const {
    return r0 + g + 8 * (e >> 1);
  }
  __device__ __forceinline__ int col(int n, int e) const {
    return c0 + 8 * n + 2 * t4 + (e & 1);
  }
};

// acc[n][e] += sum_{k < K} A(row(e), k) B(k, col(n, e)), K a multiple of 8
// (the tiles are zero-padded), with A(r, k) = a[r ar + k ak] and B(k, c) =
// b[k bk + c bc] in shared memory
// With NT <= 4 the two correction products sum into accumulators of their
// own, added at the end, so that a warp has twice the independent
// product chains (few n-tiles a warp would otherwise wait on each
// product's latency); wider tiles have chains enough and no registers.
template <int NT>
__device__ __forceinline__ void mma3(float (&acc)[NT][4], const Frag& f,
                                     const float* a, int ar, int ak,
                                     const float* b, int bk, int bc, int K) {
  constexpr bool kSplit = NT <= 4;
  const float* ap = a + (f.r0 + f.g) * ar + f.t4 * ak;
  const float* bp = b + (f.c0 + f.g) * bc + f.t4 * bk;
  float cor[kSplit ? NT : 1][4];
  zero(cor);
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(ap[k0 * ak], ah[0], al[0]);
    split_tf32(ap[8 * ar + k0 * ak], ah[1], al[1]);
    split_tf32(ap[(k0 + 4) * ak], ah[2], al[2]);
    split_tf32(ap[8 * ar + (k0 + 4) * ak], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(bp[8 * n * bc + k0 * bk], bh0, bl0);
      split_tf32(bp[8 * n * bc + (k0 + 4) * bk], bh1, bl1);
      float (&c)[4] = kSplit ? cor[kSplit ? n : 0] : acc[n];
      mma_tf32(c, al, bh0, bh1);
      mma_tf32(c, ah, bl0, bl1);
      mma_tf32(acc[n], ah, bh0, bh1);
    }
  }
  if (kSplit) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += cor[kSplit ? n : 0][e];
    }
  }
}

// sums over the lanes of a warp that share t4 (its 8 g), or g (its 4 t4),
// in one fixed order
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}
__device__ __forceinline__ float sum_over_t4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// dst[r * kP + col] = src[r * stride + col] for r < rows and col < cols,
// (times rw[r] where row weights are given) else 0, over 64 rows and kW
// columns, by the CTA's kN threads: every
// load of a thread is issued before its first store (16 bytes a load
// where cols, stride and src allow), so that the copy waits on memory
// once and not once an element
template <int kW, int kP, int kN>
__device__ __forceinline__ void fill(float* dst, const float* src,
                                     long long stride, int rows, int cols,
                                     const float* rw = nullptr) {
  if ((cols & 3) == 0 && (stride & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int kV = kW / 4;  // float4 a row
    constexpr int kIter = (kTile * kV + kN - 1) / kN;
    float4 v[kIter];
#pragma unroll
    for (int u = 0; u < kIter; ++u) {
      const int e = threadIdx.x + u * kN;
      const int r = e / kV, c = (e % kV) * 4;
      v[u] = e < kTile * kV && r < rows && c < cols
                 ? *reinterpret_cast<const float4*>(src + r * stride + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kIter; ++u) {
      const int e = threadIdx.x + u * kN;
      if (e < kTile * kV) {
        float4 x = v[u];
        if (rw != nullptr) {
          const float w = rw[e / kV];
          x = make_float4(w * x.x, w * x.y, w * x.z, w * x.w);
        }
        *reinterpret_cast<float4*>(dst + (e / kV) * kP + (e % kV) * 4) = x;
      }
    }
    return;
  }
  // element by element, eight loads a batch
  for (int e0 = threadIdx.x; e0 < kTile * kW; e0 += 8 * kN) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kN;
      const int r = e / kW, c = e % kW;
      v[u] = e < kTile * kW && r < rows && c < cols ? src[r * stride + c]
                                                    : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kN;
      if (e < kTile * kW) {
        dst[(e / kW) * kP + e % kW] =
            rw != nullptr ? rw[e / kW] * v[u] : v[u];
      }
    }
  }
}

// index of the tile pair (query tile it, key tile jt <= it)
__host__ __device__ __forceinline__ int pair_index(int it, int jt) {
  return it * (it + 1) / 2 + jt;
}

// the per-position terms of a (batch, chunk, head) that pass 7 sums, each
// [Q]: W's row sums from key tile jt (kRowW + jt), W's column sums, P's
// column sums (ddt's intra term), the inter-chunk dseg, the outgoing
// state's ddt term exp(total - seg_j) q_j and u_j q_j
constexpr int kRowW = 0;
constexpr int kColW = 4;
constexpr int kColP = 5;
constexpr int kInter = 6;
constexpr int kOutDdt = 7;
constexpr int kUq = 8;
constexpr int kTerms = 9;
constexpr int kHeadGroup = 16;  // heads a CTA of passes 5 and 6 walks
constexpr int kPX = 68;  // pitch of 64-wide tiles read along their rows
constexpr int kPM = 72;  // pitch of 64-wide tiles read down their columns

// ---------------------------------------------------------- pass 1
// grid (nc, 2 nh, B).  Every CTA sums its chunk's seg; blockIdx.y < nh
// (head h = blockIdx.y) writes seg [B, nh, nc, Q] and total [B, nh, nc]
// and, but for the last chunk, S_c [hd][ds] into hstate [B, nh, nc, hd,
// ds]; the others (head blockIdx.y - nh), but for the first chunk, G_c
// into gstate.
template <int kDs>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ C,
                     const float* __restrict__ dy,
                     float* __restrict__ seg_out,
                     float* __restrict__ total_out,
                     float* __restrict__ hstate,
                     float* __restrict__ gstate,
                     int S, int nh, int hd, int ds, int Q) {
  __shared__ float s_seg[kMaxChunk];
  __shared__ float s_w[kMaxChunk];
  extern __shared__ float smem[];
  float* s_r = smem;                // x or dy of 64 positions [t][kPM]
  float* s_v = s_r + kTile * kPM;   // B or C [t][kDs + 8]

  const int c = blockIdx.x, b = blockIdx.z;
  const int nc = gridDim.x;
  const bool g_role = blockIdx.y >= nh;
  const int h = g_role ? blockIdx.y - nh : blockIdx.y;
  const int tid = threadIdx.x;
  const long long pos0 = static_cast<long long>(c) * Q;
  const long long bS = static_cast<long long>(b) * S;
  const long long bh = static_cast<long long>(b) * nh + h;
  const int valid = static_cast<int>(min(static_cast<long long>(Q), S - pos0));

  for (int t = tid; t < Q; t += kThreads) {
    s_w[t] = t < valid ? __fmul_rn(dt[(bS + pos0 + t) * nh + h], A[h]) : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    const float v = in_order_sum<kMaxChunk>(s_w, s_seg, valid);
    for (int t = valid; t < Q; ++t) s_seg[t] = v;
  }
  __syncthreads();
  const float total = s_seg[Q - 1];
  if (!g_role) {
    for (int t = tid; t < Q; t += kThreads) {
      seg_out[(bh * nc + c) * Q + t] = s_seg[t];
    }
    if (tid == 0) total_out[bh * nc + c] = total;
  }
  if (g_role ? c == 0 : c == nc - 1) return;

  // the rows' weights: u_t = exp(total - seg_t) dt_t (S_c), exp(seg_t)
  // (G_c)
  for (int t = tid; t < valid; t += kThreads) {
    s_w[t] = g_role ? expf(s_seg[t])
                    : expf(total - s_seg[t]) * dt[(bS + pos0 + t) * nh + h];
  }
  __syncthreads();

  // out[p][d] = sum_t w_t rows_t[p] vecs_t[d], over stages of 64
  // positions, 3xTF32 (rows p as M: the weighted rows read down columns)
  const float* rows = g_role ? dy : x;
  const float* vecs = g_role ? C : Bm;
  const long long x_stride = static_cast<long long>(nh) * hd;
  constexpr int NT = kDs / 16;
  const Frag f(NT);
  float acc[NT][4];
  zero(acc);
  for (int t0 = 0; t0 < valid; t0 += kTile) {
    const int tn = min(kTile, valid - t0);
    __syncthreads();  // the previous stage's products are done
    fill<kTile, kPM, kThreads>(
        s_r,
        rows + (bS + pos0 + t0) * x_stride + static_cast<long long>(h) * hd,
        x_stride, tn, hd, s_w + t0);
    fill<kDs, kDs + 8, kThreads>(s_v, vecs + (bS + pos0 + t0) * ds, ds, tn,
                                 ds);
    __syncthreads();
    mma3<NT>(acc, f, s_r, 1, kPM, s_v, kDs + 8, 1, (tn + 7) & ~7);
  }
  float* out = (g_role ? gstate : hstate) +
               (bh * nc + c) * static_cast<long long>(hd) * ds;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = f.row(e), d = f.col(n, e);
      if (p < hd && d < ds) out[p * ds + d] = acc[n][e];
    }
  }
}

template <int kDs>
constexpr int state_smem_floats() {
  return kTile * kPM + kTile * (kDs + 8);
}

// ---------------------------------------------------------- pass 2
// grid (ceil(hd ds / 256), nh, B), past one chunk: element e of one
// head's state through the chunks, forward then backward, in place
__global__ void __launch_bounds__(kThreads)
ssd_bwd_recur_kernel(const float* __restrict__ total,
                     float* __restrict__ hstate, float* __restrict__ gstate,
                     int nh, int nc, int n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const long long bh = static_cast<long long>(blockIdx.z) * nh + blockIdx.y;
  const float* tot = total + bh * nc;
  float* hs = hstate + bh * nc * n + e;
  float* gs = gstate + bh * nc * n + e;
  // kB chunks' loads are issued before their stores, so that the walk
  // waits on memory once every kB chunks
  constexpr int kB = 8;
  float H = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kB) {
    float sv[kB], dv[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int c = c0 + u;
      sv[u] = c < nc - 1 ? hs[static_cast<long long>(c) * n] : 0.f;
      dv[u] = c < nc ? expf(tot[c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        hs[static_cast<long long>(c) * n] = H;  // H_in(c)
        H = __fadd_rn(__fmul_rn(dv[u], H), sv[u]);
      }
    }
  }
  float G = 0.f;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kB) {
    float gv[kB], dv[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int c = c1 - u;
      gv[u] = c > 0 ? gs[static_cast<long long>(c) * n] : 0.f;
      dv[u] = c >= 0 ? expf(tot[max(c, 0)]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int c = c1 - u;
      if (c >= 0) {
        gs[static_cast<long long>(c) * n] = G;  // dS_c = dH_in(c + 1)
        G = __fadd_rn(__fmul_rn(dv[u], G), gv[u]);
      }
    }
  }
}

// ---------------------------------------------------------- pass 3
// grid (B nc P): scores[b, c, p] = C_i B_j^T for the tile pair p = (it,
// jt), [64][64], once for all heads; rows past the chunk are zero.
template <int kDs>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_scores_kernel(const float* __restrict__ Bm,
                      const float* __restrict__ C,
                      float* __restrict__ scores, int S, int ds, int Q,
                      int nc, int P) {
  constexpr int kP = kDs + 4;
  extern __shared__ float smem[];
  float* sC = smem;
  float* sB = sC + kTile * kP;
  const int p = blockIdx.x % P;
  const int c = (blockIdx.x / P) % nc;
  const int b = blockIdx.x / (P * nc);
  int it = 0;
  while (pair_index(it + 1, 0) <= p) ++it;
  const int jt = p - pair_index(it, 0);
  const long long pos0 = static_cast<long long>(c) * Q;
  const int valid = static_cast<int>(min(static_cast<long long>(Q), S - pos0));
  if (it * kTile >= valid) return;
  const long long bS = static_cast<long long>(b) * S;
  fill<kDs, kP, kThreads>(sC, C + (bS + pos0 + it * kTile) * ds, ds,
                valid - it * kTile, ds);
  fill<kDs, kP, kThreads>(sB, Bm + (bS + pos0 + jt * kTile) * ds, ds,
                valid - jt * kTile, ds);
  __syncthreads();
  const Frag f(4);
  float acc[4][4];
  zero(acc);
  mma3<4>(acc, f, sC, kP, 1, sB, 1, kP, (ds + 7) & ~7);
  float* out = scores + ((static_cast<long long>(b) * nc + c) * P + p) *
                            kTile * kTile;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(out + f.row(2 * h) * kTile + f.col(n, 0)) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------- pass 4
// The intra-chunk terms.  A persistent grid of one 16-warp CTA an SM walks
// the items (key tile jt, batch, chunk, head group), jt slowest, so that
// the items with the most tile pairs start first.  An item walks its
// heads in order and, for each, the query tiles it >= jt: dM = dy_i x_j^T
// (3xTF32), then M, ds, W and P from the shared scores; dx_j += M^T dy_i
// (3xTF32) in registers; W's row sums of the pair and, once the head's
// query tiles are done, W's and P's column sums to ``terms``; ds summed
// over the group's heads, in head order, in shared memory (each thread
// its own elements), written once per pair to the group's partial.
constexpr int kPairThreads = 512;
constexpr int kPairNT = 2;  // 16 warps over a 64 x 64 tile: 16 x 16 each

constexpr int pair_smem_floats() {
  return 2 * kTile * kPX + kTile * kPM + 4 * kTile * kTile +
         4 * kTile + 2 * 4 * kTile + 2 * kMaxChunk;
}

__global__ void __launch_bounds__(kPairThreads, 1)
ssd_bwd_pair_kernel(const float* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ dy,
                    const float* __restrict__ seg,
                    const float* __restrict__ scores,
                    float* __restrict__ dx, float* __restrict__ terms,
                    float* __restrict__ dsc_part, int B, int S, int nh,
                    int hd, int Q, int nc, int T, int P, int G) {
  extern __shared__ float smem[];
  float* sx = smem;                        // x_j [64][kPX]
  float* sdy = sx + kTile * kPX;           // dy_i [64][kPX]
  float* sM = sdy + kTile * kPX;           // M [i][j], pitch kPM
  float* sacc = sM + kTile * kPM;  // the group's ds [pair][8][512]
  float* part = sacc + 4 * kTile * kTile;  // W row partials [4 wc][64]
  float* partW = part + 4 * kTile;         // column partials [4 wr][64]
  float* partP = partW + 4 * kTile;
  float* s_seg = partP + 4 * kTile;
  float* s_dt = s_seg + kMaxChunk;
  const int tid = threadIdx.x;
  const Frag f(kPairNT);
  const long long x_stride = static_cast<long long>(nh) * hd;
  const int hd8 = (hd + 7) & ~7;
  const int per_jt = B * nc * G;

  for (int item = blockIdx.x; item < T * per_jt; item += gridDim.x) {
    const int jt = item / per_jt;
    const int g = item % G;
    const int c = (item / G) % nc;
    const int b = (item / (G * nc)) % B;
    const long long pos0 = static_cast<long long>(c) * Q;
    const int valid =
        static_cast<int>(min(static_cast<long long>(Q), S - pos0));
    const int Tc = (valid + kTile - 1) / kTile;
    const int h0 = g * kHeadGroup, h1 = min(nh, h0 + kHeadGroup);
    if (jt >= Tc || h0 >= nh) continue;
    const int np = Tc - jt;
    const int rows_j = min(kTile, valid - jt * kTile);
    const long long bS = static_cast<long long>(b) * S;
    for (int e = 0; e < np * 8; ++e) sacc[e * kPairThreads + tid] = 0.f;

    for (int h = h0; h < h1; ++h) {
      const long long bhc = (static_cast<long long>(b) * nh + h) * nc + c;
      const long long tbase = ((static_cast<long long>(b) * nc + c) * nh + h) *
                              kTerms * Q;
      __syncthreads();  // the previous head is done with every buffer
      for (int t = tid; t < Q; t += kPairThreads) {
        s_seg[t] = seg[bhc * Q + t];
        s_dt[t] = t < valid ? dt[(bS + pos0 + t) * nh + h] : 0.f;
      }
      fill<kTile, kPX, kPairThreads>(
          sx, x + (bS + pos0 + jt * kTile) * x_stride + h * hd, x_stride,
          rows_j, hd);
      float dxa[kPairNT][4], colW[kPairNT][2], colP[kPairNT][2];
      zero(dxa);
#pragma unroll
      for (int n = 0; n < kPairNT; ++n) {
        colW[n][0] = colW[n][1] = colP[n][0] = colP[n][1] = 0.f;
      }
      for (int it = jt; it < Tc; ++it) {
        const int pl = it - jt;
        const int rows_i = min(kTile, valid - it * kTile);
        __syncthreads();  // sdy, sM and part are free
        fill<kTile, kPX, kPairThreads>(sdy,
                         dy + (bS + pos0 + it * kTile) * x_stride + h * hd,
                         x_stride, rows_i, hd);
        const float* sc_tile =
            scores + ((static_cast<long long>(b) * nc + c) * P +
                      pair_index(it, jt)) * kTile * kTile;
        float sc[kPairNT][4];
#pragma unroll
        for (int n = 0; n < kPairNT; ++n) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 v = *reinterpret_cast<const float2*>(
                sc_tile + f.row(2 * hh) * kTile + f.col(n, 0));
            sc[n][2 * hh] = v.x;
            sc[n][2 * hh + 1] = v.y;
          }
        }
        __syncthreads();
        float dm[kPairNT][4];
        zero(dm);
        mma3<kPairNT>(dm, f, sdy, kPX, 1, sx, 1, kPX, hd8);  // dy_i . x_j
        float rw[2] = {0.f, 0.f};
        float* acc_p = sacc + pl * kTile * kTile;
#pragma unroll
        for (int n = 0; n < kPairNT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = f.row(e), j = f.col(n, e);
            const bool keep = i < rows_i && j < rows_j && (it > jt || j <= i);
            // masked before the exp: above the diagonal the exponent is
            // large and positive
            const float L = keep ? expf(s_seg[it * kTile + i] -
                                        s_seg[jt * kTile + j])
                                 : 0.f;
            const float dtj = s_dt[jt * kTile + j];
            const float m = sc[n][e] * L * dtj;
            const float dl = dm[n][e] * L;
            sM[i * kPM + j] = m;
            acc_p[(4 * n + e) * kPairThreads + tid] += dl * dtj;
            const float w = dm[n][e] * m;
            rw[e >> 1] += w;
            colW[n][e & 1] += w;
            colP[n][e & 1] += dl * sc[n][e];
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float v = sum_over_t4(rw[hh]);
          if (f.t4 == 0) part[f.wc * kTile + f.row(2 * hh)] = v;
        }
        __syncthreads();  // sM and the row partials are complete
        if (tid < rows_i) {
          float v = 0.f;
          for (int k = 0; k < 4; ++k) v += part[k * kTile + tid];
          terms[tbase + (kRowW + jt) * Q + it * kTile + tid] = v;
        }
        // dx_j += M^T dy_i
        mma3<kPairNT>(dxa, f, sM, 1, kPM, sdy, kPX, 1, kTile);
      }
      // the column sums of the head's pairs: over each warp's rows, then
      // over the four row warps in order
#pragma unroll
      for (int n = 0; n < kPairNT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vw = sum_over_g(colW[n][e]);
          const float vp = sum_over_g(colP[n][e]);
          if (f.g == 0) {
            partW[f.wr * kTile + f.col(n, e)] = vw;
            partP[f.wr * kTile + f.col(n, e)] = vp;
          }
        }
      }
      __syncthreads();
      if (tid < rows_j) {
        float vw = 0.f, vp = 0.f;
        for (int k = 0; k < 4; ++k) {
          vw += partW[k * kTile + tid];
          vp += partP[k * kTile + tid];
        }
        terms[tbase + kColW * Q + jt * kTile + tid] = vw;
        terms[tbase + kColP * Q + jt * kTile + tid] = vp;
      }
#pragma unroll
      for (int n = 0; n < kPairNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = f.row(e), p = f.col(n, e);
          if (j < rows_j && p < hd) {
            dx[(bS + pos0 + jt * kTile + j) * x_stride + h * hd + p] =
                dxa[n][e];
          }
        }
      }
    }
    // the group's ds of every pair of the column, [64][64] each
    for (int pl = 0; pl < np; ++pl) {
      float* out = dsc_part +
                   (((static_cast<long long>(b) * nc + c) * G + g) * P +
                    pair_index(jt + pl, jt)) * kTile * kTile;
      const float* acc_p = sacc + pl * kTile * kTile;
#pragma unroll
      for (int n = 0; n < kPairNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          out[f.row(e) * kTile + f.col(n, e)] =
              acc_p[(4 * n + e) * kPairThreads + tid];
        }
      }
    }
  }
}

// ---------------------------------------------------------- pass 5
// The inter-chunk and outgoing-state terms.  A persistent grid (two CTAs
// an SM) walks the items (role, batch, chunk, row tile, head group); an
// item walks its heads in order:
//   role 1, rows j (every chunk but the last): V = x_j dS (3xTF32), q_j =
//     V_j . B_j, u_j = exp(total - seg_j) dt_j; terms exp(total - seg_j)
//     q_j and u_j q_j; the group's sum of u_j V_j (dB's term) in
//     registers; Z = B_j dS^T (3xTF32) and dx_j += u_j Z_j;
//   role 0, rows i (every chunk but the first): Cin = dy_i H_in (3xTF32),
//     e_i = exp(seg_i); the term e_i C_i . Cin_i (dseg); the group's sum
//     of e_i Cin_i (dC's term) in registers.
// Each writes its group's sum once, [Q][ds] per (batch, chunk, group).
template <int kDs>
constexpr int row_smem_floats() {
  return kTile * (kDs + 4) + kTile * kPX + kTile * (kDs + 8) + 2 * kTile +
         2 * kTile;
}

template <int kDs>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_row_kernel(const float* __restrict__ x,
                   const float* __restrict__ dt,
                   const float* __restrict__ Bm,
                   const float* __restrict__ C,
                   const float* __restrict__ dy,
                   const float* __restrict__ seg,
                   const float* __restrict__ hstate,
                   const float* __restrict__ gstate,
                   float* __restrict__ dx, float* __restrict__ terms,
                   float* __restrict__ cin_part,
                   float* __restrict__ bout_part, int B, int S, int nh,
                   int hd, int ds, int Q, int nc, int T, int G) {
  constexpr int kPV = kDs + 4;
  constexpr int kPS = kDs + 8;
  constexpr int NT = kDs / 16;  // 8 warps over a 64 x kDs tile
  extern __shared__ float smem[];
  float* sV = smem;                 // C_i or B_j [64][kPV]
  float* sR = sV + kTile * kPV;     // dy_i or x_j [64][kPX]
  float* sS = sR + kTile * kPX;     // H_in or dS [hd][kPS]
  float* part = sS + kTile * kPS;   // row partials [2 wc][64]
  float* s_seg = part + 2 * kTile;  // the tile's seg
  float* s_dt = s_seg + kTile;      // and dt
  const int tid = threadIdx.x;
  const Frag f(NT);
  const Frag fz(4);  // Z: 64 x 64 (hd padded)
  const long long x_stride = static_cast<long long>(nh) * hd;
  const long long hd_ds = static_cast<long long>(hd) * ds;
  const int hd8 = (hd + 7) & ~7, ds8 = (ds + 7) & ~7;
  const int per_role = B * nc * T * G;

  for (int item = blockIdx.x; item < 2 * per_role; item += gridDim.x) {
    const int role = 1 - item / per_role;  // the heavier role first
    const int g = item % G;
    const int r = (item / G) % T;
    const int c = (item / (G * T)) % nc;
    const int b = (item / (G * T * nc)) % B;
    const long long pos0 = static_cast<long long>(c) * Q;
    const int valid =
        static_cast<int>(min(static_cast<long long>(Q), S - pos0));
    const int h0 = g * kHeadGroup, h1 = min(nh, h0 + kHeadGroup);
    if (r * kTile >= valid || h0 >= nh) continue;
    const int rows = min(kTile, valid - r * kTile);
    const long long bS = static_cast<long long>(b) * S;
    const long long row0 = bS + pos0 + r * kTile;  // the tile's first row
    const bool active = role == 0 ? c > 0 : c < nc - 1;
    float tot[NT][4];
    zero(tot);
    __syncthreads();  // the previous item is done with sV
    if (active) {
      fill<kDs, kPV, kThreads>(sV, (role == 0 ? C : Bm) + row0 * ds, ds, rows,
                               ds);
    }
    for (int h = h0; h < h1; ++h) {
      const long long bhc = (static_cast<long long>(b) * nh + h) * nc + c;
      const long long tbase = ((static_cast<long long>(b) * nc + c) * nh + h) *
                                  kTerms * Q + r * kTile;
      if (!active) {
        if (tid < rows) {
          if (role == 0) {
            terms[tbase + kInter * Q + tid] = 0.f;
          } else {
            terms[tbase + kOutDdt * Q + tid] = 0.f;
            terms[tbase + kUq * Q + tid] = 0.f;
          }
        }
        continue;
      }
      const float total = seg[bhc * Q + Q - 1];
      __syncthreads();  // the previous head is done with sR, sS, part
      if (tid < kTile) {
        const bool in = tid < rows;
        s_seg[tid] = in ? seg[bhc * Q + r * kTile + tid] : 0.f;
        s_dt[tid] = in ? dt[(row0 + tid) * nh + h] : 0.f;
      }
      fill<kTile, kPX, kThreads>(
          sR, (role == 0 ? dy : x) + row0 * x_stride + h * hd, x_stride, rows,
          hd);
      fill<kDs, kPS, kThreads>(
          sS, (role == 0 ? hstate : gstate) + bhc * hd_ds, ds, hd, ds);
      __syncthreads();
      float v[NT][4];
      zero(v);
      mma3<NT>(v, f, sR, kPX, 1, sS, kPS, 1, hd8);  // dy_i H_in, x_j dS
      // the rows' weights: e_i = exp(seg_i) (role 0), u_j (role 1)
      float wgt[2], ex[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = f.row(2 * hh);
        const bool in = i < rows;
        ex[hh] = in ? expf(role == 0 ? s_seg[i] : total - s_seg[i]) : 0.f;
        wgt[hh] = role == 0 ? ex[hh] : ex[hh] * s_dt[i];
      }
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dot[e >> 1] += sV[f.row(e) * kPV + f.col(n, e)] * v[n][e];
          tot[n][e] += wgt[e >> 1] * v[n][e];
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float s = sum_over_t4(dot[hh]);
        if (f.t4 == 0) part[f.wc * kTile + f.row(2 * hh)] = s;
      }
      if (role == 1) {
        // Z = B_j dS^T, and dx_j += u_j Z_j (every dx load issued before
        // the first store)
        float z[4][4], old[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = fz.row(e), p = fz.col(n, e);
            old[n][e] = j < rows && p < hd
                            ? dx[(row0 + j) * x_stride + h * hd + p]
                            : 0.f;
          }
        }
        zero(z);
        mma3<4>(z, fz, sV, kPV, 1, sS, 1, kPS, ds8);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = fz.row(e), p = fz.col(n, e);
            if (j < rows && p < hd) {
              dx[(row0 + j) * x_stride + h * hd + p] =
                  old[n][e] + wgt[e >> 1] * z[n][e];
            }
          }
        }
      }
      __syncthreads();  // the row partials are complete
      if (tid < rows) {
        const float d = part[tid] + part[kTile + tid];
        if (role == 0) {
          terms[tbase + kInter * Q + tid] = expf(s_seg[tid]) * d;
        } else {
          const float e = expf(total - s_seg[tid]);
          terms[tbase + kOutDdt * Q + tid] = e * d;
          terms[tbase + kUq * Q + tid] = e * s_dt[tid] * d;
        }
      }
    }
    float* out = (role == 0 ? cin_part : bout_part) +
                 ((static_cast<long long>(b) * nc + c) * G + g) * Q * ds +
                 static_cast<long long>(r) * kTile * ds;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = f.row(e), d = f.col(n, e);
        if (i < rows && d < ds) out[i * ds + d] = tot[n][e];
      }
    }
  }
}

// ---------------------------------------------------------- pass 6
// grid (B nc nh): per (batch, chunk, head) dseg from the terms (W's row
// sums over the key tiles in order, minus its column sums, the inter term,
// minus u q), dtotal = sum u_j q_j + exp(total) <dS, H_in>, then one
// thread takes d(dt A) = the reverse running sum of dseg from dtotal at
// the last valid position, ddt = P's column sums + the state's term +
// d(dt A) A_h, and the chunk's share of dA_h, sum_t d(dt A)_t dt_t.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dseg_kernel(const float* __restrict__ dt,
                    const float* __restrict__ A,
                    const float* __restrict__ seg,
                    const float* __restrict__ hstate,
                    const float* __restrict__ gstate,
                    const float* __restrict__ terms, float* __restrict__ ddt,
                    float* __restrict__ dAp, int S, int nh, int hd, int ds,
                    int Q, int nc) {
  __shared__ float s_dseg[kMaxChunk];
  __shared__ float s_ddt[kMaxChunk];
  __shared__ float s_uq[kMaxChunk];
  __shared__ float s_dt[kMaxChunk];
  __shared__ float s_red[kThreads];
  const int h = blockIdx.x % nh;
  const int c = (blockIdx.x / nh) % nc;
  const int b = blockIdx.x / (nh * nc);
  const int tid = threadIdx.x;
  const long long pos0 = static_cast<long long>(c) * Q;
  const long long bS = static_cast<long long>(b) * S;
  const int valid = static_cast<int>(min(static_cast<long long>(Q), S - pos0));
  const long long bhc = (static_cast<long long>(b) * nh + h) * nc + c;
  const float* tm = terms + ((static_cast<long long>(b) * nc + c) * nh + h) *
                                kTerms * Q;
  for (int t = tid; t < valid; t += kThreads) {
    float v = 0.f;
    for (int jt = 0; jt <= t / kTile; ++jt) v += tm[(kRowW + jt) * Q + t];
    const float uq = tm[kUq * Q + t];
    s_dseg[t] = v - tm[kColW * Q + t] + tm[kInter * Q + t] - uq;
    s_ddt[t] = tm[kColP * Q + t] + tm[kOutDdt * Q + t];
    s_uq[t] = uq;
    s_dt[t] = dt[(bS + pos0 + t) * nh + h];
  }
  float red = 0.f;
  if (c > 0 && c < nc - 1) {
    const long long n = static_cast<long long>(hd) * ds;
    const float* hs = hstate + bhc * n;
    const float* gs = gstate + bhc * n;
    for (long long e = tid; e < n; e += kThreads) red += hs[e] * gs[e];
  }
  s_red[tid] = red;
  __syncthreads();
  if (tid == 0) {
    float dtotal = 0.f;
    for (int t = 0; t < valid; ++t) dtotal += s_uq[t];
    if (c > 0 && c < nc - 1) {
      float hg = 0.f;
      for (int k = 0; k < kThreads; ++k) hg += s_red[k];
      dtotal += expf(seg[bhc * Q + Q - 1]) * hg;
    }
    const float a = A[h];
    float run = dtotal, da = 0.f;
    for (int t = valid - 1; t >= 0; --t) {
      run += s_dseg[t];  // d(dt A)_t
      s_ddt[t] += run * a;
      da += run * s_dt[t];
    }
    dAp[(static_cast<long long>(b) * nc + c) * nh + h] = da;
  }
  __syncthreads();
  for (int t = tid; t < valid; t += kThreads) {
    ddt[(bS + pos0 + t) * nh + h] = s_ddt[t];
  }
}

// ---------------------------------------------------------- pass 7
// grid (B nc T 2): dC for the rows of query tile r (role 0) = sum over
// key tiles jt <= r of ds(r, jt) B_jt, plus the groups' dC terms; dB for
// the rows of key tile r (role 1) = sum over query tiles it >= r of
// ds(it, r)^T C_it, plus the groups' dB terms.  ds(it, jt) is the sum of
// the groups' partials in group order; every sum in one order (3xTF32
// products over the pairs in tile order, then the groups' terms).
template <int kDs>
constexpr int dbc_smem_floats() {
  return kTile * kPM + kTile * (kDs + 8);
}

template <int kDs>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dbc_kernel(const float* __restrict__ Bm, const float* __restrict__ C,
                   const float* __restrict__ dsc_part,
                   const float* __restrict__ cin_part,
                   const float* __restrict__ bout_part,
                   float* __restrict__ dB, float* __restrict__ dC, int S,
                   int ds, int Q, int nc, int T, int P, int G) {
  constexpr int kPS = kDs + 8;
  constexpr int NT = kDs / 16;
  extern __shared__ float smem[];
  float* sD = smem;               // ds(it, jt) [i][j], pitch kPM
  float* sS = sD + kTile * kPM;   // B_jt or C_it [64][kPS]
  const int role = blockIdx.x & 1;
  const int r = (blockIdx.x >> 1) % T;
  const int c = (blockIdx.x / (2 * T)) % nc;
  const int b = blockIdx.x / (2 * T * nc);
  const int tid = threadIdx.x;
  const long long pos0 = static_cast<long long>(c) * Q;
  const int valid = static_cast<int>(min(static_cast<long long>(Q), S - pos0));
  const int Tc = (valid + kTile - 1) / kTile;
  if (r >= Tc) return;
  const int rows = min(kTile, valid - r * kTile);
  const long long bS = static_cast<long long>(b) * S;
  const long long bc = static_cast<long long>(b) * nc + c;
  const Frag f(NT);
  float acc[NT][4];
  zero(acc);
  const int lo = role == 0 ? 0 : r, hi = role == 0 ? r : Tc - 1;
  for (int o = lo; o <= hi; ++o) {  // the other tile of each pair
    const int p = role == 0 ? pair_index(r, o) : pair_index(o, r);
    __syncthreads();  // the previous pair's product is done
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      float v = 0.f;
      for (int g = 0; g < G; ++g) {
        v += dsc_part[((bc * G + g) * P + p) * kTile * kTile + e];
      }
      sD[(e / kTile) * kPM + e % kTile] = v;
    }
    fill<kDs, kPS, kThreads>(
        sS, (role == 0 ? Bm : C) + (bS + pos0 + o * kTile) * ds, ds,
        min(kTile, valid - o * kTile), ds);
    __syncthreads();
    if (role == 0) {
      mma3<NT>(acc, f, sD, kPM, 1, sS, kPS, 1, kTile);  // ds(r, o) B_o
    } else {
      mma3<NT>(acc, f, sD, 1, kPM, sS, kPS, 1, kTile);  // ds(o, r)^T C_o
    }
  }
  const float* part = (role == 0 ? cin_part : bout_part) + bc * G * Q * ds +
                      static_cast<long long>(r) * kTile * ds;
  float* out = (role == 0 ? dC : dB) + (bS + pos0 + r * kTile) * ds;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = f.row(e), d = f.col(n, e);
      if (i < rows && d < ds) {
        float v = acc[n][e];
        for (int g = 0; g < G; ++g) v += part[g * Q * ds + i * ds + d];
        out[i * ds + d] = v;
      }
    }
  }
}

// ---------------------------------------------------------- pass 8
// dA[h] = sum over (batch, chunk), in order, of dAp[b, c, h]
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_dA_kernel(const float* __restrict__ dAp,
                         float* __restrict__ dA, int n_bc, int nh) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= nh) return;
  float v = 0.f;
  for (int k = 0; k < n_bc; ++k) v += dAp[static_cast<long long>(k) * nh + h];
  dA[h] = v;
}

// the launches' scratch, in floats (see launch_ssd_scan_bwd)
struct Scratch {
  float *seg, *total, *hstate, *gstate, *scores, *dsc, *cin, *bout, *terms,
      *dAp;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int kDs>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* C, const float* dy, float* dx, float* ddt, float* dA,
           float* dB, float* dC, const Scratch& w, int B, int S, int nh,
           int hd, int ds, int Q, cudaStream_t s) {
  const int nc = (S + Q - 1) / Q;
  const int T = (Q + kTile - 1) / kTile;
  const int P = T * (T + 1) / 2;
  const int G = (nh + kHeadGroup - 1) / kHeadGroup;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int state_smem = state_smem_floats<kDs>() * 4;
  if ((err = allow_smem(ssd_bwd_state_kernel<kDs>, state_smem)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  ssd_bwd_state_kernel<kDs><<<dim3(nc, 2 * nh, B), kThreads, state_smem,
                              s>>>(
      x, dt, A, Bm, C, dy, w.seg, w.total, w.hstate, w.gstate, S, nh, hd, ds,
      Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (nc > 1) {
    const int n = hd * ds;
    ssd_bwd_recur_kernel<<<dim3((n + kThreads - 1) / kThreads, nh, B),
                           kThreads, 0, s>>>(w.total, w.hstate, w.gstate, nh,
                                             nc, n);
    if ((err = cudaGetLastError()) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const int scores_smem = 2 * kTile * (kDs + 4) * 4;
  const int pair_smem = pair_smem_floats() * 4;
  const int row_smem = row_smem_floats<kDs>() * 4;
  const int dbc_smem = dbc_smem_floats<kDs>() * 4;
  if ((err = allow_smem(ssd_bwd_scores_kernel<kDs>, scores_smem)) !=
          cudaSuccess ||
      (err = allow_smem(ssd_bwd_pair_kernel, pair_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_row_kernel<kDs>, row_smem)) != cudaSuccess ||
      (err = allow_smem(ssd_bwd_dbc_kernel<kDs>, dbc_smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  ssd_bwd_scores_kernel<kDs><<<B * nc * P, kThreads, scores_smem, s>>>(
      Bm, C, w.scores, S, ds, Q, nc, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int pair_items = T * B * nc * G;
  ssd_bwd_pair_kernel<<<min(pair_items, sms), kPairThreads, pair_smem, s>>>(
      x, dt, dy, w.seg, w.scores, dx, w.terms, w.dsc, B, S, nh, hd, Q, nc, T,
      P, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int row_items = 2 * B * nc * T * G;
  ssd_bwd_row_kernel<kDs><<<min(row_items, 2 * sms), kThreads, row_smem, s>>>(
      x, dt, Bm, C, dy, w.seg, w.hstate, w.gstate, dx, w.terms, w.cin, w.bout,
      B, S, nh, hd, ds, Q, nc, T, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dseg_kernel<<<B * nc * nh, kThreads, 0, s>>>(
      dt, A, w.seg, w.hstate, w.gstate, w.terms, ddt, w.dAp, S, nh, hd, ds, Q,
      nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dbc_kernel<kDs><<<B * nc * T * 2, kThreads, dbc_smem, s>>>(
      Bm, C, w.dsc, w.cin, w.bout, dB, dC, S, ds, Q, nc, T, P, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_reduce_dA_kernel<<<(nh + kThreads - 1) / kThreads, kThreads, 0,
                             s>>>(w.dAp, dA, B * nc, nh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx [B, S, nh, hd]; dt, ddt [B, S, nh]; A, dA [nh]; Bm, C, dB, dC
// [B, S, ds]; all f32 and contiguous.  Scratch, with nc = ceil(S / Q), T =
// ceil(Q / 64), P = T (T + 1) / 2 and G = ceil(nh / 16): seg [B, nh, nc,
// Q], total [B, nh, nc], hstate and gstate [B, nh, nc, hd, ds] (null when
// nc == 1), scores [B, nc, P, 64, 64], dsc [B, nc, G, P, 64, 64], cin and
// bout [B, nc, G, Q, ds], terms [B, nc, nh, 9, Q], dAp [B, nc, nh].
// Eight kernels on ``stream`` (seven when nc == 1); returns the first
// launch error (0 if none).
extern "C" int launch_ssd_scan_bwd(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* C, const void* dy, void* dx,
                                   void* ddt, void* dA, void* dB, void* dC,
                                   void* seg, void* total, void* hstate,
                                   void* gstate, void* scores, void* dsc,
                                   void* cin, void* bout, void* terms,
                                   void* dAp, int B, int S, int nh, int hd,
                                   int ds, int Q, void* stream) {
  if (B < 1 || S < 1 || nh < 1 || hd < 1 || ds < 1 || Q < 1 || B > 65535 ||
      2 * nh > 65535 || Q > kMaxChunk || hd > kMaxHd || ds > kMaxDs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scratch w{static_cast<float*>(seg),    static_cast<float*>(total),
                  static_cast<float*>(hstate), static_cast<float*>(gstate),
                  static_cast<float*>(scores), static_cast<float*>(dsc),
                  static_cast<float*>(cin),    static_cast<float*>(bout),
                  static_cast<float*>(terms),  static_cast<float*>(dAp)};
  auto run = ds <= 64 ? launch<64> : launch<128>;
  return run(static_cast<const float*>(x), static_cast<const float*>(dt),
             static_cast<const float*>(A), static_cast<const float*>(Bm),
             static_cast<const float*>(C), static_cast<const float*>(dy),
             static_cast<float*>(dx), static_cast<float*>(ddt),
             static_cast<float*>(dA), static_cast<float*>(dB),
             static_cast<float*>(dC), w, B, S, nh, hd, ds, Q,
             static_cast<cudaStream_t>(stream));
}
