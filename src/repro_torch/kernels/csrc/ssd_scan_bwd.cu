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
// and G_c = sum_i exp(seg_i) dy_i C_i^T.  Five launches, none carrying
// anything between blocks, and no float atomics: every sum is taken in
// one order, so repeated launches give the same bits.
//   1. ssd_bwd_state_kernel, grid (nc, 2 nh, B): per (chunk, head) the
//      chunk's seg, summed in order by one thread as the forward does
//      (the plain cumsum's bits), its total, and S_c (blockIdx.y < nh,
//      every chunk but the last) or G_c (the rest, every chunk but the
//      first), [hd][ds], over stages of 32 positions in shared memory;
//   2. ssd_bwd_recur_kernel, one thread per (element of the state, head,
//      batch), past one chunk: H_in(c + 1) = exp(total_c) H_in(c) + S_c
//      forward and dH_in(c) = exp(total_c) dH_in(c + 1) + G_c backward,
//      each rounded as two operations, in place: S_c's slot then holds
//      H_in(c) and G_c's the outgoing state's gradient dS_c = dH_in(c+1);
//   3. ssd_bwd_chunk_kernel, one CTA per (chunk, head, batch), 256
//      threads, the chunk in 64-row tiles (dynamic shared memory, one CTA
//      an SM):
//      - intra-chunk, key tile jt outer, query tile it >= jt inner: the
//        scores C_i . B_j and dM_ij = dy_i . x_j (the thread's 4 x 4 of
//        the 64 x 64 pair), then M, ds_ij = dM_ij L_ij dt_j, W = dM M and
//        P = dM L (C . B) in shared memory (L masked before the exp);
//        dx_j += M^T dy and dB_j += ds^T C in registers over it, dC_i +=
//        ds B into the head's partial; row and column sums of W (dseg)
//        and of P (ddt) each by one thread, in order;
//      - inter-chunk and the outgoing state, per row tile: dC_i +=
//        exp(seg_i) dy_i H_in and dseg_i += C_i . that; dx_j += u_j dS
//        B_j; v_j = x_j^T dS, dB_j += u_j v_j, q_j = v_j . B_j, ddt_j +=
//        exp(total - seg_j) q_j, dseg_j -= u_j q_j; then dtotal = sum_j
//        u_j q_j + exp(total) <dS, H_in>;
//      - dtotal joins the last valid position's dseg; one thread takes
//        d(dt A) = the reverse running sum of dseg, ddt += d(dt A) A_h,
//        and the chunk's share of dA_h, sum_t d(dt A)_t dt_t.
//      dx and ddt are written whole; dB and dC stay per head (B and C are
//      shared by the heads), [B, nc, nh, Q, ds], and dA per chunk;
//   4. ssd_bwd_reduce_kernel sums dB and dC over the heads in head order;
//   5. ssd_bwd_reduce_dA_kernel sums dA over (batch, chunk) in order.
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
// limits.  kDs, the state width the tiles hold, is 64 (ds <= 64) or 128.
//
// Bound: operations.  Per batch, with pairs_c the causal pairs of chunk c
// and n_c its rows: the scores, dC and dB of the intra terms once per
// chunk (the heads' ds summed first: 6 pairs_c ds), and per head dM and
// dx over the pairs (4 pairs_c hd), dC_in and G_c for every chunk after
// the first (4 n_c hd ds), S_c, the state's dx and v for every chunk but
// the last (6 n_c hd ds), all f32 on the CUDA cores (67 TFLOP/s; mamba2 at
// B 2 x S 2,048: 34.3 GFLOP, 0.51 ms).  The bytes (x, dy, dt, B, C read,
// the five gradients written) are a few percent of that.  The sums stay
// in f32: TF32 would cost about 1e-3 relative, the budget of the check.
//
// Design, and what it leaves for later.  Every product is a shared-memory
// tile product with a 4 x 4 (or 4 x 8 at ds 128) register tile a thread,
// rows ty + 16 r and columns tx + 16 k; tiles are stored with an odd
// pitch (65, 129), so that a row-major and a transposed read of one tile
// both hit 32 banks, and every operand is read one float at a time.  The
// scores are recomputed per head (the forward shares them across heads),
// the chunk kernel holds 139-172 KB of shared memory and runs one CTA of
// 8 warps an SM, and the per-head dB and dC partials go through device
// memory (2 B S nh ds f32 written and read once).  Sharing the scores,
// more CTAs an SM, 3xTF32 tensor cores and a fused head reduction are
// later work (ROADMAP).

#include "common.cuh"

namespace {

using repro_torch::in_order_sum;

constexpr int kThreads = 256;  // every kernel
constexpr int kTile = 64;      // rows of a tile, and columns of x, dy tiles
constexpr int kPitch = 65;     // shared-memory pitch of 64-wide tiles
constexpr int kMaxChunk = 256;
constexpr int kMaxHd = 64;
constexpr int kMaxDs = 128;
constexpr int kSteps = 32;  // positions per stage of pass 1

// dst[r * kP + col] = src[r * stride + col] for r < rows and col < cols,
// else 0, over the tile's 64 rows and kW columns
template <int kW, int kP>
__device__ __forceinline__ void fill(float* dst, const float* src,
                                     long long stride, int rows, int cols) {
  for (int e = threadIdx.x; e < kTile * kW; e += kThreads) {
    const int r = e / kW, col = e % kW;
    float v = 0.f;
    if (r < rows && col < cols) v = src[r * stride + col];
    dst[r * kP + col] = v;
  }
}

// acc[r][k] += sum_{kk < K} a[(ty + 16 r) a_row + kk a_k]
//                           * b[kk b_k + (tx + 16 k) b_col]
// with (ty, tx) = (tid / 16, tid % 16): the thread's rows ty + 16 r of a
// 64-row output against its columns tx + 16 k
template <int R, int N>
__device__ __forceinline__ void mm(float (&acc)[R][N], const float* a,
                                   int a_row, int a_k, const float* b,
                                   int b_k, int b_col, int K) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* ap = a + ty * a_row;
  const float* bp = b + tx * b_col;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float av[R], bv[N];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = ap[16 * r * a_row + kk * a_k];
#pragma unroll
    for (int k = 0; k < N; ++k) bv[k] = bp[kk * b_k + 16 * k * b_col];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < N; ++k) acc[r][k] = fmaf(av[r], bv[k], acc[r][k]);
    }
  }
}

// the sum of v over the 16 lanes that share the thread's ty (one half of
// its warp), in one fixed order, on every lane
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------- pass 1
// grid (nc, 2 nh, B).  Every CTA sums its chunk's seg; blockIdx.y < nh
// (head h = blockIdx.y) writes seg [B, nh, nc, Q] and total [B, nh, nc]
// and, but for the last chunk, S_c [hd][ds] into hstate [B, nh, nc, hd,
// ds]; the others (head blockIdx.y - nh), but for the first chunk, G_c
// into gstate.  Thread (ty, tx) = (tid / 32, tid % 32) holds rows p = ty
// + 8 r and columns d = tx + 32 k.
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
  __shared__ float s_r[kSteps * (kMaxHd + 1)];  // weighted x or dy [t][p]
  __shared__ float s_v[kSteps * (kDs + 1)];     // B or C [t][d]

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

  const float* rows = g_role ? dy : x;
  const float* vecs = g_role ? C : Bm;
  const long long x_stride = static_cast<long long>(nh) * hd;
  const int ty = tid >> 5, tx = tid & 31;
  constexpr int kCols = kDs / 32;
  float acc[8][kCols];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[r][k] = 0.f;
  }
  for (int t0 = 0; t0 < valid; t0 += kSteps) {
    const int tn = min(kSteps, valid - t0);
    for (int e = tid; e < kSteps * kMaxHd; e += kThreads) {
      const int t = e / kMaxHd, p = e % kMaxHd;
      float v = 0.f;
      if (t < tn && p < hd) {
        v = s_w[t0 + t] *
            rows[(bS + pos0 + t0 + t) * x_stride +
                 static_cast<long long>(h) * hd + p];
      }
      s_r[t * (kMaxHd + 1) + p] = v;
    }
    for (int e = tid; e < kSteps * kDs; e += kThreads) {
      const int t = e / kDs, d = e % kDs;
      float v = 0.f;
      if (t < tn && d < ds) v = vecs[(bS + pos0 + t0 + t) * ds + d];
      s_v[t * (kDs + 1) + d] = v;
    }
    __syncthreads();
    for (int t = 0; t < tn; ++t) {
      float av[8], bv[kCols];
#pragma unroll
      for (int r = 0; r < 8; ++r) av[r] = s_r[t * (kMaxHd + 1) + ty + 8 * r];
#pragma unroll
      for (int k = 0; k < kCols; ++k) bv[k] = s_v[t * (kDs + 1) + tx + 32 * k];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          acc[r][k] = fmaf(av[r], bv[k], acc[r][k]);
        }
      }
    }
    __syncthreads();
  }
  float* out = (g_role ? gstate : hstate) +
               (bh * nc + c) * static_cast<long long>(hd) * ds;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int p = ty + 8 * r;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int d = tx + 32 * k;
      if (p < hd && d < ds) out[p * ds + d] = acc[r][k];
    }
  }
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
  float H = 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long at = static_cast<long long>(c) * n;
    const float s = c < nc - 1 ? hs[at] : 0.f;
    hs[at] = H;  // H_in(c)
    H = __fadd_rn(__fmul_rn(expf(tot[c]), H), s);
  }
  float G = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const long long at = static_cast<long long>(c) * n;
    const float g = c > 0 ? gs[at] : 0.f;
    gs[at] = G;  // dS_c = dH_in(c + 1)
    G = __fadd_rn(__fmul_rn(expf(tot[c]), G), g);
  }
}

// ---------------------------------------------------------- pass 3
// Shared memory of the chunk kernel, in floats: x and dy tiles [64][65],
// B and C tiles [64][kDs + 1], four 64 x 64 pair tiles [64][65] (M, ds,
// W, P; H_in and dS [hd][kDs + 1] in the inter step), and seven per-
// position arrays of kMaxChunk.
template <int kDs>
constexpr int chunk_smem_floats() {
  return 2 * kTile * kPitch + 2 * kTile * (kDs + 1) + 4 * kTile * kPitch +
         7 * kMaxChunk;
}

// grid (nc, nh, B): one CTA per (chunk, head, batch)
template <int kDs>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ C,
                     const float* __restrict__ dy,
                     const float* __restrict__ seg,
                     const float* __restrict__ hstate,
                     const float* __restrict__ gstate,
                     float* __restrict__ dx,
                     float* __restrict__ ddt,
                     float* __restrict__ dBh,
                     float* __restrict__ dCh,
                     float* __restrict__ dAp,
                     int S, int nh, int hd, int ds, int Q) {
  constexpr int kP = kDs + 1;   // pitch of the ds-wide tiles
  constexpr int kN = kDs / 16;  // a thread's columns of a ds-wide product
  extern __shared__ float smem[];
  float* sx = smem;                 // x_j [64][65]
  float* sdy = sx + kTile * kPitch;  // dy_i [64][65]
  float* sB = sdy + kTile * kPitch;  // B_j [64][kP]
  float* sC = sB + kTile * kP;       // C_i [64][kP]
  float* sM = sC + kTile * kP;       // M [i][j]
  float* sDS = sM + kTile * kPitch;  // ds [i][j]
  float* sW = sDS + kTile * kPitch;  // W [i][j]
  float* sP = sW + kTile * kPitch;   // P [i][j]
  float* sH = sM;                    // H_in [p][d] (inter step)
  float* sG = sM + kTile * kP;       // dS [p][d] (inter step)
  float* s_seg = sP + kTile * kPitch;
  float* s_dt = s_seg + kMaxChunk;
  float* s_dsr = s_dt + kMaxChunk;  // dseg: row sums of W, inter terms
  float* s_dsc = s_dsr + kMaxChunk;  // dseg: minus column sums, u q
  float* s_ddt = s_dsc + kMaxChunk;  // ddt before the cumsum's term
  float* s_uq = s_ddt + kMaxChunk;   // u_j q_j
  float* s_red = s_uq + kMaxChunk;   // <dS, H_in> per thread

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long pos0 = static_cast<long long>(c) * Q;
  const long long bS = static_cast<long long>(b) * S;
  const long long bh = static_cast<long long>(b) * nh + h;
  const int valid = static_cast<int>(min(static_cast<long long>(Q), S - pos0));
  const int T = (valid + kTile - 1) / kTile;
  const long long x_stride = static_cast<long long>(nh) * hd;
  const float* xh = x + (bS + pos0) * x_stride + static_cast<long long>(h) * hd;
  const float* dyh = dy + (bS + pos0) * x_stride + static_cast<long long>(h) * hd;
  float* dxh = dx + (bS + pos0) * x_stride + static_cast<long long>(h) * hd;
  const float* Bc = Bm + (bS + pos0) * ds;
  const float* Cc = C + (bS + pos0) * ds;
  const long long part = ((static_cast<long long>(b) * nc + c) * nh + h) *
                         static_cast<long long>(Q) * ds;
  float* dbh = dBh + part;
  float* dch = dCh + part;

  for (int t = tid; t < kMaxChunk; t += kThreads) {
    const bool in = t < valid;
    s_seg[t] = t < Q ? seg[(bh * nc + c) * Q + t] : 0.f;
    s_dt[t] = in ? dt[(bS + pos0 + t) * nh + h] : 0.f;
    s_dsr[t] = 0.f;
    s_dsc[t] = 0.f;
    s_ddt[t] = 0.f;
    s_uq[t] = 0.f;
  }
  __syncthreads();

  // ---- intra-chunk: key tile jt outer, query tile it >= jt inner
  for (int jt = 0; jt < T; ++jt) {
    const int k0 = jt * kTile, keys = min(kTile, valid - k0);
    fill<kTile, kPitch>(sx, xh + k0 * x_stride, x_stride, keys, hd);
    fill<kDs, kP>(sB, Bc + static_cast<long long>(k0) * ds, ds, keys, ds);
    float adx[4][4], adb[4][kN];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) adx[r][k] = 0.f;
#pragma unroll
      for (int k = 0; k < kN; ++k) adb[r][k] = 0.f;
    }
    for (int it = jt; it < T; ++it) {
      const int q0 = it * kTile, rows = min(kTile, valid - q0);
      fill<kTile, kPitch>(sdy, dyh + q0 * x_stride, x_stride, rows, hd);
      fill<kDs, kP>(sC, Cc + static_cast<long long>(q0) * ds, ds, rows, ds);
      __syncthreads();
      float sc[4][4], dm[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int k = 0; k < 4; ++k) sc[r][k] = dm[r][k] = 0.f;
      }
      mm(sc, sC, kP, 1, sB, 1, kP, ds);            // C_i . B_j
      mm(dm, sdy, kPitch, 1, sx, 1, kPitch, hd);   // dy_i . x_j
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = tx + 16 * k;
          const bool keep = i < rows && j < keys && k0 + j <= q0 + i;
          // masked before the exp: above the diagonal the exponent is
          // large and positive
          const float L = keep ? expf(s_seg[q0 + i] - s_seg[k0 + j]) : 0.f;
          const float dtj = s_dt[k0 + j];
          const float m = sc[r][k] * L * dtj;
          const float dl = dm[r][k] * L;
          sM[i * kPitch + j] = m;
          sDS[i * kPitch + j] = dl * dtj;
          sW[i * kPitch + j] = dm[r][k] * m;
          sP[i * kPitch + j] = dl * sc[r][k];
        }
      }
      __syncthreads();
      // dseg_i += sum_j W_ij, dseg_j -= sum_i W_ij, ddt_j += sum_i P_ij:
      // each sum by one thread, in order
      if (tid < kTile) {
        if (tid < rows) {
          float v = 0.f;
          for (int j = 0; j < kTile; ++j) v += sW[tid * kPitch + j];
          s_dsr[q0 + tid] += v;
        }
      } else if (tid < 2 * kTile) {
        const int j = tid - kTile;
        if (j < keys) {
          float v = 0.f;
          for (int i = 0; i < kTile; ++i) v += sW[i * kPitch + j];
          s_dsc[k0 + j] -= v;
        }
      } else if (tid < 3 * kTile) {
        const int j = tid - 2 * kTile;
        if (j < keys) {
          float v = 0.f;
          for (int i = 0; i < kTile; ++i) v += sP[i * kPitch + j];
          s_ddt[k0 + j] += v;
        }
      }
      mm(adx, sM, 1, kPitch, sdy, kPitch, 1, kTile);  // M^T dy
      mm(adb, sDS, 1, kPitch, sC, kP, 1, kTile);      // ds^T C
      float adc[4][kN];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int k = 0; k < kN; ++k) adc[r][k] = 0.f;
      }
      mm(adc, sDS, kPitch, 1, sB, kP, 1, kTile);  // ds B
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          const int d = tx + 16 * k;
          if (i < rows && d < ds) {
            float* p = &dch[static_cast<long long>(q0 + i) * ds + d];
            *p = jt == 0 ? adc[r][k] : *p + adc[r][k];
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      if (j >= keys) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = tx + 16 * k;
        if (p < hd) dxh[(k0 + j) * x_stride + p] = adx[r][k];
      }
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const int d = tx + 16 * k;
        if (d < ds) dbh[static_cast<long long>(k0 + j) * ds + d] = adb[r][k];
      }
    }
  }

  // ---- inter-chunk and the outgoing state
  const bool has_in = c > 0, has_out = c < nc - 1;
  const float total = s_seg[Q - 1];
  const long long hd_ds = static_cast<long long>(hd) * ds;
  if (has_in || has_out) {
    fill<kDs, kP>(sH, hstate + (bh * nc + c) * hd_ds, ds, hd, ds);
    fill<kDs, kP>(sG, gstate + (bh * nc + c) * hd_ds, ds, hd, ds);
    __syncthreads();
    float red = 0.f;
    if (has_in && has_out) {
      for (int e = tid; e < hd * ds; e += kThreads) {
        const int p = e / ds, d = e - p * ds;
        red += sH[p * kP + d] * sG[p * kP + d];
      }
    }
    s_red[tid] = red;
    for (int rt = 0; rt < T; ++rt) {
      const int r0 = rt * kTile, rows = min(kTile, valid - r0);
      fill<kTile, kPitch>(sx, xh + r0 * x_stride, x_stride, rows, hd);
      fill<kTile, kPitch>(sdy, dyh + r0 * x_stride, x_stride, rows, hd);
      fill<kDs, kP>(sB, Bc + static_cast<long long>(r0) * ds, ds, rows, ds);
      fill<kDs, kP>(sC, Cc + static_cast<long long>(r0) * ds, ds, rows, ds);
      __syncthreads();
      if (has_in) {
        // dC_i += exp(seg_i) dy_i H_in; dseg_i += C_i . that
        float acc[4][kN];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int k = 0; k < kN; ++k) acc[r][k] = 0.f;
        }
        mm(acc, sdy, kPitch, 1, sH, kP, 1, hd);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + 16 * r;
          const float e = i < rows ? expf(s_seg[r0 + i]) : 0.f;
          float dot = 0.f;
#pragma unroll
          for (int k = 0; k < kN; ++k) {
            const int d = tx + 16 * k;
            const float v = acc[r][k] * e;
            dot += sC[i * kP + d] * v;
            if (i < rows && d < ds) {
              dch[static_cast<long long>(r0 + i) * ds + d] += v;
            }
          }
          dot = row_sum16(dot);
          if (tx == 0 && i < rows) s_dsr[r0 + i] += dot;
        }
      }
      if (has_out) {
        // dx_j += u_j dS B_j
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
        }
        mm(acc, sB, kP, 1, sG, 1, kP, ds);
        // v_j = x_j^T dS
        float vv[4][kN];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int k = 0; k < kN; ++k) vv[r][k] = 0.f;
        }
        mm(vv, sx, kPitch, 1, sG, kP, 1, hd);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = ty + 16 * r;
          const bool in = j < rows;
          const float ex = in ? expf(total - s_seg[r0 + j]) : 0.f;
          const float u = ex * s_dt[r0 + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = tx + 16 * k;
            if (in && p < hd) dxh[(r0 + j) * x_stride + p] += u * acc[r][k];
          }
          float q = 0.f;
#pragma unroll
          for (int k = 0; k < kN; ++k) {
            const int d = tx + 16 * k;
            q += sB[j * kP + d] * vv[r][k];
            if (in && d < ds) {
              dbh[static_cast<long long>(r0 + j) * ds + d] += u * vv[r][k];
            }
          }
          q = row_sum16(q);
          if (tx == 0 && in) {
            s_ddt[r0 + j] += ex * q;
            s_dsc[r0 + j] -= u * q;
            s_uq[r0 + j] = u * q;
          }
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // ---- dtotal, the cumsum's gradient, ddt and the chunk's share of dA
  if (tid == 0) {
    float dtotal = 0.f;
    for (int t = 0; t < valid; ++t) dtotal += s_uq[t];
    if (has_in && has_out) {
      float hg = 0.f;
      for (int k = 0; k < kThreads; ++k) hg += s_red[k];
      dtotal += expf(total) * hg;
    }
    const float a = A[h];
    float run = dtotal, da = 0.f;
    for (int t = valid - 1; t >= 0; --t) {
      run += s_dsr[t] + s_dsc[t];  // d(dt A)_t
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

// ---------------------------------------------------------- pass 4
// grid (ceil(S ds / 256), B, 2): out[b, s, d] = sum over the heads, in
// order, of part[b, c, h, t, d] (s = c Q + t); z 0 dB, 1 dC
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dBh,
                      const float* __restrict__ dCh, float* __restrict__ dB,
                      float* __restrict__ dC, int S, int nh, int ds, int Q,
                      int nc) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= static_cast<long long>(S) * ds) return;
  const int b = blockIdx.y;
  const int s = static_cast<int>(e / ds), d = static_cast<int>(e % ds);
  const int c = s / Q, t = s - c * Q;
  const float* part = blockIdx.z == 0 ? dBh : dCh;
  const long long stride = static_cast<long long>(Q) * ds;
  const float* src = part + (static_cast<long long>(b) * nc + c) * nh * stride +
                     static_cast<long long>(t) * ds + d;
  float v = 0.f;
  for (int h = 0; h < nh; ++h) v += src[h * stride];
  (blockIdx.z == 0 ? dB : dC)[static_cast<long long>(b) * S * ds + e] = v;
}

// ---------------------------------------------------------- pass 5
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

template <int kDs>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* C, const float* dy, float* dx, float* ddt, float* dA,
           float* dB, float* dC, float* seg, float* total, float* hstate,
           float* gstate, float* dBh, float* dCh, float* dAp, int B, int S,
           int nh, int hd, int ds, int Q, cudaStream_t s) {
  const int nc = (S + Q - 1) / Q;
  ssd_bwd_state_kernel<kDs><<<dim3(nc, 2 * nh, B), kThreads, 0, s>>>(
      x, dt, A, Bm, C, dy, seg, total, hstate, gstate, S, nh, hd, ds, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nc > 1) {
    const int n = hd * ds;
    ssd_bwd_recur_kernel<<<dim3((n + kThreads - 1) / kThreads, nh, B),
                           kThreads, 0, s>>>(total, hstate, gstate, nh, nc,
                                             n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int smem = chunk_smem_floats<kDs>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<kDs>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<kDs><<<dim3(nc, nh, B), kThreads, smem, s>>>(
      x, dt, A, Bm, C, dy, seg, hstate, gstate, dx, ddt, dBh, dCh, dAp, S,
      nh, hd, ds, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems = static_cast<long long>(S) * ds;
  ssd_bwd_reduce_kernel<<<dim3(static_cast<unsigned>(
                                   (elems + kThreads - 1) / kThreads),
                               B, 2),
                          kThreads, 0, s>>>(dBh, dCh, dB, dC, S, nh, ds, Q,
                                            nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_reduce_dA_kernel<<<(nh + kThreads - 1) / kThreads, kThreads, 0,
                             s>>>(dAp, dA, B * nc, nh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx [B, S, nh, hd]; dt, ddt [B, S, nh]; A, dA [nh]; Bm, C, dB, dC
// [B, S, ds]; all f32 and contiguous.  Scratch: seg [B, nh, nc, Q], total
// [B, nh, nc], hstate and gstate [B, nh, nc, hd, ds] (may be null when
// nc = ceil(S / Q) == 1), dBh and dCh [B, nc, nh, Q, ds], dAp [B, nc, nh].
// Five kernels on ``stream`` (four when nc == 1); returns the first launch
// error (0 if none).
extern "C" int launch_ssd_scan_bwd(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* C, const void* dy, void* dx,
                                   void* ddt, void* dA, void* dB, void* dC,
                                   void* seg, void* total, void* hstate,
                                   void* gstate, void* dBh, void* dCh,
                                   void* dAp, int B, int S, int nh, int hd,
                                   int ds, int Q, void* stream) {
  if (B < 1 || S < 1 || nh < 1 || hd < 1 || ds < 1 || Q < 1 || B > 65535 ||
      2 * nh > 65535 || Q > kMaxChunk || hd > kMaxHd || ds > kMaxDs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto run = ds <= 64 ? launch<64> : launch<128>;
  return run(static_cast<const float*>(x), static_cast<const float*>(dt),
             static_cast<const float*>(A), static_cast<const float*>(Bm),
             static_cast<const float*>(C), static_cast<const float*>(dy),
             static_cast<float*>(dx), static_cast<float*>(ddt),
             static_cast<float*>(dA), static_cast<float*>(dB),
             static_cast<float*>(dC), static_cast<float*>(seg),
             static_cast<float*>(total), static_cast<float*>(hstate),
             static_cast<float*>(gstate), static_cast<float*>(dBh),
             static_cast<float*>(dCh), static_cast<float*>(dAp), B, S, nh, hd,
             ds, Q, static_cast<cudaStream_t>(stream));
}
