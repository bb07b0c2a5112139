// Mamba-2 chunked SSD scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package's
// src/repro/kernels/ssd_scan.py (ssd_scan, _ssd_kernel) -> launch_ssd_scan,
// the twin of repro.models.blocks._ssd_scan that every Mamba-2 prefill
// runs.  It computes what those compute, in f32:
//
//   x  [B, S, nh, hd]   dt [B, S, nh] (post-softplus)   A [nh] (negative)
//   Bm [B, S, ds]       C  [B, S, ds] (shared by the heads, n_groups 1)
//   y  [B, S, nh, hd]:  h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
//                       y_t = h_t C_t,  h_{-1} = 0
//
// in chunks of Q positions: inside a chunk the attention form
// y_i = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j, with seg the
// running sum of dt A inside the chunk, plus exp(seg_i) C_i . H_in, the
// state [hd, ds] that came into the chunk.  The D skip and the gate stay
// outside, as in the TPU kernel.
//
// Any S: the last chunk is ragged; its missing positions count as dt = 0
// (they neither decay nor feed the state, as the zero padding of
// _ssd_scan makes them) and their rows are not written.  Q <= 256,
// hd <= 64, ds <= 128: the widths both served models use.
//
// Bound: operations, but for the shortest prompts.  The work is the
// scores C B^T over each chunk's causal pairs once (the heads share B and
// C), and per head the pairs' M x, C . H_in for every chunk after the
// first and the outgoing state of every chunk but the last, all f32 on
// the CUDA cores (67 TFLOP/s) against x, B, C, dt read and y written once
// (3.35 TB/s).  mamba2 (nh 80, hd 64, ds 128, Q 256): S 32 0.00040 ms
// (bytes), S 256 0.0052, S 768 0.0355, S 1024 0.0507 (operations);
// zamba2 (nh 64, ds 64) S 1024 0.0284.  The sums stay in f32: TF32
// tensor cores cost about 1e-3 relative in one pass, the whole budget of
// the kernel check.
//
// Design.  The TPU kernel walks the chunks of one head in order and
// keeps the state in VMEM between grid steps; here nothing carries
// between blocks.  A prompt longer than one chunk takes two launches:
//   1. ssd_chunk_state_kernel, grid (nc, nh * G + nt, B), G = ceil(ds /
//      64): for each (chunk, head, 64 d of the state) the running decay
//      seg and, but for the last chunk, the outgoing state
//      S_c = sum_j exp(total - seg_j) dt_j x_j B_j^T, stored d-major
//      ([ds][hd]); the nt = T (T + 1) / 2 further CTAs of a chunk (T =
//      ceil(Q / 64)) each compute one causal 64 x 64 score tile
//      C_q B_k^T, once for all the heads, stored key-major into a scratch
//      that stays in L2 (16 KB a tile, 160 KB a chunk at Q 256); the
//      diagonal ones also store C_q^T, read by every head's C_q . H_in;
//   2. ssd_tile_output_kernel, one CTA per (64 query rows, head, batch):
//      C_q . H_in scaled by exp(seg_i), with H_in = exp(total) H + S_c
//      summed over the earlier chunks in the CTA (the state pass of the
//      first form, in its order), then for each key tile on or below the
//      diagonal the head's M = scores exp(seg_i - seg_j) dt_j (masked
//      before the exp), made in shared memory from the score tile, times
//      x.  Below the diagonal every j < i, and the decay is the product
//      exp(seg_i - p) exp(p - seg_j) with p the tile's last seg: both
//      exponents <= 0, and 12 exps a thread in place of 32.
// A prompt of one chunk (S <= Q: 1,024 of mamba2's 1,216 serving
// launches) takes ssd_one_chunk_kernel alone: launched only on the
// ceil(S / 64) query tiles that exist, each CTA sums its chunk's seg
// itself in the order of pass 1 and computes its own score tiles (one
// or two a CTA at the served prompts, under the time a second launch
// takes), and no scratch is allocated.
//
// What the design does about the first form's costs: the scores of a
// multi-chunk scan are computed once per (chunk, query tile, key tile)
// instead of once per head, about half of what the first form executed
// at S 768; the state pass is no launch of its own, and the one-chunk
// scan is one launch where the first form made two.  Every product runs
// an 8 x 4 register tile a thread (two float4 reads of the row operand,
// which the warp reads as broadcasts, and one of the column operand per
// 32 FMAs), and a warp stops the diagonal tile's key loop at its last
// row.  Rows of x, B, the states and the scores are copied 16 bytes at a
// time (kVec, when hd and ds are multiples of 4 and the inputs 16-byte
// aligned), with no division in any fill; the transposed fills of C and
// B read coalesced along d.  Each pass-1 CTA holds 64 d of one state, so
// the state sweep spreads over twice the CTAs at ds 128.  128 threads a
// CTA everywhere, at most 128 registers (four CTAs an SM).  What the
// time is spent on, and the designs measured against this one: PERF.md.
//
// ptxas -v (the flags of _build.py, CUDA 12.8, kVec false / true), a note
// and no build flag: ssd_chunk_state_kernel 125 / 125 registers, 36,864
// bytes of shared memory, no spills; ssd_tile_output_kernel 128 / 128,
// 36,864 bytes, 48 / 0 bytes spilled; ssd_one_chunk_kernel 128 / 128,
// 36,864 bytes, 8 / 72 bytes spilled.
//
// Bits that the plain version's bits depend on are kept: seg summed by
// one thread in order with every product and sum rounded on its own (the
// plain cumsum's bits; exp(seg_i - seg_j) of two sums of order 10^3
// keeps their rounding), masking before the exp, the state recurrence's
// exp(total) * H + S_c rounded as two operations, no float atomics:
// repeated launches give the same bits.
//
// Later work: 3xTF32 tensor cores at a stated bound, and the final state
// for the decode cache (pass 1 on the last chunk, one more step of the
// recurrence).

#include "common.cuh"

namespace {

using repro_torch::in_order_sum;

constexpr int kThreads = 128;  // every kernel
constexpr int kTile = 64;      // query rows and key columns of one tile
constexpr int kPitch = 68;     // shared-memory row pitch of 64-wide tiles
constexpr int kMaxChunk = 256;
constexpr int kMaxHd = 64;
constexpr int kMaxDs = 128;
constexpr int kSteps = 32;       // positions per stage of the state sweep
constexpr int kScoreSteps = 32;  // d per slice of a pass-1 score tile

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// One float from global to shared memory without passing through
// registers (cp.async), zero-filled where !ok (src is then not read);
// every fill issues all its copies before waiting once, so a fill costs
// one round trip to memory and not one per element.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16 bytes, both addresses 16-byte aligned, zero-filled where !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// close this thread's group of copies
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's groups are in flight (the caller
// then syncs the CTA)
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// wait for all of this thread's copies
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// Issue the copies dst[row][col] = src[row * stride + col] of a kRows x 64
// tile, zero for row >= rows or col >= cols: 16 bytes a copy when kVec
// (cols, stride and src multiples of 4 floats), else 4.  Thread e of the
// tile's (row, column group) list takes e = tid + kThreads n.
template <bool kVec, int kRows>
__device__ __forceinline__ void fill_rows(float* dst, const float* src,
                                          long long stride, int rows,
                                          int cols) {
  constexpr int kW = kVec ? 4 : 1;
#pragma unroll 8
  for (int e = threadIdx.x; e < kRows * kTile / kW; e += kThreads) {
    const int row = e / (kTile / kW), col = (e % (kTile / kW)) * kW;
    const bool ok = row < rows && col < cols;
    const float* s = ok ? src + row * stride + col : src;
    if constexpr (kVec) {
      cp_async16(&dst[row * kPitch + col], s, ok);
    } else {
      cp_async4(&dst[row * kPitch + col], s, ok);
    }
  }
}

// Issue the copies dst[col][row] = src[row * stride + col] for row < 64
// and col < kCols (zero for row >= rows or col >= cols): a tile stored
// transposed, read along the row (lanes on neighbouring columns, so the
// global reads coalesce).
template <int kCols>
__device__ __forceinline__ void fill_transposed(float* dst, const float* src,
                                                long long stride, int rows,
                                                int cols) {
#pragma unroll 8
  for (int e = threadIdx.x; e < kTile * kCols; e += kThreads) {
    const int col = e % kCols, row = e / kCols;
    const bool ok = row < rows && col < cols;
    cp_async4(&dst[col * kPitch + row], ok ? src + row * stride + col : src,
              ok);
  }
}

// acc[r][k] += a[r] * b[k], a = (a0, a1) the thread's 8 rows
__device__ __forceinline__ void outer84(float (&acc)[8][4], const float4 a0,
                                        const float4 a1, const float4 b) {
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(av[r], bv[k], acc[r][k]);
  }
}

// acc += s_a[k][8 ty ..] (x) s_b[k][4 tx ..] over k < n: thread (ty, tx)
// = (tid / 16, tid % 16) holds rows 8 ty + r (r < 8), columns 4 tx + k
__device__ __forceinline__ void tile_product(float (&acc)[8][4],
                                             const float* s_a,
                                             const float* s_b, int n) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    outer84(acc, ld4(&s_a[k * kPitch + 8 * ty]),
            ld4(&s_a[k * kPitch + 8 * ty + 4]),
            ld4(&s_b[k * kPitch + 4 * tx]));
  }
}

// y rows row0 .. row0 + rows - 1 of head h from the thread's 8 x 4 tile
__device__ __forceinline__ void store_tile(float* __restrict__ y,
                                           const float (&acc)[8][4],
                                           long long row0, int rows, int nh,
                                           int h, int hd) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = 8 * ty + r;
    if (i >= rows) continue;
    float* out = y + ((row0 + i) * nh + h) * hd;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * tx + k;
      if (p < hd) out[p] = acc[r][k];
    }
  }
}

// ---------------------------------------------------------- pass 1
// One score tile of chunk c, stored key-major: scores[j][i] = B[k0 + j] .
// C[q0 + i] over ds, for the tile's (rt, kt) of the chunk's lower
// triangle; zero past S.  Slices of 32 d go through s_k and s_c d-major;
// a diagonal tile (kt == rt) also stores its slices of C_q^T [ds][64], the
// operand the output kernel's inter-chunk products read.
__device__ void chunk_score_tile(const float* __restrict__ Bm,
                                 const float* __restrict__ C,
                                 float* __restrict__ scores,
                                 float* __restrict__ ct, float* s_k,
                                 float* s_c, int S, int ds, int Q, int nc,
                                 int nt, int tix) {
  const int c = blockIdx.x, b = blockIdx.z;
  int rt = 0, kt = tix;
  while (kt > rt) {
    kt -= rt + 1;
    ++rt;
  }
  const long long pos0 = static_cast<long long>(c) * Q;
  const long long bS = static_cast<long long>(b) * S;
  const int q0 = rt * kTile, k0 = kt * kTile;
  const int rows = static_cast<int>(
      min(static_cast<long long>(min(kTile, Q - q0)), S - pos0 - q0));
  if (rows <= 0) return;  // a query tile wholly past S: never read
  const int keys = static_cast<int>(
      min(static_cast<long long>(min(kTile, Q - k0)), S - pos0 - k0));
  float acc[8][4] = {};  // keys 8 ty + r against query rows 4 tx + k
  for (int d0 = 0; d0 < ds; d0 += kScoreSteps) {
    const int dn = min(kScoreSteps, ds - d0);
    fill_transposed<kScoreSteps>(s_k, Bm + (bS + pos0 + k0) * ds + d0, ds,
                                 keys, dn);
    fill_transposed<kScoreSteps>(s_c, C + (bS + pos0 + q0) * ds + d0, ds,
                                 rows, dn);
    cp_async_wait_all();
    __syncthreads();
    if (kt == rt) {
      const int tiles = (Q + kTile - 1) / kTile;
      float* dst = ct + (((static_cast<long long>(b) * nc + c) * tiles + rt) *
                             ds + d0) * kTile;
      for (int e = threadIdx.x; e < dn * kTile / 4; e += kThreads) {
        const int d = e >> 4, i = (e & 15) * 4;
        st4(&dst[d * kTile + i], ld4(&s_c[d * kPitch + i]));
      }
    }
    tile_product(acc, s_k, s_c, dn);
    __syncthreads();
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* out = scores + ((static_cast<long long>(b) * nc + c) * nt + tix) *
                            kTile * kTile;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    st4(&out[(8 * ty + r) * kTile + 4 * tx],
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
  }
}

// grid (nc, nh * G + nt, B), G = ceil(ds / 64).  blockIdx.y < nh * G:
// head h = blockIdx.y / G and state rows d0 = 64 (blockIdx.y % G) ..:
// seg [B, nh, nc*Q] and total [B, nh, nc] (written by the g == 0 CTA)
// and the state [B, nh, nc, ds, hd]; else score tile blockIdx.y - nh G,
// scores [B, nc, nt, 64 keys, 64 query rows], and from the diagonal
// tiles ct [B, nc, T, ds, 64], each query tile's C^T.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ C,
                       float* __restrict__ seg_out,
                       float* __restrict__ total_out,
                       float* __restrict__ state_out,
                       float* __restrict__ scores,
                       float* __restrict__ ct,
                       int S, int nh, int hd, int ds, int Q, int nt) {
  __shared__ float s_seg[kMaxChunk];
  __shared__ float s_w[kMaxChunk];
  // two stages of x [t][p] and B [t][d] (a score tile: slices of B^T and
  // C^T, 32 x 68 floats each)
  __shared__ __align__(16) float s_buf[4 * kSteps * kPitch];

  const int c = blockIdx.x, b = blockIdx.z;
  const int nc = gridDim.x;
  const int groups = (ds + kTile - 1) / kTile;
  if (blockIdx.y >= nh * groups) {
    chunk_score_tile(Bm, C, scores, ct, s_buf, s_buf + kScoreSteps * kPitch,
                     S, ds, Q, nc, nt, blockIdx.y - nh * groups);
    return;
  }
  const int h = blockIdx.y / groups, g = blockIdx.y - h * groups;
  // the last chunk's state is never read: only its seg, from g == 0
  if (c == nc - 1 && g > 0) return;
  const int tid = threadIdx.x;
  const long long pos0 = static_cast<long long>(c) * Q;
  const long long bS = static_cast<long long>(b) * S;
  const long long bh = static_cast<long long>(b) * nh + h;

  // running decay inside the chunk, summed in order by one thread with
  // every product and sum rounded on its own: the plain version's
  // cumsum of dt A along the chunk (sequential on the CPU and on the
  // card) gives the same bits, and exp(seg_i - seg_j) of two sums of
  // order 10^3 keeps their rounding
  float dtv[kMaxChunk / kThreads];
#pragma unroll
  for (int k = 0; k < kMaxChunk / kThreads; ++k) {
    const int t = tid + k * kThreads;
    dtv[k] = t < Q && pos0 + t < S ? dt[(bS + pos0 + t) * nh + h] : 0.f;
    if (t < Q) s_w[t] = __fmul_rn(dtv[k], A[h]);
  }
  __syncthreads();
  // positions past S add dt A = 0: their seg repeats the last one
  const int valid = static_cast<int>(min(static_cast<long long>(Q), S - pos0));
  if (tid == 0) {
    const float v = in_order_sum<kMaxChunk>(s_w, s_seg, valid);
    for (int t = valid; t < Q; ++t) s_seg[t] = v;
  }
  __syncthreads();
  const float total = s_seg[Q - 1];
#pragma unroll
  for (int k = 0; k < kMaxChunk / kThreads; ++k) {
    const int t = tid + k * kThreads;
    if (t < Q) {
      const float v = s_seg[t];
      if (g == 0) seg_out[bh * nc * Q + pos0 + t] = v;
      s_w[t] = expf(total - v) * dtv[k];
    }
  }
  if (tid == 0 && g == 0) total_out[bh * nc + c] = total;
  if (c == nc - 1) return;
  __syncthreads();

  // S_c[d][p] = sum_t B[t][d] w_t x[t][p] for d = d0 + 8 ty + r and
  // p = 4 tx + k, over stages of kSteps positions in a two-deep ring: the
  // copies of stage st + 1 fly while stage st computes
  const int d0 = g * kTile, dn = min(kTile, ds - d0);
  const long long x_stride = static_cast<long long>(nh) * hd;
  const float* xh = x + (bS + pos0) * x_stride + static_cast<long long>(h) * hd;
  const float* bc = Bm + (bS + pos0) * ds + d0;
  const int n_stages = (valid + kSteps - 1) / kSteps;
  auto issue = [&](int st) {
    const int t0 = st * kSteps, tn = min(kSteps, valid - t0);
    float* sx = s_buf + (st & 1) * 2 * kSteps * kPitch;
    fill_rows<kVec, kSteps>(sx, xh + t0 * x_stride, x_stride, tn, hd);
    fill_rows<kVec, kSteps>(sx + kSteps * kPitch, bc + t0 * ds, ds, tn, dn);
    cp_async_commit();
  };
  float acc[8][4] = {};
  issue(0);
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      issue(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int t0 = st * kSteps, tn = min(kSteps, valid - t0);
    float* sx = s_buf + (st & 1) * 2 * kSteps * kPitch;
    // w_t x[t][p], each thread on the elements it copied (fill_rows' map)
    constexpr int kW = kVec ? 4 : 1;
#pragma unroll
    for (int e = tid; e < kSteps * kTile / kW; e += kThreads) {
      const int t = e / (kTile / kW), p = (e % (kTile / kW)) * kW;
      if (t < tn && p < hd) {
        const float w = s_w[t0 + t];
#pragma unroll
        for (int u = 0; u < kW; ++u) {
          sx[t * kPitch + p + u] = w * sx[t * kPitch + p + u];
        }
      }
    }
    __syncthreads();
    tile_product(acc, sx + kSteps * kPitch, sx, tn);
    __syncthreads();
  }
  const int ty = tid >> 4, tx = tid & 15;
  float* out = state_out + (bh * nc + c) * hd * ds;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int d = d0 + 8 * ty + r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * tx + k;
      if (d < ds && p < hd) out[d * hd + p] = acc[r][k];
    }
  }
}

// ---------------------------------------------------------- pass 2
// grid (query tiles, nh, B), past one chunk: one CTA per 64 query rows of
// one head, over every chunk's tiles but those of the last chunk wholly
// past S; thread (ty, tx) holds rows i = 8 ty + r against columns
// p = 4 tx + k of hd.  Its stages (C^T and H_in slices of 64 d for every
// chunk after the first, then the score tile S^T and the x tile of each
// key tile on or below the diagonal) each fill one (A, B) pair of tiles;
// four CTAs share an SM, so one's copies fly while the others compute (a
// two-deep ring, at three CTAs an SM, measured slower).  A score tile
// becomes the head's M^T in place, each thread on the elements it copied.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
ssd_tile_output_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ ct,
                       const float* __restrict__ seg,
                       const float* __restrict__ scores,
                       const float* __restrict__ state,
                       const float* __restrict__ total,
                       float* __restrict__ y,
                       int S, int nh, int hd, int ds, int Q, int tiles,
                       int nc) {
  __shared__ __align__(16) float a[kTile * kPitch];   // C^T [d][i], M^T [j][i]
  __shared__ __align__(16) float bb[kTile * kPitch];  // H_in [d][p], x [j][p]
  __shared__ float s_seg[kMaxChunk];  // seg of the chunk's positions
  __shared__ float s_dt[kMaxChunk];   // dt of the same

  const int c = blockIdx.x / tiles, rt = blockIdx.x - c * tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4;
  const long long pos0 = static_cast<long long>(c) * Q;
  const long long bS = static_cast<long long>(b) * S;
  const long long bh = static_cast<long long>(b) * nh + h;
  const int q0 = rt * kTile;
  const int valid = static_cast<int>(min(static_cast<long long>(Q), S - pos0));
  const int rows = min(kTile, valid - q0);  // > 0: the grid has no tile past S
  const int need = q0 + rows;               // positions whose seg is read
  for (int t = tid; t < need; t += kThreads) {
    s_seg[t] = seg[bh * nc * Q + pos0 + t];
    s_dt[t] = dt[(bS + pos0 + t) * nh + h];
  }

  // C_q^T [ds][64] of this query tile, from pass 1
  const float* ctq = ct + ((static_cast<long long>(b) * nc + c) * tiles + rt) *
                              ds * kTile;
  const long long hd_ds = static_cast<long long>(hd) * ds;
  const float* st0 = state + bh * nc * hd_ds;  // S_0 .. S_{nc-2} of the head
  const float* tot = total + bh * nc;
  const int nt = tiles * (tiles + 1) / 2;
  const float* tile0 = scores + ((static_cast<long long>(b) * nc + c) * nt +
                                 rt * (rt + 1) / 2) * kTile * kTile;
  const long long x_stride = static_cast<long long>(nh) * hd;
  const int n_inter = c > 0 ? (ds + kTile - 1) / kTile : 0;
  const int n_stages = n_inter + rt + 1;
  constexpr int kW = kVec ? 4 : 1;
  auto issue = [&](int st) {
    if (st < n_inter) {
      const int d0 = st * kTile, dn = min(kTile, ds - d0);
      fill_rows<true, kTile>(a, ctq + d0 * kTile, kTile, dn, kTile);
      // H_in[d][p] of the slice: H = exp(total_cc) H + S_cc over the
      // chunks before this one, rounded as two operations (the plain
      // version's state pass), accumulated in place on fill_rows'
      // elements of the thread, each chunk's loads issued together
#pragma unroll
      for (int e = tid; e < kTile * kTile / kW; e += kThreads) {
        const int row = e / (kTile / kW), col = (e % (kTile / kW)) * kW;
#pragma unroll
        for (int u = 0; u < kW; ++u) bb[row * kPitch + col + u] = 0.f;
      }
      for (int cc = 0; cc < c; ++cc) {
        const float ge = expf(tot[cc]);
        const float* sl = st0 + cc * hd_ds + static_cast<long long>(d0) * hd;
#pragma unroll
        for (int e = tid; e < kTile * kTile / kW; e += kThreads) {
          const int row = e / (kTile / kW), col = (e % (kTile / kW)) * kW;
          if (row < dn && col < hd) {
            float* hp = &bb[row * kPitch + col];
            if constexpr (kVec) {
              const float4 v = ld4(sl + row * hd + col);
              const float4 o = ld4(hp);
              st4(hp, make_float4(__fadd_rn(__fmul_rn(ge, o.x), v.x),
                                  __fadd_rn(__fmul_rn(ge, o.y), v.y),
                                  __fadd_rn(__fmul_rn(ge, o.z), v.z),
                                  __fadd_rn(__fmul_rn(ge, o.w), v.w)));
            } else {
              *hp = __fadd_rn(__fmul_rn(ge, *hp), sl[row * hd + col]);
            }
          }
        }
      }
    } else {
      const int kt = st - n_inter, k0 = kt * kTile;
      fill_rows<true, kTile>(
          a, tile0 + static_cast<long long>(kt) * kTile * kTile, kTile, kTile,
          kTile);
      fill_rows<kVec, kTile>(
          bb, x + (bS + pos0 + k0) * x_stride + static_cast<long long>(h) * hd,
          x_stride, min(kTile, valid - k0), hd);
    }
    cp_async_commit();
  };

  // the last query row of this thread's warp (rows 16 w .. 16 w + 15)
  const int warp_last = q0 + 16 * (tid >> 5) + 15;
  float acc[8][4] = {};
  for (int st = 0; st < n_stages; ++st) {
    issue(st);
    cp_async_wait<0>();
    const int k0 = (st - n_inter) * kTile;
    const int keys = min(kTile, valid - k0);
    if (st == 0) __syncthreads();  // s_seg and s_dt
    if (st >= n_inter && k0 < q0) {
      // a key tile wholly below the diagonal (every j < every i):
      // M = scores * exp(seg_i - p) * (exp(p - seg_j) dt_j) with p the
      // tile's last seg, both exponents <= 0 (seg falls along the chunk),
      // so neither factor overflows; 12 exps a thread instead of 32.
      // The elements this thread copied (fill_rows<true>' map): rows
      // i0 .. i0 + 3 against keys j = tid / 16 + 8 n
      const float p = s_seg[k0 + kTile - 1];
      const int i0 = (tid & 15) * 4;
      float ei[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ei[u] = i0 + u < rows ? expf(s_seg[q0 + i0 + u] - p) : 0.f;
      }
#pragma unroll
      for (int e = tid; e < kTile * kTile / 4; e += kThreads) {
        const int j = e >> 4;
        const float ej = expf(p - s_seg[k0 + j]) * s_dt[k0 + j];
        float* m = &a[j * kPitch + i0];
#pragma unroll
        for (int u = 0; u < 4; ++u) m[u] = m[u] * ei[u] * ej;
      }
    } else if (st >= n_inter) {
      // the diagonal tile: M = scores * exp(seg_i - seg_j) * dt_j on
      // j <= i, masked before the exp (above the diagonal the exponent
      // is large and positive)
#pragma unroll
      for (int e = tid; e < kTile * kTile / 4; e += kThreads) {
        const int j = e >> 4, i0 = (e & 15) * 4;
        const bool key = j < keys;
        const float segk = key ? s_seg[k0 + j] : 0.f;
        const float dtk = key ? s_dt[k0 + j] : 0.f;
        float* m = &a[j * kPitch + i0];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          const bool keep = key && i < rows && k0 + j <= q0 + i;
          m[u] = keep ? m[u] * expf(s_seg[q0 + i] - segk) * dtk : 0.f;
        }
      }
    }
    __syncthreads();
    if (st < n_inter) {
      // inter-chunk: y_i = exp(seg_i) sum_d C[i][d] H_in[d][p]
      tile_product(acc, a, bb, min(kTile, ds - st * kTile));
      if (st == n_inter - 1) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = 8 * ty + r;
          const float ge = i < rows ? expf(s_seg[q0 + i]) : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] *= ge;
        }
      }
    } else {
      // y += M x over the keys this warp's rows can see
      tile_product(acc, a, bb, min(keys, warp_last - k0 + 1));
    }
    __syncthreads();
  }
  store_tile(y, acc, bS + pos0 + q0, rows, nh, h, hd);
}

// grid (ceil(S / 64), nh, B), a scan of one chunk (S <= Q): one CTA per 64
// query rows of one head, alone on the stream.  It sums the chunk's seg
// itself in pass 1's order and computes the score tiles C_q B_k^T of its
// key tiles (held as rows 8 ty + r against keys tx + 16 k), then M x
// as ssd_tile_output_kernel does.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
ssd_one_chunk_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ Bm,
                     const float* __restrict__ C,
                     float* __restrict__ y,
                     int S, int nh, int hd, int ds) {
  __shared__ __align__(16) float s_a[kTile * kPitch];  // C^T [d][i], M^T [j][i]
  __shared__ __align__(16) float s_b[kTile * kPitch];  // B^T [d][j], x [j][p]
  __shared__ float s_seg[kMaxChunk];
  __shared__ float s_w[kMaxChunk];

  const int rt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long bS = static_cast<long long>(b) * S;
  const int q0 = rt * kTile;
  const int rows = min(kTile, S - q0);
  const int need = q0 + rows;
  const float* Cq = C + (bS + q0) * ds;
  // the first score slice's copies fly during the sum below
  fill_transposed<kTile>(s_a, Cq, ds, rows, min(kTile, ds));
  fill_transposed<kTile>(s_b, Bm + bS * ds, ds, min(kTile, S), min(kTile, ds));
  cp_async_commit();
  // pass 1's sum, in its order
  for (int t = tid; t < need; t += kThreads) {
    s_w[t] = __fmul_rn(dt[(bS + t) * nh + h], A[h]);
  }
  __syncthreads();
  if (tid == 0) in_order_sum<kMaxChunk>(s_w, s_seg, need);
  __syncthreads();

  const long long x_stride = static_cast<long long>(nh) * hd;
  const int warp_last = q0 + 16 * (tid >> 5) + 15;
  float acc[8][4] = {};
  for (int kt = 0; kt <= rt; ++kt) {
    const int k0 = kt * kTile;
    const int keys = min(kTile, S - k0);
    float sc[8][4] = {};
    for (int d0 = 0; d0 < ds; d0 += kTile) {
      const int dn = min(kTile, ds - d0);
      if (kt > 0 || d0 > 0) {
        fill_transposed<kTile>(s_a, Cq + d0, ds, rows, dn);
        fill_transposed<kTile>(s_b, Bm + (bS + k0) * ds + d0, ds, keys, dn);
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < dn; ++d) {
        const float4 a0 = ld4(&s_a[d * kPitch + 8 * ty]);
        const float4 a1 = ld4(&s_a[d * kPitch + 8 * ty + 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float bk = s_b[d * kPitch + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 8; ++r) sc[r][k] = fmaf(av[r], bk, sc[r][k]);
        }
      }
      __syncthreads();
    }
    fill_rows<kVec, kTile>(
        s_b, x + (bS + k0) * x_stride + static_cast<long long>(h) * hd,
        x_stride, keys, hd);
    // M = scores * exp(seg_i - seg_j) * dt_j on j <= i, masked before the
    // exp, stored as M^T [j][i]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = tx + 16 * k;
      const bool key = j < keys;
      const float segk = key ? s_seg[k0 + j] : 0.f;
      const float dtk = key ? dt[(bS + k0 + j) * nh + h] : 0.f;
      float m[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = 8 * ty + r;
        const bool keep = key && i < rows && k0 + j <= q0 + i;
        m[r] = keep ? sc[r][k] * expf(s_seg[q0 + i] - segk) * dtk : 0.f;
      }
      st4(&s_a[j * kPitch + 8 * ty], make_float4(m[0], m[1], m[2], m[3]));
      st4(&s_a[j * kPitch + 8 * ty + 4], make_float4(m[4], m[5], m[6], m[7]));
    }
    cp_async_wait_all();
    __syncthreads();
    tile_product(acc, s_a, s_b, min(keys, warp_last - k0 + 1));
    __syncthreads();
  }
  store_tile(y, acc, bS + q0, rows, nh, h, hd);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kVec>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* C, float* y, float* seg, float* total, float* state,
           float* scores, float* ct, int B, int S, int nh, int hd, int ds,
           int Q, cudaStream_t s) {
  const int nc = (S + Q - 1) / Q;
  if (nc == 1) {
    ssd_one_chunk_kernel<kVec>
        <<<dim3((S + kTile - 1) / kTile, nh, B), kThreads, 0, s>>>(
            x, dt, A, Bm, C, y, S, nh, hd, ds);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = (Q + kTile - 1) / kTile;
  const int nt = tiles * (tiles + 1) / 2;
  const int groups = (ds + kTile - 1) / kTile;
  if (nh * groups + nt > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ssd_chunk_state_kernel<kVec><<<dim3(nc, nh * groups + nt, B), kThreads, 0,
                                 s>>>(x, dt, A, Bm, C, seg, total, state,
                                      scores, ct, S, nh, hd, ds, Q, nt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // every chunk's tiles but those of the last chunk wholly past S
  const int last = S - (nc - 1) * Q;
  const int out_tiles = (nc - 1) * tiles + (last + kTile - 1) / kTile;
  ssd_tile_output_kernel<kVec>
      <<<dim3(out_tiles, nh, B), kThreads, 0, s>>>(
          x, dt, ct, seg, scores, state, total, y, S, nh, hd, ds, Q, tiles,
          nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, S, nh, hd], dt [B, S, nh], A [nh], Bm and C [B, S, ds], y
// [B, S, nh, hd], all f32 and contiguous.  With nc = ceil(S / Q) > 1 the
// scratch seg [B, nh, nc Q], total [B, nh, nc], state [B, nh, nc, ds, hd]
// scores [B, nc, nt, 64, 64] (nt = T (T + 1) / 2, T = ceil(Q / 64)) and
// ct [B, nc, T, ds, 64], each 16-byte aligned; with nc == 1 none is read
// and each may be null.  Two kernels on
// ``stream`` (one when nc == 1); returns the first launch error (0 if
// none).
extern "C" int launch_ssd_scan(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* C, void* y,
                               void* seg, void* total, void* state,
                               void* scores, void* ct, int B, int S, int nh,
                               int hd, int ds, int Q, void* stream) {
  if (B < 1 || S < 1 || nh < 1 || hd < 1 || ds < 1 || Q < 1 ||
      B > 65535 || nh > 65535 || Q > kMaxChunk || hd > kMaxHd ||
      ds > kMaxDs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = hd % 4 == 0 && ds % 4 == 0 && aligned16(x) &&
                   aligned16(Bm) && aligned16(C);
  auto run = vec ? launch<true> : launch<false>;
  return run(static_cast<const float*>(x), static_cast<const float*>(dt),
             static_cast<const float*>(A), static_cast<const float*>(Bm),
             static_cast<const float*>(C), static_cast<float*>(y),
             static_cast<float*>(seg), static_cast<float*>(total),
             static_cast<float*>(state), static_cast<float*>(scores),
             static_cast<float*>(ct), B, S, nh, hd, ds, Q,
             static_cast<cudaStream_t>(stream));
}
