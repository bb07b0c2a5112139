// Flash attention backward for Hopper (sm_90a): the gradients of K3
// (flash_attention.cu) with respect to q, k and v.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, and
// XLA differentiates the jnp twin of its flash kernel,
// src/repro/models/layers.py chunked_attention.  This is that autodiff,
// written as FlashAttention-2's backward [arXiv:2307.08691 Alg. 2], which
// is deterministic and needs no atomics:
//
//   delta_kernel    D[b, h, i] = sum_c dO[i, c] O[i, c]            (f32)
//   dkdv kernels    one CTA per (batch, kv head, block of keys): for every
//                   q head of its group and every query tile that sees
//                   the block, P = exp(S - LSE) recomputed from the
//                   forward's saved log-sum-exp, dV += P^T dO,
//                   dS = P (dO V^T - D), dK += dS^T Q; dK and dV written
//                   once, in the inputs' dtype
//   dq kernels      one CTA per (batch, q head, block of queries): over
//                   the key tiles its rows see, dQ += dS K
//
// Layouts are K3's: q [B, H, Sq, hd], k/v [B, KV, Sk, hd] (q head h reads
// kv head h / (H / KV)), o and dO [B, H, Sq, hd], lse f32 [B, H, Sq]
// contiguous; dq, dk, dv like q, k, v; every tensor through the element
// strides it is given, with a unit last stride.  The mask is the
// forward's: row i at absolute position qp = q_offset + i keeps key j
// when j < Sk, (!causal || j <= qp) and (window == 0 || qp - j < window).
// A row that keeps no key (window > 0 and qp >= Sk + window - 1) took the
// mean of V in the forward, with score 0 for every key, a constant: its
// P is 1 / Sk on every key, so it adds P dO to every key's dV, and its dS
// is 0, so it adds nothing to dQ or dK (what autodiff of the plain
// version, whose masked logits are the constant NEG_INF, gives).  The
// model never makes such a row.
//
// Precision: S, dP and every sum in f32; P and dS rounded once to bf16 as
// the A operand of a tensor-core product (FlashAttention-2's choice);
// gradients rounded once to the inputs' dtype.  f32 inputs stay on the
// CUDA cores in f32 throughout.
//
// Bound: 5 products of 2 Sq Sk hd operations per (batch, q head) (S, dP,
// dV, dK, dQ), halved by a causal mask: compute-bound at the training
// shapes (internlm2, B 4 x S 2,048, hd 128: 172 GFLOP, 0.174 ms at bf16's
// 989 TFLOP/s).  The split below executes seven (the dQ kernel recomputes
// S and dP: 241 GFLOP there) and needs no atomics.
//
// Routes (the wrapper's bwd_route names one; each launches D, then dK/dV,
// then dQ):
//   wgmma (bf16 at hd 64 and 128; internlm2, granite-moe, whisper,
//     stablelm, zamba2's shared block).  FlashAttention-3's products on
//     Hopper's warpgroup MMA, with FlashAttention-2's deterministic split
//     kept.  A CTA is two consumer warpgroups of 64 rows each and a
//     producer warpgroup whose thread 0 issues every TMA copy and whose
//     registers go to the consumers (setmaxnreg: 24 and 240 a thread,
//     FlashAttention-3's split; the launch gives 168) (4-D tensor maps
//     over the [B, heads, S, hd] strides, 128-byte swizzle, rows past S
//     read as zeros) into a 3-stage ring with full/empty mbarriers; no
//     CTA-wide barrier in the loop.
//     - dkdv_wgmma_kernel, one CTA per (128 keys, kv head, batch): K and
//       V stay in shared memory; (Q, dO, LSE, D) tiles of 64 queries of
//       the group's q heads stream through the ring.  S^T = K Q^T and dP^T
//       = V dO^T are m64n64k16 products with both operands in shared
//       memory (keys as M); P^T and dS^T, rounded to bf16 in the
//       accumulator layout, are register A operands of dV += P^T dO and
//       dK += dS^T Q (m64n{hd}k16, dO and Q read MN-major through the
//       same swizzled tiles).  S^T and dP^T are two commit groups, so the
//       exponentials run while dP^T is in flight, and dV is issued as
//       soon as P is packed, so that dS's work runs under it.  (Keeping
//       a tile's dV and dK in flight over the next tile's S^T and dP^T
//       needs more registers than ptxas gives a consumer thread at hd
//       128, which then serializes every wgmma.)
//     - dq_wgmma_kernel, one CTA per (128 query rows, q head, batch): Q
//       and dO stay; (K, V) tiles of 64 keys stream.  S = Q K^T, dP = dO
//       V^T, and dQ += dS K with K read MN-major through a descriptor, no
//       transposed copy.  Three warpgroups a CTA: dQ needs half dK and
//       dV's registers, and more warpgroups cover more of each other's
//       exponentials.
//     Load balance: the block index is the slowest grid dimension and the
//     heaviest causal blocks launch first (key block 0 for dK/dV, the
//     last query block for dQ), so the light blocks fill the tail; at
//     train-internlm2's microbatch (B 2) the grids are 256 (dK/dV: 384
//     threads, 164 KB of shared memory at hd 128) and 352 CTAs (dQ: 512
//     threads, 193 KB), one a SM.  A warpgroup
//     whose keys (or rows) no row of a tile sees skips the tile's
//     products.  Each warpgroup stages its gradient rows, row-swizzled,
//     in its own K (or Q) tile and stores them 16 bytes a thread.
//   mma (bf16 at every other hd: MLA's 192, gemma3's 256, the narrow
//     smoke widths), the first design's kernels: mma.sync m16n8k16 with f32
//     accumulators (mma.cuh).  A warp owns 16 rows (dq: query rows;
//     dkdv: keys) and, at hd 256, half the columns of the gradient it
//     accumulates (two warps a row block): a 64-key warpgroup holding dK
//     and dV at hd 256 would need about 256 f32 registers a thread.  dkdv
//     keeps K and V of 64 keys in shared memory and streams query tiles
//     of 32 rows through a 2-stage cp.async ring; dq keeps Q and dO of 64
//     rows and streams K/V tiles of 64 keys (32 at hd 256); K through
//     ldmatrix.trans.
//   f32 (the train-reference check's f32 runs): the same passes on the
//     CUDA cores, 8 warps a CTA, blocks of 32 keys and 32 queries staged
//     in shared memory as f32 (rows padded by 4 floats); a lane scores
//     one (row, key) pair per warp row, the gradient sums run over float4
//     columns per lane.

#include <math_constants.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using repro_torch::bulk_load;
using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait_group;
using repro_torch::fence_regs;
using repro_torch::ldmatrix_x4;
using repro_torch::ldmatrix_x4_trans;
using repro_torch::load8;
using repro_torch::mbar_arrive;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_init;
using repro_torch::mbar_init_fence;
using repro_torch::mbar_wait;
using repro_torch::mma_bf16;
using repro_torch::named_barrier;
using repro_torch::pack_bf16_rn;
using repro_torch::setmaxnreg_dec;
using repro_torch::setmaxnreg_inc;
using repro_torch::smem_desc;
using repro_torch::smem_u32;
using repro_torch::Strides;
using repro_torch::tma_load4;
using repro_torch::wgmma_commit;
using repro_torch::wgmma_fence;
using repro_torch::wgmma_rs_m64n128k16;
using repro_torch::wgmma_rs_m64n64k16;
using repro_torch::wgmma_ss_m64n64k16;
using repro_torch::wgmma_wait;

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxHd = 256;
constexpr int kMaxDevices = 64;

// 4-byte global->shared copy; with ``full`` false it writes 4 zero bytes
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

// The forward's mask.  Kept keys of the row at absolute position qp are
// [lo(qp), hi(qp)]; the row keeps none (and took the mean of V) iff
// lo > hi, which happens only with a window, for qp >= Sk + window - 1.
struct Mask {
  int Sk, causal, window, q_offset;
  __device__ __forceinline__ int lo(int qp) const {
    return window > 0 ? max(0, qp - window + 1) : 0;
  }
  __device__ __forceinline__ int hi(int qp) const {
    return causal ? min(qp, Sk - 1) : Sk - 1;
  }
  __device__ __forceinline__ bool empty(int qp) const {
    return window > 0 && qp >= Sk + window - 1;
  }
  // (keep, score-is-the-constant-0) of the pair (qp, key), key < Sk
  __device__ __forceinline__ bool keep(int qp, int key) const {
    return key < Sk && (empty(qp) || (key >= lo(qp) && key <= hi(qp)));
  }
};

// --------------------------------------------------------------------- D
// D = sum_c dO[., c] O[., c] for row i of (batch, head) bh at delta[bh *
// pitch + i]; with ``lse2`` (the wgmma route) also LSE log2(e) at
// lse2[bh * pitch + i], and rows Sq <= i < pitch (the padding of a 64-row
// tile) zero in both.  A row is LPR lanes of 8 elements each (LPR the
// power of two that covers hd / 8), so that a warp takes 32 / LPR rows.
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
             float* __restrict__ lse2, int H, int Sq, int pitch, int hd,
             int lpr, Strides os, Strides ds, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row = (static_cast<long long>(blockIdx.x) * 8 +
                         (threadIdx.x >> 5)) * (32 / lpr) + lane / lpr;
  const int sub = lane % lpr;
  float sum = 0.f;
  const bool in_row = row < rows && static_cast<int>(row % pitch) < Sq;
  if (in_row) {
    const int i = static_cast<int>(row % pitch);
    const long long bh = row / pitch;
    const int h = static_cast<int>(bh % H);
    const int b = static_cast<int>(bh / H);
    const T* orow = o + b * os.b + h * os.h + i * os.s;
    const T* drow = dout + b * ds.b + h * ds.h + i * ds.s;
    for (int c = sub * 8; c < hd; c += 8 * lpr) {
      float x[8], y[8];
      load8(orow + c, x);
      load8(drow + c, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum = fmaf(x[e], y[e], sum);
    }
  }
  for (int off = lpr / 2; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (sub == 0 && row < rows) {
    const int i = static_cast<int>(row % pitch);
    delta[row] = in_row ? sum : 0.f;
    if (lse2 != nullptr) {
      lse2[row] = in_row ? lse[row / pitch * Sq + i] * kLog2e : 0.f;
    }
  }
}

// ------------------------------------------------------------ bf16 MMA
constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row
constexpr int kRowsPerCta = 64;  // dkdv: keys a CTA; dq: query rows a CTA
constexpr int kQTile = 32;       // dkdv: query rows a streamed tile

// column parts a row block is split into (a warp each): 2 at hd 256
__host__ __device__ constexpr int col_split(int hdp) {
  return hdp > 128 ? 2 : 1;
}
// dq's key tile: 64 keys, 32 at hd 256
__host__ __device__ constexpr int dq_key_tile(int hdp) {
  return hdp > 128 ? 32 : 64;
}

__host__ __device__ constexpr int dkdv_smem(int hdp) {
  return (2 * kRowsPerCta + 2 * 2 * kQTile) * (hdp + kPad) * 2 +
         2 * 2 * kQTile * 4;
}
__host__ __device__ constexpr int dq_smem(int hdp) {
  return (2 * kRowsPerCta + 2 * 2 * dq_key_tile(hdp)) * (hdp + kPad) * 2;
}

// ldmatrix lane offsets (elements, pitch P): A fragments of 16 rows ``a``;
// B fragments from a row-major [N rows, K cols] tile ``b`` (rows are the
// product's columns); B fragments from a row-major [K rows, N cols] tile,
// transposed on the way, ``bt``
struct Lanes {
  int a, b, bt;
  __device__ __forceinline__ Lanes(int lane, int P)
      : a((lane & 15) * P + (lane >> 4) * 8),
        b(((lane & 7) + 8 * (lane >> 4)) * P + ((lane >> 3) & 1) * 8),
        bt((lane & 15) * P + (lane >> 4) * 8) {}
};

// C[NT][4] (16 rows x 8 NT cols) = A rows (16 x HDP at ``a``) times the
// transpose of the row-major [8 NT, HDP] tile at ``b``: the S-type product
template <int HDP, int NT>
__device__ __forceinline__ void product_abt(float (&c)[NT][4], const bf16* a,
                                            const bf16* b, int P) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  }
#pragma unroll
  for (int kt = 0; kt < HDP / 16; ++kt) {
    uint32_t af[4];
    ldmatrix_x4(af, a + kt * 16);
    uint32_t bf[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      ldmatrix_x4(bf[n], b + n * 16 * P + kt * 16);
    }
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      mma_bf16(c[2 * n], af, bf[n][0], bf[n][1]);
      mma_bf16(c[2 * n + 1], af, bf[n][2], bf[n][3]);
    }
  }
}

// acc[DW][4] (16 rows x 8 DW cols) += X (16 x 8 NT, C fragments, rounded to
// bf16 as A fragments) times the row-major [8 NT, *] tile at ``bt``
// (lane offset included), columns [0, 8 DW) from there
template <int NT, int DW>
__device__ __forceinline__ void product_xb(float (&acc)[DW][4],
                                           const float (&x)[NT][4],
                                           const bf16* bt, int P) {
  constexpr int VG = DW / 2 < 4 ? DW / 2 : 4;  // fragments loaded at once
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t a[4];
    a[0] = pack_bf16_rn(x[2 * j][0], x[2 * j][1]);
    a[1] = pack_bf16_rn(x[2 * j][2], x[2 * j][3]);
    a[2] = pack_bf16_rn(x[2 * j + 1][0], x[2 * j + 1][1]);
    a[3] = pack_bf16_rn(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
    for (int d0 = 0; d0 < DW; d0 += 2 * VG) {
      uint32_t vb[VG][4];
#pragma unroll
      for (int u = 0; u < VG; ++u) {
        ldmatrix_x4_trans(vb[u], bt + j * 16 * P + (d0 + 2 * u) * 8);
      }
#pragma unroll
      for (int u = 0; u < VG; ++u) {
        mma_bf16(acc[d0 + 2 * u], a, vb[u][0], vb[u][1]);
        mma_bf16(acc[d0 + 2 * u + 1], a, vb[u][2], vb[u][3]);
      }
    }
  }
}

// 16 rows x 8 DW columns of f32 accumulators, times ``mul``, rounded to
// bf16 into shared memory at ``dst`` (the warp's first row and column)
template <int DW>
__device__ __forceinline__ void stage_rows(bf16* dst,
                                           const float (&acc)[DW][4],
                                           float mul, int P, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int d = 0; d < DW; ++d) {
    const int c = d * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(dst + g * P + c) =
        pack_bf16_rn(acc[d][0] * mul, acc[d][1] * mul);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * P + c) =
        pack_bf16_rn(acc[d][2] * mul, acc[d][3] * mul);
  }
}

// rows [0, n) of a staged [rows, hd] tile to global, 16 bytes a copy
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           const bf16* src, int P, int n,
                                           int hd) {
  const int chunks = hd / 8;
  for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * stride + c) =
        *reinterpret_cast<const uint4*>(src + r * P + c);
  }
}

// rows [0, n) and columns [0, hd) of a [rows, HDP] tile from global into
// shared memory by cp.async; the rest zero-filled
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int rows, int n,
                                          int hd, int P, int tid,
                                          int threads, int chunks) {
  for (int i = tid; i < rows * chunks; i += threads) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    const bool in = r < n && c < hd;
    cp_async16(dst + r * P + c, in ? src + r * stride + c : src, in);
  }
}

// One CTA per (block of 64 keys, kv head, batch); 4 CS warps.
template <int HDP>
__global__ void __launch_bounds__(128 * col_split(HDP))
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int H, int KV, int Sq, int Sk, int hd,
                Strides qs, Strides ks, Strides vs, Strides dos,
                Strides dks, Strides dvs, Mask mask, float scale) {
  constexpr int CS = col_split(HDP);
  constexpr int P = HDP + kPad;
  constexpr int NT = kQTile / 8;          // S^T n-tiles (queries)
  constexpr int DW = HDP / 8 / CS;        // gradient n-tiles of a warp
  constexpr int CH = HDP / 8;             // 16-byte chunks of a row
  constexpr int STAGE = 2 * kQTile * P;   // Q tile, then dO tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRowsPerCta * P;
  bf16* ring = sV + kRowsPerCta * P;
  float* sStat = reinterpret_cast<float*>(ring + 2 * STAGE);  // [2][2][32]

  const int k0 = blockIdx.x * kRowsPerCta;  // the heaviest blocks first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wk = warp % 4;   // the warp's 16 keys
  const int cs = warp / 4;   // its column part
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int nk = min(kRowsPerCta, Sk - k0);
  const int k_last = k0 + nk - 1;
  const Lanes ln(lane, P);

  // query rows that see a key of the block: from the first row whose
  // position reaches k0 (causal) to the last within the window of the
  // block's last key, or to Sq - 1 where rows keeping no key exist
  int i_lo = mask.causal ? max(0, k0 - mask.q_offset) : 0;
  int i_hi = Sq - 1;
  if (mask.window > 0 && !mask.empty(mask.q_offset + Sq - 1)) {
    i_hi = min(Sq - 1, k_last + mask.window - 1 - mask.q_offset);
  }
  const int qt_lo = i_lo / kQTile;
  const int n_qt = i_lo <= i_hi ? i_hi / kQTile - qt_lo + 1 : 0;
  const int items = G * n_qt;

  load_rows(sK, k + b * ks.b + kvh * ks.h + k0 * ks.s, ks.s, kRowsPerCta, nk,
            hd, P, tid, threads, CH);
  load_rows(sV, v + b * vs.b + kvh * vs.h + k0 * vs.s, vs.s, kRowsPerCta, nk,
            hd, P, tid, threads, CH);
  auto load_item = [&](int stage, int item) {
    const int h = kvh * G + item / n_qt;
    const int q0 = (qt_lo + item % n_qt) * kQTile;
    const int nq = min(kQTile, Sq - q0);
    bf16* sq = ring + stage * STAGE;
    load_rows(sq, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, kQTile, nq, hd,
              P, tid, threads, CH);
    load_rows(sq + kQTile * P, dout + b * dos.b + h * dos.h + q0 * dos.s,
              dos.s, kQTile, nq, hd, P, tid, threads, CH);
    const long long row0 = (static_cast<long long>(b) * H + h) * Sq + q0;
    float* st = sStat + stage * 2 * kQTile;
    if (tid < kQTile) {
      cp_async4(st + tid, lse + row0 + (tid < nq ? tid : 0), tid < nq);
      cp_async4(st + kQTile + tid, delta + row0 + (tid < nq ? tid : 0),
                tid < nq);
    }
  };
  if (items > 0) load_item(0, 0);
  cp_async_commit();

  float dk_acc[DW][4], dv_acc[DW][4];
#pragma unroll
  for (int d = 0; d < DW; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;
  }
  const float sl2 = scale * kLog2e;
  const bf16* ka = sK + wk * 16 * P + ln.a;
  const bf16* va = sV + wk * 16 * P + ln.a;
  const int key_base = k0 + wk * 16 + g;  // this thread's keys: + 0, + 8

  for (int it = 0; it < items; ++it) {
    const int stage = it & 1;
    cp_async_wait_group<0>();
    __syncthreads();  // item it has landed; stage ^ 1 is free
    if (it + 1 < items) load_item(stage ^ 1, it + 1);
    cp_async_commit();
    const bf16* sq = ring + stage * STAGE;
    const bf16* sdo = sq + kQTile * P;
    const float* st = sStat + stage * 2 * kQTile;
    const int q0 = (qt_lo + it % n_qt) * kQTile;
    const int qp0 = mask.q_offset + q0;
    const int qp_last = qp0 + kQTile - 1;
    // no row of the tile masks a key of the block: every row is real and
    // keeps a range that covers the block's 64 keys
    const bool masked = q0 + kQTile > Sq || nk < kRowsPerCta ||
                        mask.empty(qp_last) || mask.lo(qp_last) > k0 ||
                        mask.hi(qp0) < k0 + kRowsPerCta - 1;

    float s[NT][4], dp[NT][4];
    product_abt<HDP, NT>(s, ka, sq + ln.b, P);     // S^T = K Q^T
    product_abt<HDP, NT>(dp, va, sdo + ln.b, P);   // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);  // query in the tile
        const int key = key_base + 8 * (e >> 1);
        const int qp = qp0 + col;
        const float lse2 = st[col] * kLog2e;
        float p, ds;
        if (!masked) {
          p = exp2f(s[n][e] * sl2 - lse2);
          ds = p * (dp[n][e] - st[kQTile + col]);
        } else if (q0 + col < Sq && mask.keep(qp, key)) {
          const bool empty = mask.empty(qp);
          p = exp2f((empty ? 0.f : s[n][e] * sl2) - lse2);
          ds = empty ? 0.f : p * (dp[n][e] - st[kQTile + col]);
        } else {
          p = 0.f;
          ds = 0.f;
        }
        s[n][e] = p;
        dp[n][e] = ds;
      }
    }
    // dV += P^T dO and dK += dS^T Q over this warp's columns
    product_xb<NT, DW>(dv_acc, s, sdo + ln.bt + cs * DW * 8, P);
    product_xb<NT, DW>(dk_acc, dp, sq + ln.bt + cs * DW * 8, P);
  }
  cp_async_wait_group<0>();
  __syncthreads();  // every warp is done with sK and sV
  stage_rows<DW>(sK + wk * 16 * P + cs * DW * 8, dk_acc, scale, P, lane);
  stage_rows<DW>(sV + wk * 16 * P + cs * DW * 8, dv_acc, 1.f, P, lane);
  __syncthreads();
  store_rows(dk + b * dks.b + kvh * dks.h + k0 * dks.s, dks.s, sK, P, nk, hd);
  store_rows(dv + b * dvs.b + kvh * dvs.h + k0 * dvs.s, dvs.s, sV, P, nk, hd);
}

// One CTA per (q head, block of 64 query rows, batch); 4 CS warps.
template <int HDP>
__global__ void __launch_bounds__(128 * col_split(HDP))
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int H, int KV, int Sq, int Sk, int hd,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
              Mask mask, float scale) {
  constexpr int CS = col_split(HDP);
  constexpr int BK = dq_key_tile(HDP);
  constexpr int P = HDP + kPad;
  constexpr int NT = BK / 8;
  constexpr int DW = HDP / 8 / CS;
  constexpr int CH = HDP / 8;
  constexpr int STAGE = 2 * BK * P;  // K tile, then V tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kRowsPerCta * P;
  bf16* ring = sdO + kRowsPerCta * P;

  // the heaviest causal blocks (the last rows) of every head first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsPerCta;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wq = warp % 4;
  const int cs = warp / 4;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int nq = min(kRowsPerCta, Sq - q0);
  const Lanes ln(lane, P);

  const int qp_first = mask.q_offset + q0;
  const int qp_last = qp_first + nq - 1;
  const bool any_empty = mask.empty(qp_last);
  const int k_lo = any_empty ? 0 : mask.lo(qp_first);
  const int k_hi = any_empty ? Sk - 1 : mask.hi(qp_last);
  const int all_lo = mask.lo(qp_last);
  const int all_hi = mask.hi(qp_first);

  // this thread's two rows: g and g + 8 of its warp's 16
  float lse2[2], dl[2];
  bool empty[2];
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq + q0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wq * 16 + g + 8 * i;
    const bool in = r < nq;
    lse2[i] = in ? lse[row0 + r] * kLog2e : 0.f;
    dl[i] = in ? delta[row0 + r] : 0.f;
    empty[i] = mask.empty(qp_first + r);
  }

  load_rows(sQ, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, kRowsPerCta, nq,
            hd, P, tid, threads, CH);
  load_rows(sdO, dout + b * dos.b + h * dos.h + q0 * dos.s, dos.s,
            kRowsPerCta, nq, hd, P, tid, threads, CH);
  const bf16* kbase = k + b * ks.b + kvh * ks.h;
  const bf16* vbase = v + b * vs.b + kvh * vs.h;
  auto load_kv = [&](int stage, int kb0) {
    bf16* sk = ring + stage * STAGE;
    const int n = min(BK, Sk - kb0);
    load_rows(sk, kbase + kb0 * ks.s, ks.s, BK, n, hd, P, tid, threads, CH);
    load_rows(sk + BK * P, vbase + kb0 * vs.s, vs.s, BK, n, hd, P, tid,
              threads, CH);
  };
  const int t_first = k_lo / BK;
  const int t_last = k_hi / BK;
  if (t_first <= t_last) load_kv(0, t_first * BK);
  cp_async_commit();

  float dq_acc[DW][4];
#pragma unroll
  for (int d = 0; d < DW; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[d][e] = 0.f;
  }
  const float sl2 = scale * kLog2e;
  const bf16* qa = sQ + wq * 16 * P + ln.a;
  const bf16* doa = sdO + wq * 16 * P + ln.a;

  for (int t = t_first, it = 0; t <= t_last; ++t, ++it) {
    const int stage = it & 1;
    cp_async_wait_group<0>();
    __syncthreads();  // tile t has landed; stage ^ 1 is free
    if (t + 1 <= t_last) load_kv(stage ^ 1, (t + 1) * BK);
    cp_async_commit();
    const bf16* sk = ring + stage * STAGE;
    const bf16* sv = sk + BK * P;
    const int kb0 = t * BK;
    const bool masked = any_empty || kb0 < all_lo || kb0 + BK - 1 > all_hi;

    float s[NT][4], dp[NT][4];
    product_abt<HDP, NT>(s, qa, sk + ln.b, P);    // S = Q K^T
    product_abt<HDP, NT>(dp, doa, sv + ln.b, P);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = kb0 + n * 8 + 2 * t4 + (e & 1);
        float ds;
        if (!masked) {
          ds = exp2f(s[n][e] * sl2 - lse2[i]) * (dp[n][e] - dl[i]);
        } else {
          const int qp = qp_first + wq * 16 + g + 8 * i;
          ds = (!empty[i] && mask.keep(qp, key))
                   ? exp2f(s[n][e] * sl2 - lse2[i]) * (dp[n][e] - dl[i])
                   : 0.f;
        }
        s[n][e] = ds;
      }
    }
    // dQ += dS K over this warp's columns
    product_xb<NT, DW>(dq_acc, s, sk + ln.bt + cs * DW * 8, P);
  }
  cp_async_wait_group<0>();
  __syncthreads();  // every warp is done with sQ
  stage_rows<DW>(sQ + wq * 16 * P + cs * DW * 8, dq_acc, scale, P, lane);
  __syncthreads();
  store_rows(dq + b * dqs.b + h * dqs.h + q0 * dqs.s, dqs.s, sQ, P, nq, hd);
}

// set a kernel's dynamic shared-memory limit once per device
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && allowed[dev]) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) allowed[dev] = true;
  return 0;
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *dq, *dk, *dv, *delta;
  int B, H, KV, Sq, Sk, hd;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  Mask mask;
  float scale;
  cudaStream_t stream;
};

// D (and, with ``lse2``, LSE log2(e)) at a row pitch of ``pitch``
template <typename T>
int launch_delta(const Args& a, float* delta, float* lse2, int pitch) {
  int lpr = 1;
  while (lpr * 8 < a.hd) lpr *= 2;
  const long long rows = static_cast<long long>(a.B) * a.H * pitch;
  const long long per_block = 8LL * (32 / lpr);
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), delta, lse2, a.H, a.Sq, pitch,
      a.hd, lpr, a.os, a.dos, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_mma(const Args& a) {
  constexpr int threads = 128 * col_split(HDP);
  static bool allowed_kv[kMaxDevices] = {};
  static bool allowed_q[kMaxDevices] = {};
  int err = allow_smem(dkdv_mma_kernel<HDP>, dkdv_smem(HDP), allowed_kv);
  if (err != 0) return err;
  err = allow_smem(dq_mma_kernel<HDP>, dq_smem(HDP), allowed_q);
  if (err != 0) return err;
  const int kblocks = (a.Sk + kRowsPerCta - 1) / kRowsPerCta;
  const int qblocks = (a.Sq + kRowsPerCta - 1) / kRowsPerCta;
  if (qblocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dkdv_mma_kernel<HDP><<<dim3(kblocks, a.KV, a.B), threads, dkdv_smem(HDP),
                         a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.KV, a.Sq,
      a.Sk, a.hd, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.mask, a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dq_mma_kernel<HDP><<<dim3(a.H, qblocks, a.B), threads, dq_smem(HDP),
                       a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dq), a.H, a.KV, a.Sq, a.Sk, a.hd, a.qs, a.ks,
      a.vs, a.dos, a.dqs, a.mask, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// the mma.sync route: D, then the two kernels at the hd template that
// covers a.hd
int launch_mma_route(const Args& a) {
  int err = launch_delta<bf16>(a, static_cast<float*>(a.delta), nullptr,
                               a.Sq);
  if (err != 0) return err;
  if (a.hd <= 16) return launch_mma<16>(a);
  if (a.hd <= 32) return launch_mma<32>(a);
  if (a.hd <= 64) return launch_mma<64>(a);
  if (a.hd <= 128) return launch_mma<128>(a);
  return launch_mma<256>(a);
}

// ----------------------------------------------------------- bf16 wgmma
// The route at hd 64 and 128 (see the note at the top).  A CTA is kKvWgs
// (dkdv) or kQWgs (dq) consumer warpgroups, each owning 64 rows (keys or
// query rows),
// and a producer warpgroup whose thread 0 issues every TMA copy and which
// hands its registers to the consumers (setmaxnreg).  Tiles of 64
// rows x hd are hd / 64 TMA boxes of [64 rows][64] (8 KB each, 128-byte
// swizzle); the same box is read K-major (S-type products, the reduced
// dimension is hd) and MN-major (gradient products, the reduced dimension
// is the tile's rows).
constexpr int kKvWgs = 2;  // dkdv: 64 keys each (dK and dV: 128 registers)
constexpr int kQWgs = 3;   // dq: 64 query rows each (dQ: 64 registers)
constexpr int kKvThreads = 128 * (kKvWgs + 1);
constexpr int kQThreads = 128 * (kQWgs + 1);
// registers a thread keeps after setmaxnreg: the launch gives each thread
// 65536 / threads; the producer keeps 24 and the consumers share the rest,
// rounded down to 8 (240 at most): 240 for dkdv's two warpgroups, 160 for
// dq's three
constexpr int kProducerRegs = 24;
constexpr int kKvRegs = 240;
constexpr int kQRegs = 160;
static_assert(128 * kProducerRegs + 128 * kKvWgs * kKvRegs <= 65536 &&
                  128 * kProducerRegs + 128 * kQWgs * kQRegs <= 65536,
              "the register file is 65536 registers");

// 2^x by the SFU (ex2.approx, about 2 ulps; -inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr int kWgStages = 3;
constexpr int kBox = 8192;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// k16 step kk of a 64-row tile read K-major (reduced over its hd)
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile,
                                           int kk) {
  return smem_desc(tile + (kk >> 2) * kBox + (kk & 3) * 32, 16, 1024);
}

// k16 step kk of a 64-row tile read MN-major (reduced over its rows 16 kk
// .. 16 kk + 15, its hd columns the product's N)
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile,
                                            int kk) {
  return smem_desc(tile + kk * 2048, kBox, 1024);
}

// acc (64 x HD) += A (64 x 16, registers) . tile's 16 rows (MN-major)
template <int HD>
__device__ __forceinline__ void product_rs(float (&acc)[HD / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (HD == 128) {
    wgmma_rs_m64n128k16<1>(acc, a, db, 1);
  } else {
    wgmma_rs_m64n64k16<1>(acc, a, db, 1);
  }
}

// a 64 x 64 accumulator, rounded to bf16, as the A operands of four k16
// steps
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&x)[32]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[k][e] = pack_bf16_rn(x[8 * k + 2 * e], x[8 * k + 2 * e + 1]);
    }
  }
}

// the warpgroup's 64 x HD accumulator times ``mul``, rounded to bf16, into
// ``tile`` row-major with each row's 16-byte pieces swizzled by the row
// (piece c at c ^ (r % 8)), so that neither these writes nor the row reads
// of store_tile collide on banks
template <int HD>
__device__ __forceinline__ void stage_tile(unsigned char* tile,
                                           const float (&acc)[HD / 2],
                                           float mul, int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      const int off = r * HD * 2 + ((j ^ (r & 7)) << 4) + t4 * 4;
      *reinterpret_cast<uint32_t*>(tile + off) = pack_bf16_rn(
          acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
    }
  }
}

// rows [0, n) of a staged tile to global, 16 bytes a copy, by the
// warpgroup's 128 threads
template <int HD>
__device__ __forceinline__ void store_tile(bf16* dst, long long stride,
                                           const unsigned char* tile, int n,
                                           int wt) {
  constexpr int CH = HD / 8;
  for (int i = wt; i < n * CH; i += 128) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(dst + r * stride + c * 8) =
        *reinterpret_cast<const uint4*>(tile + r * HD * 2 +
                                        ((c ^ (r & 7)) << 4));
  }
}

template <int HD>
__host__ __device__ constexpr int wg_tile() { return HD / 64 * kBox; }
template <int HD>
constexpr int dkdv_wg_smem() {
  return 1024 + 2 * kKvWgs * wg_tile<HD>() +
         kWgStages * (2 * wg_tile<HD>() + 1024);
}
template <int HD>
constexpr int dq_wg_smem() {
  return 1024 + 2 * kQWgs * wg_tile<HD>() + kWgStages * 2 * wg_tile<HD>();
}

// One CTA per (block of 64 kKvWgs keys, kv head, batch), block index
// slowest, so that under a causal mask the blocks that see the most query
// tiles start first.  stats: LSE log2(e) [B H][SqP], then D [B H][SqP].
template <int HD>
__global__ void __launch_bounds__(kKvThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mdo,
                  const float* __restrict__ stats, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int H, int KV, int B, int Sq,
                  int Sk, int SqP, Strides dks, Strides dvs, Mask mask,
                  float scale) {
  constexpr int TILE = wg_tile<HD>();
  constexpr int NB = HD / 64;
  constexpr int KS = HD / 16;
  constexpr int STAGE = 2 * TILE + 1024;  // Q, dO, then LSE2 and D
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages];
  __shared__ __align__(8) uint64_t empty[kWgStages];
  __shared__ __align__(8) uint64_t kv_full;
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + kKvWgs * TILE;
  unsigned char* ring = sV + kKvWgs * TILE;

  const int k0 = static_cast<int>(blockIdx.x / (KV * B)) * 64 * kKvWgs;
  const int kvh = blockIdx.x % KV;
  const int b = (blockIdx.x / KV) % B;
  const int G = H / KV;
  const int tid = threadIdx.x;
  // query rows that see a key of the block (dkdv_mma_kernel's range)
  const int k_last = min(k0 + 64 * kKvWgs, Sk) - 1;
  const int i_lo = mask.causal ? max(0, k0 - mask.q_offset) : 0;
  int i_hi = Sq - 1;
  if (mask.window > 0 && !mask.empty(mask.q_offset + Sq - 1)) {
    i_hi = min(Sq - 1, k_last + mask.window - 1 - mask.q_offset);
  }
  const int qt_lo = i_lo / 64;
  const int n_qt = i_lo <= i_hi ? i_hi / 64 - qt_lo + 1 : 0;
  const int items = G * n_qt;  // (q head, query tile), head slowest

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kKvWgs);
    }
    mbar_init(&kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * kKvWgs) {  // the producer warpgroup; one thread issues
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * kKvWgs) {
      const int tiles = min(kKvWgs, (Sk - k0 + 63) / 64);
      mbar_expect_tx(&kv_full, 2 * tiles * TILE);
      for (int w = 0; w < tiles; ++w) {
        for (int nb = 0; nb < NB; ++nb) {
          tma_load4(sK + w * TILE + nb * kBox, &mk, nb * 64, k0 + 64 * w, kvh,
                    b, &kv_full);
          tma_load4(sV + w * TILE + nb * kBox, &mv, nb * 64, k0 + 64 * w, kvh,
                    b, &kv_full);
        }
      }
      const long long plane = static_cast<long long>(B) * H * SqP;
      for (int it = 0; it < items; ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) mbar_wait(&empty[s], ((it / kWgStages) - 1) & 1);
        const int h = kvh * G + it / n_qt;
        const int q0 = (qt_lo + it % n_qt) * 64;
        unsigned char* st = ring + s * STAGE;
        mbar_expect_tx(&full[s], 2 * TILE + 512);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load4(st + nb * kBox, &mq, nb * 64, q0, h, b, &full[s]);
          tma_load4(st + TILE + nb * kBox, &mdo, nb * 64, q0, h, b, &full[s]);
        }
        const float* row = stats + (static_cast<long long>(b) * H + h) * SqP +
                           q0;
        bulk_load(st + 2 * TILE, row, 256, &full[s]);
        bulk_load(st + 2 * TILE + 256, row + plane, 256, &full[s]);
      }
    }
  } else {  // the consumer warpgroups: the paths never join again
    setmaxnreg_inc<kKvRegs>();
    const int wg = tid >> 7;
    const int wt = tid & 127;
    const int warp = wt >> 5;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int wk0 = k0 + 64 * wg;
    const int nkw = min(64, Sk - wk0);  // <= 0: the warpgroup has no keys
    const unsigned char* kt = sK + wg * TILE;
    const unsigned char* vt = sV + wg * TILE;
    const int key_base = wk0 + 16 * warp + (lane >> 2);  // + 0, + 8
    const float sl2 = scale * kLog2e;
    float dk_acc[HD / 2], dv_acc[HD / 2];
  #pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(&kv_full, 0);

    for (int it = 0; it < items; ++it) {
      const int s = it % kWgStages;
      mbar_wait(&full[s], (it / kWgStages) & 1);
      const unsigned char* sq = ring + s * STAGE;
      const unsigned char* sdo = sq + TILE;
      const float* st = reinterpret_cast<const float*>(sq + 2 * TILE);
      const int q0 = (qt_lo + it % n_qt) * 64;
      const int qp0 = mask.q_offset + q0;
      const int nq = min(64, Sq - q0);
      const int qpz = qp0 + nq - 1;
      // no (row, key) pair of the tile is kept (rows that keep no key keep
      // every key, so a tile with one is never skipped)
      const bool dead = nkw <= 0 ||
                        (!mask.empty(qpz) && (mask.hi(qpz) < wk0 ||
                                              mask.lo(qp0) > wk0 + nkw - 1));
      if (!dead) {
        // every row is real and keeps a range covering the 64 keys
        const bool masked = nq < 64 || nkw < 64 || mask.empty(qpz) ||
                            mask.lo(qpz) > wk0 || mask.hi(qp0) < wk0 + 63;
        float sa[32], pa[32];  // S^T, then P; dP^T, then dS
        wgmma_fence();
  #pragma unroll
        for (int kk = 0; kk < KS; ++kk) {  // S^T = K Q^T
          wgmma_ss_m64n64k16<0>(sa, desc_k(kt, kk), desc_k(sq, kk), kk);
        }
        wgmma_commit();
  #pragma unroll
        for (int kk = 0; kk < KS; ++kk) {  // dP^T = V dO^T
          wgmma_ss_m64n64k16<0>(pa, desc_k(vt, kk), desc_k(sdo, kk), kk);
        }
        wgmma_commit();
        wgmma_wait<1>();  // S^T is done
        fence_regs(sa);
  #pragma unroll
        for (int j = 0; j < 8; ++j) {
  #pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t4 + (e & 1);  // query in the tile
            const float x = sa[4 * j + e] * sl2 - st[col];
            float p;
            if (!masked) {
              p = fast_exp2(x);
            } else {
              const int qp = qp0 + col;
              const int key = key_base + 8 * (e >> 1);
              p = col < nq && mask.keep(qp, key)
                      ? fast_exp2(mask.empty(qp) ? -st[col] : x)
                      : 0.f;
            }
            sa[4 * j + e] = p;
          }
        }
        uint32_t pf[4][4], df[4][4];  // P^T and dS^T as A operands
        to_a(pf, sa);
        wgmma_fence();
  #pragma unroll
        for (int kq = 0; kq < 4; ++kq) {  // dV += P^T dO, over dS's work
          product_rs<HD>(dv_acc, pf[kq], desc_mn(sdo, kq));
        }
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is done
        fence_regs(pa);
  #pragma unroll
        for (int j = 0; j < 8; ++j) {
  #pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t4 + (e & 1);
            const float ds = sa[4 * j + e] * (pa[4 * j + e] - st[64 + col]);
            pa[4 * j + e] = masked && mask.empty(qp0 + col) ? 0.f : ds;
          }
        }
        to_a(df, pa);
        wgmma_fence();
  #pragma unroll
        for (int kq = 0; kq < 4; ++kq) {  // dK += dS^T Q
          product_rs<HD>(dk_acc, df[kq], desc_mn(sq, kq));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pf);
        fence_regs(df);
      }
      // the warpgroup's products of the stage are done (a product completes
      // only once its four warps have issued it, after their reads of st)
      if (wt == 0) mbar_arrive(&empty[s]);
    }

    // each warpgroup stages into its own K and V tiles, which only it reads
    stage_tile<HD>(sK + wg * TILE, dk_acc, scale, warp, lane);
    stage_tile<HD>(sV + wg * TILE, dv_acc, 1.f, warp, lane);
    named_barrier(1 + wg, 128);
    if (nkw > 0) {
      store_tile<HD>(dk + b * dks.b + kvh * dks.h + wk0 * dks.s, dks.s,
                     sK + wg * TILE, nkw, wt);
      store_tile<HD>(dv + b * dvs.b + kvh * dvs.h + wk0 * dvs.s, dvs.s,
                     sV + wg * TILE, nkw, wt);
    }
  }
}

// One CTA per (block of 64 kQWgs query rows, q head, batch), block index
// slowest and the last blocks (the most keys under a causal mask) first.
template <int HD>
__global__ void __launch_bounds__(kQThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mdo,
                const float* __restrict__ stats, bf16* __restrict__ dq,
                int H, int KV, int B, int Sq, int Sk, int SqP, Strides dqs,
                Mask mask, float scale, int qblocks) {
  constexpr int TILE = wg_tile<HD>();
  constexpr int NB = HD / 64;
  constexpr int KS = HD / 16;
  constexpr int STAGE = 2 * TILE;  // K, then V
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages];
  __shared__ __align__(8) uint64_t empty[kWgStages];
  __shared__ __align__(8) uint64_t qo_full;
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sdO = sQ + kQWgs * TILE;
  unsigned char* ring = sdO + kQWgs * TILE;

  const int q0 = (qblocks - 1 - static_cast<int>(blockIdx.x / (H * B))) *
                 64 * kQWgs;
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int nq = min(64 * kQWgs, Sq - q0);
  const int qp_first = mask.q_offset + q0;
  const int qp_last = qp_first + nq - 1;
  const bool any_empty = mask.empty(qp_last);
  const int k_lo = any_empty ? 0 : mask.lo(qp_first);
  const int k_hi = any_empty ? Sk - 1 : mask.hi(qp_last);
  const int t_first = k_lo / 64;
  const int n_t = k_lo <= k_hi ? k_hi / 64 - t_first + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kQWgs);
    }
    mbar_init(&qo_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * kQWgs) {  // the producer warpgroup; one thread issues
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * kQWgs) {
      const int tiles = min(kQWgs, (nq + 63) / 64);
      mbar_expect_tx(&qo_full, 2 * tiles * TILE);
      for (int w = 0; w < tiles; ++w) {
        for (int nb = 0; nb < NB; ++nb) {
          tma_load4(sQ + w * TILE + nb * kBox, &mq, nb * 64, q0 + 64 * w, h, b,
                    &qo_full);
          tma_load4(sdO + w * TILE + nb * kBox, &mdo, nb * 64, q0 + 64 * w, h,
                    b, &qo_full);
        }
      }
      for (int it = 0; it < n_t; ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) mbar_wait(&empty[s], ((it / kWgStages) - 1) & 1);
        const int kb0 = (t_first + it) * 64;
        unsigned char* st = ring + s * STAGE;
        mbar_expect_tx(&full[s], 2 * TILE);
        for (int nb = 0; nb < NB; ++nb) {
          tma_load4(st + nb * kBox, &mk, nb * 64, kb0, kvh, b, &full[s]);
          tma_load4(st + TILE + nb * kBox, &mv, nb * 64, kb0, kvh, b,
                    &full[s]);
        }
      }
    }
  } else {  // the consumer warpgroups: the paths never join again
    setmaxnreg_inc<kQRegs>();
    const int wg = tid >> 7;
    const int wt = tid & 127;
    const int warp = wt >> 5;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    const int wq0 = q0 + 64 * wg;
    const int nqw = min(64, Sq - wq0);  // <= 0: the warpgroup has no rows
    const int qpa = mask.q_offset + wq0;
    const int qpz = qpa + nqw - 1;
    const bool wg_empty = mask.empty(qpz);
    const int all_lo = mask.lo(qpz);
    const int all_hi = mask.hi(qpa);
    const unsigned char* qt = sQ + wg * TILE;
    const unsigned char* dot = sdO + wg * TILE;
    // this thread's two rows: 16 warp + lane / 4, and 8 below
    float lse2[2], dl[2];
    bool live[2];
    const long long plane = static_cast<long long>(B) * H * SqP;
    const float* row0 = stats + (static_cast<long long>(b) * H + h) * SqP;
  #pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wq0 + 16 * warp + (lane >> 2) + 8 * i;
      const bool in = r < Sq;
      lse2[i] = in ? row0[r] : 0.f;
      dl[i] = in ? row0[plane + r] : 0.f;
      live[i] = in && !mask.empty(mask.q_offset + r);
    }
    const float sl2 = scale * kLog2e;
    float dq_acc[HD / 2];
  #pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(&qo_full, 0);

    for (int it = 0; it < n_t; ++it) {
      const int s = it % kWgStages;
      mbar_wait(&full[s], (it / kWgStages) & 1);
      const unsigned char* sk = ring + s * STAGE;
      const unsigned char* sv = sk + TILE;
      const int kb0 = (t_first + it) * 64;
      const int nk = min(64, Sk - kb0);
      // rows that keep no key add nothing to dq
      const bool dead = nqw <= 0 || mask.empty(qpa) || mask.hi(qpz) < kb0 ||
                        mask.lo(qpa) > kb0 + nk - 1;
      if (!dead) {
        const bool masked = nqw < 64 || nk < 64 || wg_empty || kb0 < all_lo ||
                            kb0 + 63 > all_hi;
        float sa[32], pa[32];  // S, then P; dP, then dS
        wgmma_fence();
  #pragma unroll
        for (int kk = 0; kk < KS; ++kk) {  // S = Q K^T
          wgmma_ss_m64n64k16<0>(sa, desc_k(qt, kk), desc_k(sk, kk), kk);
        }
        wgmma_commit();
  #pragma unroll
        for (int kk = 0; kk < KS; ++kk) {  // dP = dO V^T
          wgmma_ss_m64n64k16<0>(pa, desc_k(dot, kk), desc_k(sv, kk), kk);
        }
        wgmma_commit();
        wgmma_wait<1>();  // S is done
        fence_regs(sa);
  #pragma unroll
        for (int j = 0; j < 8; ++j) {
  #pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            bool keep = live[i];
            if (masked) {
              const int qp = qpa + 16 * warp + (lane >> 2) + 8 * i;
              keep = keep && mask.keep(qp, kb0 + 8 * j + 2 * t4 + (e & 1));
            }
            sa[4 * j + e] =
                keep ? fast_exp2(sa[4 * j + e] * sl2 - lse2[i]) : 0.f;
          }
        }
        wgmma_wait<0>();
        fence_regs(pa);
  #pragma unroll
        for (int j = 0; j < 8; ++j) {
  #pragma unroll
          for (int e = 0; e < 4; ++e) {
            pa[4 * j + e] = sa[4 * j + e] * (pa[4 * j + e] - dl[e >> 1]);
          }
        }
        uint32_t df[4][4];  // dS as A operands
        to_a(df, pa);
        wgmma_fence();
  #pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // dQ += dS K
          product_rs<HD>(dq_acc, df[kk], desc_mn(sk, kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_regs(df);
      }
      if (wt == 0) mbar_arrive(&empty[s]);
    }

    stage_tile<HD>(sQ + wg * TILE, dq_acc, scale, warp, lane);
    named_barrier(1 + wg, 128);
    if (nqw > 0) {
      store_tile<HD>(dq + b * dqs.b + h * dqs.h + wq0 * dqs.s, dqs.s,
                     sQ + wg * TILE, nqw, wt);
    }
  }
}

// A 4-D map of a [B][heads][S][hd] bf16 tensor (element strides ``st``,
// hd contiguous) with a box of [64 rows][64] and the 128-byte swizzle.
// Rows past S read as zeros.  A dimension of one takes a nominal stride.
int make_map4(CUtensorMap* out, const void* ptr, int hd, int S, int heads,
              int B, Strides st) {
  repro_torch::EncodeTiled encode = repro_torch::tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t s1 = static_cast<cuuint64_t>(st.s) * 2;
  cuuint64_t s2 = static_cast<cuuint64_t>(st.h) * 2;
  cuuint64_t s3 = static_cast<cuuint64_t>(st.b) * 2;
  if (S == 1 || s1 == 0) s1 = static_cast<cuuint64_t>(hd) * 2;
  if (heads == 1 || s2 == 0) s2 = s1 * S;
  if (B == 1 || s3 == 0) s3 = s2 * heads;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {s1, s2, s3};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int HD>
int launch_wgmma(const Args& a) {
  static bool allowed_kv[kMaxDevices] = {};
  static bool allowed_q[kMaxDevices] = {};
  int err = allow_smem(dkdv_wgmma_kernel<HD>, dkdv_wg_smem<HD>(), allowed_kv);
  if (err != 0) return err;
  err = allow_smem(dq_wgmma_kernel<HD>, dq_wg_smem<HD>(), allowed_q);
  if (err != 0) return err;
  CUtensorMap mq, mk, mv, mdo;
  if ((err = make_map4(&mq, a.q, HD, a.Sq, a.H, a.B, a.qs)) != 0 ||
      (err = make_map4(&mk, a.k, HD, a.Sk, a.KV, a.B, a.ks)) != 0 ||
      (err = make_map4(&mv, a.v, HD, a.Sk, a.KV, a.B, a.vs)) != 0 ||
      (err = make_map4(&mdo, a.dout, HD, a.Sq, a.H, a.B, a.dos)) != 0) {
    return err;
  }
  const int pitch = (a.Sq + 63) / 64 * 64;
  float* stats = static_cast<float*>(a.delta);
  const long long plane = static_cast<long long>(a.B) * a.H * pitch;
  err = launch_delta<bf16>(a, stats + plane, stats, pitch);
  if (err != 0) return err;
  const long long kblocks = (a.Sk + 64 * kKvWgs - 1) / (64 * kKvWgs);
  const long long qblocks = (a.Sq + 64 * kQWgs - 1) / (64 * kQWgs);
  const long long kv_ctas = kblocks * a.KV * a.B;
  const long long q_ctas = qblocks * a.H * a.B;
  if (kv_ctas > 0x7fffffffLL || q_ctas > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dkdv_wgmma_kernel<HD><<<static_cast<unsigned>(kv_ctas), kKvThreads,
                          dkdv_wg_smem<HD>(), a.stream>>>(
      mq, mk, mv, mdo, stats, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.H, a.KV, a.B, a.Sq, a.Sk, pitch, a.dks,
      a.dvs, a.mask, a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dq_wgmma_kernel<HD><<<static_cast<unsigned>(q_ctas), kQThreads,
                        dq_wg_smem<HD>(), a.stream>>>(
      mq, mk, mv, mdo, stats, static_cast<bf16*>(a.dq), a.H, a.KV, a.B, a.Sq,
      a.Sk, pitch, a.dqs, a.mask, a.scale, static_cast<int>(qblocks));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ f32 cores
constexpr int kFB = 32;     // keys or queries of an f32 block
constexpr int kFWarps = 8;
constexpr int kFRows = kFB / kFWarps;  // rows (or keys) of a warp

__device__ __forceinline__ float dot_row(const float* a, const float* b,
                                         int hd) {
  float s = 0.f;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  for (int d4 = 0; d4 < hd / 4; ++d4) {
    const float4 x = a4[d4], y = b4[d4];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// rows [0, n) of a [kFB, hd] f32 tile into shared memory (pitch hd + 4);
// the rest zeroed
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long stride, int n, int hd) {
  const int pitch = hd + 4;
  const int per_row = hd / 4;
  for (int i = threadIdx.x; i < kFB * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i % per_row) * 4;
    const float4 x =
        r < n ? *reinterpret_cast<const float4*>(src + r * stride + c)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * pitch + c) = x;
  }
}

// acc[kFRows][4 NC] += sum_j w[j][r] X[j][columns of this lane] over the
// tile's n rows of X (pitch hd + 4); w is [kFB][kFRows] in shared memory
template <int NC>
__device__ __forceinline__ void accumulate(float (&acc)[kFRows][4 * NC],
                                           const float* w, const float* X,
                                           int n, int hd, int lane) {
  const int pitch = hd + 4;
  for (int j = 0; j < n; ++j) {
    const float4 wj = *reinterpret_cast<const float4*>(w + j * kFRows);
    const float wr[kFRows] = {wj.x, wj.y, wj.z, wj.w};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * (lane + 32 * c);
      if (d < hd) {
        const float4 x = *reinterpret_cast<const float4*>(X + j * pitch + d);
#pragma unroll
        for (int r = 0; r < kFRows; ++r) {
          acc[r][4 * c + 0] = fmaf(wr[r], x.x, acc[r][4 * c + 0]);
          acc[r][4 * c + 1] = fmaf(wr[r], x.y, acc[r][4 * c + 1]);
          acc[r][4 * c + 2] = fmaf(wr[r], x.z, acc[r][4 * c + 2]);
          acc[r][4 * c + 3] = fmaf(wr[r], x.w, acc[r][4 * c + 3]);
        }
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void store_f32(float* dst, long long stride,
                                          const float (&acc)[kFRows][4 * NC],
                                          float mul, int row0, int n, int hd,
                                          int lane) {
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    if (row0 + r >= n) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * (lane + 32 * c);
      if (d < hd) {
        *reinterpret_cast<float4*>(dst + (row0 + r) * stride + d) =
            make_float4(acc[r][4 * c] * mul, acc[r][4 * c + 1] * mul,
                        acc[r][4 * c + 2] * mul, acc[r][4 * c + 3] * mul);
      }
    }
  }
}

// One CTA per (block of 32 keys, kv head, batch); warp w owns keys 4w..
template <int NC>
__global__ void __launch_bounds__(32 * kFWarps)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int KV, int Sq, int Sk,
                int hd, Strides qs, Strides ks, Strides vs, Strides dos,
                Strides dks, Strides dvs, Mask mask, float scale) {
  extern __shared__ float4 smem4[];
  const int pitch = hd + 4;
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kFB * pitch;
  float* sQ = sV + kFB * pitch;
  float* sdO = sQ + kFB * pitch;
  float* sLse = sdO + kFB * pitch;
  float* sD = sLse + kFB;
  float* sP = sD + kFB;                       // [warp][query][key of warp]
  float* sdS = sP + kFWarps * kFB * kFRows;
  const int k0 = blockIdx.x * kFB;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nk = min(kFB, Sk - k0);
  const int k_last = k0 + nk - 1;
  int i_lo = mask.causal ? max(0, k0 - mask.q_offset) : 0;
  int i_hi = Sq - 1;
  if (mask.window > 0 && !mask.empty(mask.q_offset + Sq - 1)) {
    i_hi = min(Sq - 1, k_last + mask.window - 1 - mask.q_offset);
  }
  load_f32(sK, k + b * ks.b + kvh * ks.h + k0 * ks.s, ks.s, nk, hd);
  load_f32(sV, v + b * vs.b + kvh * vs.h + k0 * vs.s, vs.s, nk, hd);
  float dk_acc[kFRows][4 * NC], dv_acc[kFRows][4 * NC];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) dk_acc[r][e] = dv_acc[r][e] = 0.f;
  }
  float* sPw = sP + warp * kFB * kFRows;
  float* sdSw = sdS + warp * kFB * kFRows;
  for (int hg = 0; hg < G && i_lo <= i_hi; ++hg) {
    const int h = kvh * G + hg;
    for (int q0 = (i_lo / kFB) * kFB; q0 <= i_hi; q0 += kFB) {
      const int nq = min(kFB, Sq - q0);
      const long long row0 = (static_cast<long long>(b) * H + h) * Sq + q0;
      __syncthreads();  // every warp is done with the previous tile
      load_f32(sQ, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, nq, hd);
      load_f32(sdO, dout + b * dos.b + h * dos.h + q0 * dos.s, dos.s, nq, hd);
      if (threadIdx.x < kFB) {
        const bool in = static_cast<int>(threadIdx.x) < nq;
        sLse[threadIdx.x] = in ? lse[row0 + threadIdx.x] : 0.f;
        sD[threadIdx.x] = in ? delta[row0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      // lane = query of the tile, against the warp's keys
      const int qp = mask.q_offset + q0 + lane;
      const bool empty = mask.empty(qp);
#pragma unroll
      for (int r = 0; r < kFRows; ++r) {
        const int key = k0 + warp * kFRows + r;
        const float* krow = sK + (warp * kFRows + r) * pitch;
        const float* vrow = sV + (warp * kFRows + r) * pitch;
        const float s = dot_row(krow, sQ + lane * pitch, hd);
        const float dp = dot_row(vrow, sdO + lane * pitch, hd);
        const bool keep = lane < nq && mask.keep(qp, key);
        const float p = keep ? expf((empty ? 0.f : s * scale) - sLse[lane])
                             : 0.f;
        sPw[lane * kFRows + r] = p;
        sdSw[lane * kFRows + r] = keep && !empty ? p * (dp - sD[lane]) : 0.f;
      }
      __syncwarp();
      accumulate<NC>(dv_acc, sPw, sdO, nq, hd, lane);
      accumulate<NC>(dk_acc, sdSw, sQ, nq, hd, lane);
    }
  }
  store_f32<NC>(dk + b * dks.b + kvh * dks.h + k0 * dks.s, dks.s, dk_acc,
                scale, warp * kFRows, nk, hd, lane);
  store_f32<NC>(dv + b * dvs.b + kvh * dvs.h + k0 * dvs.s, dvs.s, dv_acc,
                1.f, warp * kFRows, nk, hd, lane);
}

// One CTA per (block of 32 query rows, q head, batch); warp w owns rows 4w..
template <int NC>
__global__ void __launch_bounds__(32 * kFWarps)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int KV, int Sq, int Sk, int hd,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
              Mask mask, float scale) {
  extern __shared__ float4 smem4[];
  const int pitch = hd + 4;
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kFB * pitch;
  float* sK = sdO + kFB * pitch;
  float* sV = sK + kFB * pitch;
  float* sdS = sV + kFB * pitch;  // [warp][key][row of warp]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nq = min(kFB, Sq - q0);
  const int qp_first = mask.q_offset + q0;
  const int qp_last = qp_first + nq - 1;
  const bool any_empty = mask.empty(qp_last);
  const int k_lo = any_empty ? 0 : mask.lo(qp_first);
  const int k_hi = any_empty ? Sk - 1 : mask.hi(qp_last);
  const long long row0 = (static_cast<long long>(b) * H + h) * Sq + q0;
  load_f32(sQ, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, nq, hd);
  load_f32(sdO, dout + b * dos.b + h * dos.h + q0 * dos.s, dos.s, nq, hd);
  float lse_r[kFRows], d_r[kFRows];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    const int row = warp * kFRows + r;
    lse_r[r] = row < nq ? lse[row0 + row] : 0.f;
    d_r[r] = row < nq ? delta[row0 + row] : 0.f;
  }
  float acc[kFRows][4 * NC];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) acc[r][e] = 0.f;
  }
  float* sdSw = sdS + warp * kFB * kFRows;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  for (int kb0 = (k_lo / kFB) * kFB; kb0 <= k_hi; kb0 += kFB) {
    const int nk = min(kFB, Sk - kb0);
    __syncthreads();
    load_f32(sK, kb + kb0 * ks.s, ks.s, nk, hd);
    load_f32(sV, vb + kb0 * vs.s, vs.s, nk, hd);
    __syncthreads();
    // lane = key of the block, against the warp's rows
    const int key = kb0 + lane;
#pragma unroll
    for (int r = 0; r < kFRows; ++r) {
      const int row = warp * kFRows + r;
      const int qp = qp_first + row;
      const float s = dot_row(sQ + row * pitch, sK + lane * pitch, hd);
      const float dp = dot_row(sdO + row * pitch, sV + lane * pitch, hd);
      const bool live = row < nq && !mask.empty(qp) && mask.keep(qp, key);
      sdSw[lane * kFRows + r] =
          live ? expf(s * scale - lse_r[r]) * (dp - d_r[r]) : 0.f;
    }
    __syncwarp();
    accumulate<NC>(acc, sdSw, sK, nk, hd, lane);
  }
  store_f32<NC>(dq + b * dqs.b + h * dqs.h + q0 * dqs.s, dqs.s, acc, scale,
                warp * kFRows, nq, hd, lane);
}

template <int NC>
int launch_f32_nc(const Args& a) {
  const int pitch = a.hd + 4;
  const int kv_bytes = (4 * kFB * pitch + 2 * kFB +
                        2 * kFWarps * kFB * kFRows) * 4;
  const int q_bytes = (4 * kFB * pitch + kFWarps * kFB * kFRows) * 4;
  static bool allowed_kv[kMaxDevices] = {};
  static bool allowed_q[kMaxDevices] = {};
  constexpr int max_kv = (4 * kFB * (kMaxHd + 4) + 2 * kFB +
                          2 * kFWarps * kFB * kFRows) * 4;
  int err = allow_smem(dkdv_f32_kernel<NC>, max_kv, allowed_kv);
  if (err != 0) return err;
  err = allow_smem(dq_f32_kernel<NC>, max_kv, allowed_q);
  if (err != 0) return err;
  const int kblocks = (a.Sk + kFB - 1) / kFB;
  const int qblocks = (a.Sq + kFB - 1) / kFB;
  if (a.H > 65535 || a.KV > 65535 || a.B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dkdv_f32_kernel<NC><<<dim3(kblocks, a.KV, a.B), 32 * kFWarps, kv_bytes,
                        a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.KV, a.Sq,
      a.Sk, a.hd, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.mask, a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dq_f32_kernel<NC><<<dim3(qblocks, a.H, a.B), 32 * kFWarps, q_bytes,
                      a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), a.H, a.KV, a.Sq, a.Sk, a.hd, a.qs, a.ks,
      a.vs, a.dos, a.dqs, a.mask, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; route codes (the wrapper's
// choice, see the note at the top): 0 the f32 CUDA cores, 1 mma.sync, 2
// wgmma (bf16 at hd 64 and 128).  Strides are in elements, for the
// (batch, head, sequence) dimensions of q, k, v, o, dout, dq, dk, dv; the
// head dimension is contiguous and every row 16-byte aligned.  lse is the
// forward's f32 [B, H, Sq] output; delta an f32 workspace of 2 B H SqP
// floats, SqP = Sq rounded up to 64 (routes 0 and 1 use its first B H Sq
// as D; route 2 LSE log2(e) [B H][SqP], then D [B H][SqP]).  dq, dk and
// dv are written whole (rows no query sees get zeros).  Launches three
// kernels (D, dkdv, dq) on ``stream`` and returns the first cudaError any
// launch reports.
extern "C" int launch_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int H, int KV, int Sq, int Sk, int hd,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, int q_offset, float scale, int dtype, int route,
    void* stream) {
  if (hd % 8 != 0 || hd < 8 || hd > kMaxHd || KV < 1 || H % KV != 0 ||
      Sq < 1 || Sk < 1 || B < 1 || window < 0 || q_offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, KV, Sq, Sk, hd,
         Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
         Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
         Strides{do_sb, do_sh, do_ss}, Strides{dq_sb, dq_sh, dq_ss},
         Strides{dk_sb, dk_sh, dk_ss}, Strides{dv_sb, dv_sh, dv_ss},
         Mask{Sk, causal, window, q_offset}, scale,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && route == 0) {
    int err = launch_delta<float>(a, static_cast<float*>(delta), nullptr,
                                  Sq);
    if (err != 0) return err;
    return hd <= 128 ? launch_f32_nc<1>(a) : launch_f32_nc<2>(a);
  }
  if (dtype == 1 && route == 1) return launch_mma_route(a);
  if (dtype == 1 && route == 2 && hd == 64) return launch_wgmma<64>(a);
  if (dtype == 1 && route == 2 && hd == 128) return launch_wgmma<128>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
