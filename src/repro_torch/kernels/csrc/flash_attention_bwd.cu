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
// Design (bf16, mma.sync m16n8k16 with f32 accumulators, the helpers of
// mma.cuh).  A warp owns 16 rows (dq: query rows; dkdv: keys) and, at hd
// 256, half the columns of the gradient it accumulates (CS = 2 warps a
// row block, each computing the full S and dP of its rows), which keeps
// a thread's f32 accumulators at 64 + 64 (dkdv) or 64 (dq) registers.
//   - dkdv: K and V of the block's 64 keys stay in shared memory; query
//     tiles of 32 rows of (Q, dO, LSE, D) stream through a 2-stage
//     cp.async ring over the flattened (q head, tile) sequence.
//     S^T = K Q^T and dP^T = V dO^T (keys as the A operand); P^T and dS^T
//     feed dV and dK from registers (their C fragments are A fragments).
//   - dq: Q and dO of 64 rows in shared memory; K/V tiles of 64 keys (32
//     at hd 256) through a 2-stage ring; S = Q K^T, dP = dO V^T; dS feeds
//     dQ += dS K, K through ldmatrix.trans.
//   - Tiles that no row masks skip the mask.  Results are staged through
//     shared memory for 16-byte stores.
// Bound: 5 products of 2 Sq Sk hd operations per (batch, q head) (S twice,
// dP twice, dV, dK, dQ: 7 with the recomputed S and dP, 5 counted), halved
// by a causal mask: compute-bound at the training shapes.  mma.sync
// reaches part of the tensor cores' rate; wgmma fed by TMA is later work.
//
// f32 (the train-reference check's f32 runs): the same passes on the CUDA
// cores, 8 warps a CTA, blocks of 32 keys and 32 queries staged in shared
// memory as f32 (rows padded by 4 floats); a lane scores one (row, key)
// pair per warp row, the gradient sums run over float4 columns per lane.

#include <math_constants.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait_group;
using repro_torch::ldmatrix_x4;
using repro_torch::ldmatrix_x4_trans;
using repro_torch::load8;
using repro_torch::mma_bf16;
using repro_torch::pack_bf16_rn;
using repro_torch::Strides;

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
// D[b, h, i] = sum_c dO[b, h, i, c] O[b, h, i, c]: one warp a row
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int H, int Sq, int hd, Strides os,
             Strides ds, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = static_cast<int>(row % Sq);
  const long long bh = row / Sq;
  const int h = static_cast<int>(bh % H);
  const int b = static_cast<int>(bh / H);
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* drow = dout + b * ds.b + h * ds.h + i * ds.s;
  float sum = 0.f;
  for (int c = lane * 8; c < hd; c += 256) {
    float x[8], y[8];
    load8(orow + c, x);
    load8(drow + c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(x[e], y[e], sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) delta[row] = sum;
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

int launch_bf16(const Args& a) {
  if (a.hd <= 16) return launch_mma<16>(a);
  if (a.hd <= 32) return launch_mma<32>(a);
  if (a.hd <= 64) return launch_mma<64>(a);
  if (a.hd <= 128) return launch_mma<128>(a);
  return launch_mma<256>(a);
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

template <typename T>
int launch_delta(const Args& a) {
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), a.H, a.Sq, a.hd, a.os, a.dos, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Strides are in elements, for
// the (batch, head, sequence) dimensions of q, k, v, o, dout, dq, dk, dv;
// the head dimension is contiguous and every row 16-byte aligned.  lse is
// the forward's f32 [B, H, Sq] output; delta an f32 [B, H, Sq] workspace.
// dq, dk and dv are written whole (rows no query sees get zeros).
// Launches three kernels (delta, dkdv, dq) on ``stream`` and returns the
// first cudaError any launch reports.
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
    int causal, int window, int q_offset, float scale, int dtype,
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
  if (dtype == 0) {
    int err = launch_delta<float>(a);
    if (err != 0) return err;
    return hd <= 128 ? launch_f32_nc<1>(a) : launch_f32_nc<2>(a);
  }
  if (dtype == 1) {
    int err = launch_delta<bf16>(a);
    if (err != 0) return err;
    return launch_bf16(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
