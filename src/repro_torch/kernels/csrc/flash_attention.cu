// Flash attention for Hopper (sm_90a): blocked causal / sliding-window
// attention of a whole prompt, with grouped-query heads read in place.
//
// Replaces the Pallas kernel of the JAX package's
// src/repro/kernels/flash_attention.py (flash_attention, _flash_kernel)
// -> launch_flash_attention.  It computes what that kernel computes, on
// the layout the port's model code holds, not on the TPU kernel's:
//
//   q    [B, H,  Sq, hd]   bf16 or f32, any strides with a unit last one
//   k/v  [B, KV, Sk, hd]   q's dtype; q head h reads kv head h / (H / KV)
//   out  [B, H,  Sq, hd]   q's dtype, through the strides it is given
//
// The TPU kernel takes K/V already repeated to H heads; here each kv head
// is read where it lies, so no repeated or f32 copy of K/V is ever made.
// Sq and Sk are any lengths (the tails are masked); the TPU kernel
// rejects lengths that are not multiples of its blocks.
//
// Training: with a non-null ``lse`` the kernel also writes each row's
// natural log-sum-exp of its scaled scores, f32 [B, H, Sq], from which
// the backward (flash_attention_bwd.cu) recomputes the probabilities; the
// serving path passes null and writes nothing more.
//
// Semantics: row i sits at absolute position qp = q_offset + i; key j is
// kept when j < Sk, (!causal || j <= qp) and (window == 0 || qp - j <
// window).  Scores are (q . k) / sqrt(hd), the softmax is online in f32
// and P.V accumulates in f32; the output is rounded once to q's dtype.
// A key the mask drops contributes exactly 0 to a row that keeps any key,
// so each block of 64 rows sweeps only the key blocks between its first
// row's first kept key and its last row's last kept key.  A row that
// keeps no key at all returns the mean of V over all Sk keys, as the
// Pallas kernel does with its finite NEG_INF: a block holding such a row
// sweeps every key and gives that row score 0 for each, and never NaN.
//
// Design.  bf16 runs on the tensor cores (flash_mma_kernel), in
// FlashAttention-2's structure: one CTA per (batch, head, block of 64
// query rows), the heaviest causal blocks of every head launched first;
// a group of 4 warps sweeps the block's key tiles, each warp 16 rows.
//   - Where the grid is too small to put two CTAs on every SM (B H
//     blocks < 2 SMs: a 1024-token prompt of 16 heads, gemma3's 4), two
//     groups split each block's sweep: group 0 takes the even key tiles,
//     group 1 the odd ones, each with its own (m, l, O); at the end group
//     1 hands its state to group 0 through shared memory, which merges it
//     in a fixed order.  A causal block's sweep is serial in its tiles,
//     and there the heaviest blocks' sweeps set the time of the whole
//     prompt: the split halves them.  A larger grid keeps one group a
//     CTA, two CTAs an SM, whose loads and epilogues overlap each other.
//   - Q is copied once into shared memory as bf16 and held in registers
//     as ldmatrix A-fragments (hd <= 128; at hd 256 they are re-read from
//     shared memory each key tile, which keeps the thread under 255
//     registers).
//   - K and V move in bf16 tiles of 64 keys (32 at hd 256) through a
//     2-stage cp.async ring per group: its next tile loads while its
//     current one computes.  Rows are padded by 16 bytes so every
//     ldmatrix is free of bank conflicts; hd that is not a multiple of
//     16 is zero-padded to the next template width (16, 32, 64, 128,
//     256), tails past Sk are zero.
//   - S = Q.K^T is mma.sync m16n8k16 (bf16 in, f32 accumulators): the
//     products of bf16 values are exact in f32, so S differs from the
//     plain version's only in summation order.  Only tiles that cross the
//     causal diagonal, the window edge or Sk are masked.
//   - The softmax is online on the accumulator fragments: row max and
//     row sum within the lane quad (two shfl_xor), exp2f with
//     scale * log2(e) folded into the scores.
//   - P stays in registers and feeds the P.V mma.sync directly (two S
//     n-tiles' accumulators are one A fragment), V through
//     ldmatrix.trans, as two bf16 parts: hi = P rounded and lo = P - hi
//     rounded, two products into the same f32 accumulators.  Together
//     they keep about 16 significant bits of each weight, where one bf16
//     P (8 bits) moved zamba2's bf16 logits far enough to flip an argmax
//     that the reference check holds.  O accumulates in f32 registers
//     and is rounded once, staged through shared memory for 16-byte
//     stores.
// Shared memory: (64 + 4 BK groups) (hdp + 8) bf16: 87 / 157 KB at hd
// 128 with one / two groups, 101 / 169 KB at hd 256.  Registers, one /
// two groups, none spilled (ptxas of `nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v -c
// flash_attention.cu`): hd 256 255 / 254, hd 128 235 / 233, hd 64 147 /
// 147, hd 32 135 / 140, hd 16 121 / 121; flash_kernel (f32) 128 at hd
// <= 128, 144 above.
//
// f32 stays on the CUDA cores (flash_kernel; the f32 checks hold 1e-5,
// which neither bf16 nor TF32 tensor cores meet): one CTA of 8 warps per
// (batch, head, block of 64 query rows); the Q block and one 32-key
// block of K and V at a time staged in shared memory as f32 (rows padded
// by 4 floats); warp w owns rows 8w..8w+7: for S = Q.K^T lane j takes key
// j of the block; for P.V lane j takes columns 4j..4j+3 (and 128+4j..
// when hd > 128), with P passed through shared memory.  The kernel picks
// its path by dtype and never falls back.
//
// Bound: at the prefill shapes attention does 4 hd operations per kept
// (query, key) pair on inputs read once: compute-bound against the bf16
// tensor cores (989 TFLOP/s) once prompts are a few hundred tokens long,
// bytes-bound (3.35 TB/s) below that.  mma.sync reaches part of the
// tensor cores' rate; wgmma tiles fed by TMA with warp specialisation are
// later work.

#include <math_constants.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait_group;
using repro_torch::kNegInf;
using repro_torch::ldmatrix_x4;
using repro_torch::ldmatrix_x4_trans;
using repro_torch::load8;
using repro_torch::mma_bf16;
using repro_torch::pack_bf16_rn;
using repro_torch::Strides;

constexpr int kBQ = 64;     // query rows per CTA
constexpr int kBK = 32;     // keys per shared-memory block
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;  // query rows per warp
constexpr int kMaxHd = 256;
constexpr int kMaxSmem =
    ((kBQ + 2 * kBK) * (kMaxHd + 4) + kWarps * kBK * kRows) * 4;

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// rows [0, n_valid) of a [rows, hd] tile from global (row stride `stride`)
// into shared f32 with row pitch `pitch`; rows past n_valid are zeroed
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows,
                                          int n_valid, int hd, int pitch) {
  const int per_row = hd / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = i - r * per_row;
    float x[8];
    if (r < n_valid) {
      load8(src + r * stride + c * 8, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * pitch + c * 8);
    d[0] = make_float4(x[0], x[1], x[2], x[3]);
    d[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// NC: float4 column chunks per lane in P.V (1 for hd <= 128, 2 up to 256)
template <typename T, int NC>
__global__ void __launch_bounds__(32 * kWarps)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int H, int KV,
             int Sq, int Sk, int hd, Strides qs, Strides ks, Strides vs,
             Strides os, int causal, int window, int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  const int pitch = hd + 4;
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * pitch;
  float* sV = sK + kBK * pitch;
  float* sP = sV + kBK * pitch;  // [kWarps][kBK][kRows]

  // the heaviest causal blocks (the last rows) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nq = min(kBQ, Sq - q0);

  // kept keys of the row at absolute position qp: [lo, hi]
  auto lo_of = [&](int qp) { return window > 0 ? max(0, qp - window + 1) : 0; };
  auto hi_of = [&](int qp) { return causal ? min(qp, Sk - 1) : Sk - 1; };

  bool any_empty = false;
  for (int r = 0; r < nq; ++r) {
    const int qp = q_offset + q0 + r;
    any_empty |= lo_of(qp) > hi_of(qp);
  }
  // lo and hi grow with qp: the block's rows keep keys within
  // [lo(first row), hi(last row)], unless one of them keeps none
  const int k_lo = any_empty ? 0 : lo_of(q_offset + q0);
  const int k_hi = any_empty ? Sk - 1 : hi_of(q_offset + q0 + nq - 1);

  load_tile(sQ, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, kBQ, nq, hd,
            pitch);
  const T* kbase = k + b * ks.b + kvh * ks.h;
  const T* vbase = v + b * vs.b + kvh * vs.h;
  float* sPw = sP + warp * kBK * kRows;

  float m[kRows], l[kRows], acc[kRows][4 * NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) acc[r][e] = 0.f;
  }

  for (int kb0 = (k_lo / kBK) * kBK; kb0 <= k_hi; kb0 += kBK) {
    const int nk = min(kBK, Sk - kb0);
    __syncthreads();  // every warp is done with the previous K/V block
    load_tile(sK, kbase + kb0 * ks.s, ks.s, kBK, nk, hd, pitch);
    load_tile(sV, vbase + kb0 * vs.s, vs.s, kBK, nk, hd, pitch);
    __syncthreads();

    // S = Q.K^T: lane `lane` scores key kb0 + lane against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(sK + lane * pitch);
    const float4* qrows =
        reinterpret_cast<const float4*>(sQ + warp * kRows * pitch);
    for (int d4 = 0; d4 < hd / 4; ++d4) {
      const float4 kx = krow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qx = qrows[r * (pitch / 4) + d4];
        s[r] = fmaf(qx.x, kx.x, s[r]);
        s[r] = fmaf(qx.y, kx.y, s[r]);
        s[r] = fmaf(qx.z, kx.z, s[r]);
        s[r] = fmaf(qx.w, kx.w, s[r]);
      }
    }

    // mask, online softmax; P to shared memory as [key][row]
    const int key = kb0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q_offset + q0 + warp * kRows + r;
      const int lo = lo_of(qp);
      const int hi = hi_of(qp);
      const bool empty = lo > hi;
      const bool keep = key < Sk && (empty || (key >= lo && key <= hi));
      const float sc = empty ? 0.f : s[r] * scale;
      const float m_new = fmaxf(m[r], warp_max(keep ? sc : kNegInf));
      const float p = keep ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * NC; ++e) acc[r][e] *= alpha;
      sPw[lane * kRows + r] = p;
    }
    __syncwarp();

    // acc += P.V over the block's real keys (P is 0 past them)
    for (int j = 0; j < nk; ++j) {
      const float4 pa = reinterpret_cast<const float4*>(sPw + j * kRows)[0];
      const float4 pb = reinterpret_cast<const float4*>(sPw + j * kRows)[1];
      const float p[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float4* vrow = reinterpret_cast<const float4*>(sV + j * pitch);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d4 = lane + 32 * c;
        if (4 * d4 < hd) {
          const float4 vx = vrow[d4];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][4 * c + 0] = fmaf(p[r], vx.x, acc[r][4 * c + 0]);
            acc[r][4 * c + 1] = fmaf(p[r], vx.y, acc[r][4 * c + 1]);
            acc[r][4 * c + 2] = fmaf(p[r], vx.z, acc[r][4 * c + 2]);
            acc[r][4 * c + 3] = fmaf(p[r], vx.w, acc[r][4 * c + 3]);
          }
        }
      }
    }
  }

  T* obase = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = warp * kRows + r;
    if (row >= nq) continue;
    if (lse != nullptr && lane == 0) {
      lse[(static_cast<long long>(b) * H + h) * Sq + q0 + row] =
          m[r] + logf(l[r]);
    }
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d4 = lane + 32 * c;
      if (4 * d4 < hd) {
        const float o[4] = {acc[r][4 * c] * inv, acc[r][4 * c + 1] * inv,
                            acc[r][4 * c + 2] * inv, acc[r][4 * c + 3] * inv};
        store4(obase + (q0 + row) * os.s + 4 * d4, o);
      }
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int KV, int Sq, int Sk, int hd,
           Strides qs, Strides ks, Strides vs, Strides os, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      ((kBQ + 2 * kBK) * (hd + 4) + kWarps * kBK * kRows) * sizeof(float);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, NC><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, KV, Sq, Sk, hd,
      qs, ks, vs, os, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int KV, int Sq, int Sk, int hd,
               Strides qs, Strides ks, Strides vs, Strides os, int causal,
               int window, int q_offset, float scale, cudaStream_t stream) {
  if (hd <= 128) {
    return launch<float, 1>(q, k, v, out, lse, B, H, KV, Sq, Sk, hd, qs, ks,
                            vs, os, causal, window, q_offset, scale, stream);
  }
  return launch<float, 2>(q, k, v, out, lse, B, H, KV, Sq, Sk, hd, qs, ks, vs,
                          os, causal, window, q_offset, scale, stream);
}

// ------------------------------------------------------------ bf16 MMA
using bf16 = __nv_bfloat16;

constexpr int kGroupWarps = 4;  // warps of a group, 16 query rows each
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kMmaRows = 16 * kGroupWarps;  // query rows per CTA
constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row
constexpr int kMaxDevices = 64;

// key tile per padded head dim: 64 keys, 32 at hd 256 (registers)
constexpr int key_tile(int hdp) { return hdp > 128 ? 32 : 64; }

// shared memory of one CTA of `groups` warp groups: the Q block, then
// per group a ring of 2 stages of (K tile, V tile)
constexpr int mma_smem(int hdp, int groups) {
  return (kMmaRows + groups * 4 * key_tile(hdp)) * (hdp + kPad) * 2;
}

// exact f32 values of the two bf16 halves of a packed pair
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// barrier of one warp group's 128 threads (id 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group), "n"(kGroupThreads)
               : "memory");
}

// HDP: hd padded to a width of 16, 32, 64, 128 or 256; BK: keys per tile;
// GR: warp groups splitting the key sweep (1 or 2)
template <int HDP, int BK, int GR>
__global__ void __launch_bounds__(kGroupThreads * GR)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                 int hd, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, int q_offset, float scale) {
  constexpr int P = HDP + kPad;  // shared-memory row pitch (elements)
  constexpr int KT = HDP / 16;   // k-steps of Q.K^T
  constexpr int NT = BK / 8;     // n-tiles of S (8 keys each)
  constexpr int DT = HDP / 8;    // n-tiles of O (8 columns each)
  constexpr int CH = HDP / 8;    // 16-byte chunks of a row
  constexpr int VG = DT / 2 < 4 ? DT / 2 : 4;  // V fragments loaded at once
  constexpr int RING = 4 * BK * P;  // elements of one group's ring
  constexpr bool kQInRegs = HDP <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);

  // the heaviest causal blocks (the last rows) of every head first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = warp / kGroupWarps;  // this warp's group
  const int wq = warp % kGroupWarps;   // its 16 rows: 16 wq ..
  const int g = lane >> 2;  // fragment row (and key / column) group
  const int t4 = lane & 3;  // thread in group
  const int nq = min(kMmaRows, Sq - q0);
  // stage s of this group's ring: K tile at s * 2 BK P, V tile after
  bf16* ring = sQ + kMmaRows * P + grp * RING;

  // kept keys of the row at absolute position qp: [lo, hi]
  auto lo_of = [&](int qp) { return window > 0 ? max(0, qp - window + 1) : 0; };
  auto hi_of = [&](int qp) { return causal ? min(qp, Sk - 1) : Sk - 1; };

  bool any_empty = false;
  for (int r = 0; r < nq; ++r) {
    const int qp = q_offset + q0 + r;
    any_empty |= lo_of(qp) > hi_of(qp);
  }
  // lo and hi grow with qp: the block's rows keep keys within
  // [lo(first row), hi(last row)], unless one of them keeps none; every
  // row keeps all of [lo(last row), hi(first row)]
  const int qp_first = q_offset + q0;
  const int qp_last = qp_first + nq - 1;
  const int k_lo = any_empty ? 0 : lo_of(qp_first);
  const int k_hi = any_empty ? Sk - 1 : hi_of(qp_last);
  const int all_lo = lo_of(qp_last);
  const int all_hi = hi_of(qp_first);

  // this thread's two rows, g and g + 8 of its warp's 16: kept range,
  // or every key at score 0 for a row that keeps none
  int row_lo[2], row_hi[2];
  bool row_empty[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qp_first + wq * 16 + g + 8 * i;
    row_lo[i] = lo_of(qp);
    row_hi[i] = hi_of(qp);
    row_empty[i] = row_lo[i] > row_hi[i];
    if (row_empty[i]) {
      row_lo[i] = 0;
      row_hi[i] = Sk - 1;
    }
  }

  const bf16* qbase = q + b * qs.b + h * qs.h + q0 * qs.s;
  const bf16* kbase = k + b * ks.b + kvh * ks.h;
  const bf16* vbase = v + b * vs.b + kvh * vs.h;
  // 16-byte copies; rows past nq / Sk and columns past hd are zero-filled
  for (int i = tid; i < kMmaRows * CH; i += kGroupThreads * GR) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const bool in = r < nq && c < hd;
    cp_async16(sQ + r * P + c, in ? qbase + r * qs.s + c : qbase, in);
  }
  const int gtid = tid % kGroupThreads;  // thread in group
  auto load_kv = [&](int stage, int kb0) {
    bf16* sk = ring + stage * 2 * BK * P;
    bf16* sv = sk + BK * P;
    for (int i = gtid; i < BK * CH; i += kGroupThreads) {
      const int r = i / CH;
      const int c = (i % CH) * 8;
      const bool in = kb0 + r < Sk && c < hd;
      cp_async16(sk + r * P + c,
                 in ? kbase + (kb0 + r) * ks.s + c : kbase, in);
      cp_async16(sv + r * P + c,
                 in ? vbase + (kb0 + r) * vs.s + c : vbase, in);
    }
  };

  // group grp sweeps tiles t_first + grp, + GR, ...: two groups split a
  // block's sweep, so its latency is half a lone sweep's
  const int t_first = k_lo / BK + grp;
  const int t_last = k_hi / BK;
  if (t_first <= t_last) load_kv(0, t_first * BK);
  cp_async_commit();  // group: Q and this warp group's first tile
  cp_async_wait_group<0>();
  __syncthreads();

  // ldmatrix row addresses of this lane: A fragments (Q) take rows
  // (lane & 15) and column half (lane >> 4); B fragments (K) keys
  // (lane & 7) + 8 (lane >> 4) and column half ((lane >> 3) & 1);
  // transposed B fragments (V) keys (lane & 15), column half (lane >> 4)
  const bf16* qa = sQ + (wq * 16 + (lane & 15)) * P + (lane >> 4) * 8;
  const int kb_off =
      ((lane & 7) + 8 * (lane >> 4)) * P + ((lane >> 3) & 1) * 8;
  const int vb_off = (lane & 15) * P + (lane >> 4) * 8;

  uint32_t qf[kQInRegs ? KT : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) ldmatrix_x4(qf[kt], qa + kt * 16);
  }
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)

  for (int t = t_first, it = 0; t <= t_last; t += GR, ++it) {
    const int stage = it & 1;
    if (it > 0) {
      cp_async_wait_group<0>();  // tile t has landed ...
      group_sync(grp);           // ... for the group; stage ^ 1 is free
    }
    if (t + GR <= t_last) load_kv(stage ^ 1, (t + GR) * BK);
    cp_async_commit();
    const bf16* sk = ring + stage * 2 * BK * P;
    const bf16* sv = sk + BK * P;

    // S = Q.K^T, f32 accumulators
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
    // per k-step: every K fragment of the tile loaded, then its mmas
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kt][e];
      } else {
        ldmatrix_x4(a, qa + kt * 16);
      }
      uint32_t kb[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {
        ldmatrix_x4(kb[n], sk + n * 16 * P + kb_off + kt * 16);
      }
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {
        mma_bf16(s[2 * n], a, kb[n][0], kb[n][1]);
        mma_bf16(s[2 * n + 1], a, kb[n][2], kb[n][3]);
      }
    }

    // scores in log2 units; mask only a tile some row does not keep whole
    const int kb0 = t * BK;
    const bool masked = any_empty || kb0 < all_lo || kb0 + BK - 1 > all_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[n][e] * sl2;
        if (masked) {
          const int key = kb0 + n * 8 + 2 * t4 + (e & 1);
          const bool keep = key >= row_lo[i] && key <= row_hi[i];
          x = !keep ? -CUDART_INF_F : (row_empty[i] ? 0.f : x);
        }
        s[n][e] = x;
      }
    }

    // online softmax: the row max over the lane quad
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = exp2f(m[i] - mx);
      m[i] = mx;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // P in two bf16 parts from registers, hi = P rounded and lo = P - hi
    // rounded (about 16 significant bits together): S n-tiles 2j and
    // 2j + 1 are the A fragment of key step j; O += P_hi.V + P_lo.V
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      // A-fragment order: (row g, row g + 8) of n-tile 2j, then of 2j + 1
      const float p[8] = {
          exp2f(s[2 * j][0] - m[0]),     exp2f(s[2 * j][1] - m[0]),
          exp2f(s[2 * j][2] - m[1]),     exp2f(s[2 * j][3] - m[1]),
          exp2f(s[2 * j + 1][0] - m[0]), exp2f(s[2 * j + 1][1] - m[0]),
          exp2f(s[2 * j + 1][2] - m[1]), exp2f(s[2 * j + 1][3] - m[1])};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi[r] = pack_bf16_rn(p[2 * r], p[2 * r + 1]);
        lo[r] = pack_bf16_rn(p[2 * r] - bf16_lo(hi[r]),
                             p[2 * r + 1] - bf16_hi(hi[r]));
      }
      l[0] += (p[0] + p[1]) + (p[4] + p[5]);
      l[1] += (p[2] + p[3]) + (p[6] + p[7]);
      // V fragments of VG column pairs at a time; every hi product of
      // the group before its lo products, so no product waits on the
      // accumulator the previous one wrote
#pragma unroll
      for (int d0 = 0; d0 < DT; d0 += 2 * VG) {
        uint32_t vb[VG][4];
#pragma unroll
        for (int u = 0; u < VG; ++u) {
          ldmatrix_x4_trans(vb[u],
                            sv + j * 16 * P + vb_off + (d0 + 2 * u) * 8);
        }
#pragma unroll
        for (int u = 0; u < VG; ++u) {
          mma_bf16(o[d0 + 2 * u], hi, vb[u][0], vb[u][1]);
          mma_bf16(o[d0 + 2 * u + 1], hi, vb[u][2], vb[u][3]);
        }
#pragma unroll
        for (int u = 0; u < VG; ++u) {
          mma_bf16(o[d0 + 2 * u], lo, vb[u][0], vb[u][1]);
          mma_bf16(o[d0 + 2 * u + 1], lo, vb[u][2], vb[u][3]);
        }
      }
    }
  }
  cp_async_wait_group<0>();

  // with two groups, group 1 hands (m, l, O) to group 0 through its own
  // ring, each thread its fragments at [warp][value][lane]; group 0
  // merges, in that order
  if constexpr (GR == 2) {
    constexpr int XV = DT * 4 + 4;  // values a thread hands over
    static_assert(kMmaRows / 16 * XV * 32 * 4 <= RING * 2,
                  "the hand-over must fit in one group's ring");
    float* xch = reinterpret_cast<float*>(sQ + kMmaRows * P + RING) +
                 wq * XV * 32 + lane;
    if (grp == 1) {
      group_sync(1);  // every warp of the group is done with the ring
#pragma unroll
      for (int d = 0; d < DT; ++d) {
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(d * 4 + e) * 32] = o[d][e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xch[(DT * 4 + i) * 32] = m[i];
        xch[(DT * 4 + 2 + i) * 32] = l[i];
      }
    }
    __syncthreads();
    if (grp == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = xch[(DT * 4 + i) * 32];
      const float mx = fmaxf(m[i], m1);
      a0[i] = exp2f(m[i] - mx);
      a1[i] = exp2f(m1 - mx);
      l[i] = l[i] * a0[i] + xch[(DT * 4 + 2 + i) * 32] * a1[i];
      m[i] = mx;
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[d][e] = o[d][e] * a0[e >> 1] + xch[(d * 4 + e) * 32] * a1[e >> 1];
      }
    }
  }

  // normalise, stage the warp's 16 rows in its own rows of sQ, and store
  // them in 16-byte chunks
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    // the row's natural log-sum-exp of the scaled scores, for the backward
    const int row = wq * 16 + g + 8 * i;
    if (lse != nullptr && t4 == 0 && row < nq) {
      lse[(static_cast<long long>(b) * H + h) * Sq + q0 + row] =
          (m[i] + log2f(l[i])) * 0.6931471805599453f;
    }
  }
  bf16* so = sQ + wq * 16 * P;
  __syncwarp();
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = d * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(so + g * P + c) =
        pack_bf16_rn(o[d][0] * inv[0], o[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * P + c) =
        pack_bf16_rn(o[d][2] * inv[1], o[d][3] * inv[1]);
  }
  __syncwarp();
  bf16* obase = out + b * os.b + h * os.h;
  const int hd_chunks = hd / 8;
  for (int i = lane; i < 16 * hd_chunks; i += 32) {
    const int r = i / hd_chunks;
    const int c = (i % hd_chunks) * 8;
    const int row = wq * 16 + r;
    if (row < nq) {
      *reinterpret_cast<uint4*>(obase + (q0 + row) * os.s + c) =
          *reinterpret_cast<const uint4*>(so + r * P + c);
    }
  }
}

template <int HDP, int GR>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int KV, int Sq, int Sk, int hd,
               Strides qs, Strides ks, Strides vs, Strides os, int causal,
               int window, int q_offset, float scale, int blocks,
               cudaStream_t stream) {
  constexpr int BK = key_tile(HDP);
  constexpr int bytes = mma_smem(HDP, GR);
  // the attribute is the function's on each device: set it once per device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(flash_mma_kernel<HDP, BK, GR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const dim3 grid(H, blocks, B);
  flash_mma_kernel<HDP, BK, GR><<<grid, kGroupThreads * GR, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, H, KV, Sq,
      Sk, hd, qs, ks, vs, os, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// SMs of the current device, read once per device
int sm_count(int* sms) {
  static int count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && count[dev] > 0) {
    *sms = count[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) count[dev] = *sms;
  return 0;
}

// One warp group a CTA where the grid fills two CTAs on every SM (their
// loads and epilogues overlap each other's sweeps); two groups splitting
// each block's sweep where it does not, and the heaviest blocks' serial
// sweeps would set the time
template <int HDP>
int launch_groups(const void* q, const void* k, const void* v, void* out,
                  float* lse, int B, int H, int KV, int Sq, int Sk, int hd,
                  Strides qs, Strides ks, Strides vs, Strides os, int causal,
                  int window, int q_offset, float scale, cudaStream_t stream) {
  const int blocks = (Sq + kMmaRows - 1) / kMmaRows;
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  if (static_cast<long long>(H) * blocks * B >= 2LL * sms) {
    return launch_mma<HDP, 1>(q, k, v, out, lse, B, H, KV, Sq, Sk, hd, qs,
                              ks, vs, os, causal, window, q_offset, scale,
                              blocks, stream);
  }
  return launch_mma<HDP, 2>(q, k, v, out, lse, B, H, KV, Sq, Sk, hd, qs, ks,
                            vs, os, causal, window, q_offset, scale, blocks,
                            stream);
}

// the template of the smallest padded width that holds hd
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int H, int KV, int Sq, int Sk, int hd,
                Strides qs, Strides ks, Strides vs, Strides os, int causal,
                int window, int q_offset, float scale, cudaStream_t stream) {
#define REPRO_FLASH_MMA(HDP)                                               \
  return launch_groups<HDP>(q, k, v, out, lse, B, H, KV, Sq, Sk, hd, qs, ks, \
                            vs, os, causal, window, q_offset, scale, stream)
  if (hd <= 16) REPRO_FLASH_MMA(16);
  if (hd <= 32) REPRO_FLASH_MMA(32);
  if (hd <= 64) REPRO_FLASH_MMA(64);
  if (hd <= 128) REPRO_FLASH_MMA(128);
  REPRO_FLASH_MMA(256);
#undef REPRO_FLASH_MMA
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Strides are in elements, for
// the (batch, head, sequence) dimensions; the head dimension is
// contiguous.  window 0 disables the sliding window.  lse, when not null,
// receives each row's natural log-sum-exp of its scaled scores, f32
// [B, H, Sq] contiguous (what the backward, flash_attention_bwd.cu,
// recomputes P from); the serving path passes null.  Returns
// cudaGetLastError() after the launch (or the attribute call's error).
extern "C" int launch_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse_out,
    int B, int H,
    int KV, int Sq, int Sk, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, int q_offset,
    float scale, int dtype, void* stream) {
  if (hd % 8 != 0 || hd < 8 || hd > kMaxHd || KV < 1 || H % KV != 0 ||
      Sq < 1 || Sk < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (dtype == 0) {
    return launch_f32(q, k, v, out, lse, B, H, KV, Sq, Sk, hd, qs, ks, vs, os,
                      causal, window, q_offset, scale, s);
  }
  if (dtype == 1) {
    return launch_bf16(q, k, v, out, lse, B, H, KV, Sq, Sk, hd, qs, ks, vs, os,
                       causal, window, q_offset, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
