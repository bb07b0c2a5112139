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
// Design (simple first, CUDA-core FMAs in f32): one CTA of 8 warps per
// (batch, head, block of 64 query rows), heaviest causal blocks first.
// The Q block and one 32-key block of K and V at a time are staged in
// shared memory as f32 (16-byte global loads; rows padded by 4 floats so
// the 32 lanes' K rows fall in distinct banks).  Warp w owns rows
// 8w..8w+7: for S = Q.K^T lane j takes key j of the block; for P.V lane j
// takes columns 4j..4j+3 (and 128+4j.. when hd > 128), with P passed
// through shared memory.  Shared memory: (128 (hd + 4) + 2048) floats,
// 141 KB at hd 256, set by cudaFuncSetAttribute.
//
// Bound: at the prefill shapes attention does 4 hd operations per kept
// (query, key) pair on inputs read once: compute-bound against the bf16
// tensor cores (989 TFLOP/s) once prompts are a few hundred tokens long,
// bytes-bound (3.35 TB/s) below that.  CUDA-core FMAs reach a few per
// cent of the tensor-core bound; mma.sync / wgmma tiles, double-buffered
// (TMA) K/V loads and keeping P in registers are later work.

#include "common.cuh"

namespace {

using repro_torch::kNegInf;
using repro_torch::load8;
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

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162 h[2];
  h[0] = __floats2bfloat162_rn(x[0], x[1]);
  h[1] = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
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
             const T* __restrict__ v, T* __restrict__ out, int H, int KV,
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
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int Sq, int Sk, int hd, Strides qs, Strides ks,
           Strides vs, Strides os, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      ((kBQ + 2 * kBK) * (hd + 4) + kWarps * kBK * kRows) * sizeof(float);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, NC><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, Sq, Sk, hd, qs,
      ks, vs, os, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int H, int KV, int Sq, int Sk, int hd, Strides qs, Strides ks,
              Strides vs, Strides os, int causal, int window, int q_offset,
              float scale, cudaStream_t stream) {
  if (hd <= 128) {
    return launch<T, 1>(q, k, v, out, B, H, KV, Sq, Sk, hd, qs, ks, vs, os,
                        causal, window, q_offset, scale, stream);
  }
  return launch<T, 2>(q, k, v, out, B, H, KV, Sq, Sk, hd, qs, ks, vs, os,
                      causal, window, q_offset, scale, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Strides are in elements, for
// the (batch, head, sequence) dimensions; the head dimension is
// contiguous.  window 0 disables the sliding window.  Returns
// cudaGetLastError() after the launch (or the attribute call's error).
extern "C" int launch_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H,
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
  if (dtype == 0) {
    return launch_hd<float>(q, k, v, out, B, H, KV, Sq, Sk, hd, qs, ks, vs,
                            os, causal, window, q_offset, scale, s);
  }
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, H, KV, Sq, Sk, hd, qs,
                                    ks, vs, os, causal, window, q_offset,
                                    scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
