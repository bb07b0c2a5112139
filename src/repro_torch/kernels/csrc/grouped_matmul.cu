// Grouped (per-expert) matrix product for Hopper (sm_90a): the expert
// GEMMs of a capacity-dispatched MoE layer.
//
// Replaces the Pallas kernel of the JAX package's
// src/repro/kernels/moe_gmm.py (grouped_matmul, _gmm_kernel)
// -> launch_grouped_matmul.  It computes what that kernel computes:
//
//   x  [E, C, D]   bf16 or f32, any (expert, row) strides, rows contiguous
//   w  [E, D, F]   x's dtype, contiguous (one layer's stacked experts)
//   y  [E, C, F]   x's dtype, contiguous:  y[e] = x[e] @ w[e]
//
// with the sum over D in f32 and one rounding to x's dtype at the end.
// The TPU kernel demands C, D and F that are multiples of its blocks
// (moe_gmm.py:52-59); this one takes any sizes and masks the tails.
//
// Bound: at every serving shape of granite-moe (E 40, D/F 1536/512, C 4 at
// decode, C = ceil(S / 4) at prefill) the product moves weight bytes: one
// gate/up launch reads 62.9 MB of w for 0.25 GFLOP at C 4, and even C 256
// is bytes-bound on the tensor cores.  So the one design rule is that
// every weight element is read from HBM once per launch.
//
// Design.  bf16 with 16-byte rows (every serving shape) takes the tensor
// cores: gmm_mma_kernel, one CTA of 8 warps per (expert, 64 output
// columns), all C rows of the expert in one block of up to 256 rows, D
// swept in 64-deep chunks through a 4-stage cp.async ring in shared memory,
// mma.sync m16n8k16 with f32 accumulators (the helpers of mma.cuh).  Each
// w element is loaded once per launch (C > 256 loops over row blocks and
// reloads w from L2).
//
// f32, or bf16 with a ragged D, F or x stride, takes gmm_simple_kernel on
// the CUDA cores: one thread per (expert, output column, block of 4 rows),
// w read through L2 (each element once per 4 rows) 8 loads at a time, the
// x element of a step shared by the whole warp.  It is the reference path's and the odd
// shapes' kernel; no serving shape of a bf16 model reaches it.
//
// Later work: deeper rings and TMA loads for the decode shapes, wgmma for
// the prefill ones, and skipping the capacity rows that hold no token.

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait_group;
using repro_torch::mma_bf16;
using repro_torch::pack_bf16;

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use
constexpr int kMaxDevices = 64;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ------------------------------------------------------------ CUDA cores
constexpr int kSimpleThreads = 128;
constexpr int kRows = 4;   // rows per thread: each w element read C / 4 times
constexpr int kSteps = 8;  // w loads a thread has in flight

template <typename T>
__global__ void __launch_bounds__(kSimpleThreads)
gmm_simple_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, int C, int D, int F, long long xs_e,
                  long long xs_c) {
  const int f = blockIdx.x * kSimpleThreads + threadIdx.x;
  if (f >= F) return;
  const int e = blockIdx.y;
  const T* xe = x + static_cast<long long>(e) * xs_e;
  const T* wf = w + static_cast<long long>(e) * D * F + f;
  T* yf = y + static_cast<long long>(e) * C * F + f;
  for (int r0 = blockIdx.z * kRows; r0 < C; r0 += gridDim.z * kRows) {
    const int nr = min(kRows, C - r0);
    const T* xr = xe + static_cast<long long>(r0) * xs_c;
    // one f32 sum per row, over k in order, as the TPU kernel sums its D
    // blocks
    float acc[kRows] = {};
    for (int k0 = 0; k0 < D; k0 += kSteps) {
      float wv[kSteps];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        wv[j] = k0 + j < D ? to_f(wf[static_cast<long long>(k0 + j) * F])
                           : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i >= nr) break;
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          if (k0 + j < D) {
            acc[i] = fmaf(to_f(xr[i * xs_c + k0 + j]), wv[j], acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {  // unrolled: acc stays in registers
      if (i >= nr) break;
      yf[static_cast<long long>(r0 + i) * F] = from_f<T>(acc[i]);
    }
  }
}

template <typename T>
int launch_simple(const void* x, const void* w, void* y, int E, int C, int D,
                  int F, long long xs_e, long long xs_c, cudaStream_t stream) {
  const int row_blocks = (C + kRows - 1) / kRows;
  const dim3 grid((F + kSimpleThreads - 1) / kSimpleThreads, E,
                  row_blocks < 65535 ? row_blocks : 65535);
  gmm_simple_kernel<T><<<grid, kSimpleThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      C, D, F, xs_e, xs_c);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 MMA
// The serving path's kernel: bf16 operands on the tensor cores
// (mma.sync m16n8k16, f32 accumulators).  One CTA of 8 warps per (expert,
// 64-column tile); warp w owns the 8 columns 8w..8w+7 of every 16-row
// m-tile of the row block (MT m-tiles, BM = 16 MT <= 256 rows, so all C
// rows of a serving shape are one block and every w element is loaded
// once).  D is swept in 64-deep chunks through a 4-stage cp.async ring of
// (x chunk [BM][64], w chunk [64][64]) in shared memory, rows padded by 16
// bytes so the fragment loads are free of bank conflicts; rows past C,
// columns past F and depths past D are zero-filled by the copy.
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr int kPad = 8;  // bf16 elements of padding per smem row
constexpr int kRow = kBK + kPad;  // x chunk row (k contiguous)
constexpr int kWRow = kBN + kPad;  // w chunk row (n contiguous)

template <int MT>
__global__ void __launch_bounds__(kThreads)
gmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ y, int C, int D, int F,
               long long xs_e, long long xs_c) {
  constexpr int BM = 16 * MT;
  constexpr int kStageElems = BM * kRow + kBK * kWRow;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row / column group
  const int t4 = lane % 4;  // thread in group
  const int e = blockIdx.y;
  const int f0 = blockIdx.x * kBN;
  const __nv_bfloat16* xe = x + static_cast<long long>(e) * xs_e;
  const __nv_bfloat16* we = w + static_cast<long long>(e) * D * F;
  __nv_bfloat16* ye = y + static_cast<long long>(e) * C * F;
  const int nk = (D + kBK - 1) / kBK;

  for (int r0 = 0; r0 < C; r0 += BM) {
    // copy chunk kt into ring slot s: x rows r0.., w rows kt*BK..
    auto load = [&](int s, int kt) {
      __nv_bfloat16* xs = ring + s * kStageElems;
      __nv_bfloat16* ws = xs + BM * kRow;
      const int k0 = kt * kBK;
      for (int i = tid; i < BM * (kBK / 8); i += kThreads) {
        const int r = i / (kBK / 8);
        const int c = (i % (kBK / 8)) * 8;
        const bool in = r0 + r < C && k0 + c < D;
        cp_async16(xs + r * kRow + c,
                   in ? xe + static_cast<long long>(r0 + r) * xs_c + k0 + c
                      : xe,
                   in);
      }
      for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
        const int r = i / (kBN / 8);
        const int c = (i % (kBN / 8)) * 8;
        const bool in = k0 + r < D && f0 + c < F;
        cp_async16(ws + r * kWRow + c,
                   in ? we + static_cast<long long>(k0 + r) * F + f0 + c
                      : we,
                   in);
      }
    };

    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait_group<kStages - 2>();  // chunk kt has landed
      __syncthreads();  // ... for every thread; slot (kt-1) % S is free
      const int next = kt + kStages - 1;
      if (next < nk) load(next % kStages, next);
      cp_async_commit();
      const __nv_bfloat16* xs = ring + (kt % kStages) * kStageElems;
      const __nv_bfloat16* ws = xs + BM * kRow;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        // B fragment (k x n = 16 x 8, "col"): k pairs 2 t4 (+8), column g
        const __nv_bfloat16* wb = ws + (kk + 2 * t4) * kWRow + warp * 8 + g;
        const uint32_t b0 = pack_bf16(wb[0], wb[kWRow]);
        const uint32_t b1 = pack_bf16(wb[8 * kWRow], wb[9 * kWRow]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // A fragment (16 x 16, row): rows g (+8), k pairs 2 t4 (+8)
          const __nv_bfloat16* xa = xs + (m * 16 + g) * kRow + kk + 2 * t4;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(xa);
          a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * kRow);
          a[2] = *reinterpret_cast<const uint32_t*>(xa + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * kRow + 8);
          mma_bf16(acc[m], a, b0, b1);
        }
      }
    }
    cp_async_wait_group<0>();
    __syncthreads();  // the ring is reused by the next row block

    // C fragment: rows g and g + 8, columns 2 t4 and 2 t4 + 1
    const int col = f0 + warp * 8 + 2 * t4;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + m * 16 + g + 8 * h;
        if (r >= C) continue;
        __nv_bfloat16* yr = ye + static_cast<long long>(r) * F;
        if (col < F) yr[col] = __float2bfloat16(acc[m][2 * h]);
        if (col + 1 < F) yr[col + 1] = __float2bfloat16(acc[m][2 * h + 1]);
      }
    }
  }
}

template <int MT>
int launch_mma(const void* x, const void* w, void* y, int E, int C, int D,
               int F, long long xs_e, long long xs_c, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(kStages) *
                       (16 * MT * kRow + kBK * kWRow) * sizeof(__nv_bfloat16);
  // the attribute is the function's on each device: set it once per device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(gmm_mma_kernel<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const dim3 grid((F + kBN - 1) / kBN, E);
  gmm_mma_kernel<MT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      C, D, F, xs_e, xs_c);
  return static_cast<int>(cudaGetLastError());
}

// row block of 16 MT rows: the smallest power-of-two MT that covers C,
// at most 16 (C > 256 loops over row blocks)
int launch_bf16_mma(const void* x, const void* w, void* y, int E, int C,
                    int D, int F, long long xs_e, long long xs_c,
                    cudaStream_t stream) {
  if (C <= 16) return launch_mma<1>(x, w, y, E, C, D, F, xs_e, xs_c, stream);
  if (C <= 32) return launch_mma<2>(x, w, y, E, C, D, F, xs_e, xs_c, stream);
  if (C <= 64) return launch_mma<4>(x, w, y, E, C, D, F, xs_e, xs_c, stream);
  if (C <= 128) return launch_mma<8>(x, w, y, E, C, D, F, xs_e, xs_c, stream);
  return launch_mma<16>(x, w, y, E, C, D, F, xs_e, xs_c, stream);
}

}  // namespace

extern "C" int launch_grouped_matmul(const void* x, const void* w, void* y,
                                     int E, int C, int D, int F,
                                     long long xs_e, long long xs_c,
                                     int dtype, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_simple<float>(x, w, y, E, C, D, F, xs_e, xs_c, s);
  }
  if (dtype == 1) {
    // the tensor-core kernel needs 16-byte rows: D, F and the x strides
    // multiples of 8 elements, x and w 16-byte aligned
    const bool rows16 = D % 8 == 0 && F % 8 == 0 && xs_e % 8 == 0 &&
                        xs_c % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (rows16) return launch_bf16_mma(x, w, y, E, C, D, F, xs_e, xs_c, s);
    return launch_simple<__nv_bfloat16>(x, w, y, E, C, D, F, xs_e, xs_c,
                                         s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
