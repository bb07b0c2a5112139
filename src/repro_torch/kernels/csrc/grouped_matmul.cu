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
// Its backward, both gradients in one launch, is grouped_matmul_bwd.cu
// (the training path ran this kernel twice on transposed copies before).
//
// Bound (3.35 TB/s, 989 TFLOP/s bf16, granite-moe: E 40, D/F 1536/512):
// every serving shape moves bytes.  Decode (C 4) reads 62.9 MB of w for
// 0.25 GFLOP: 0.019 ms; a 1024-token prefill (C 256) reads w, x and
// writes y, 104.9 MB for 16.1 GFLOP: 0.031 ms of bytes against 0.016 ms
// of products.  Every w element is read from HBM once per launch; the
// second reads of x and w (the tiles of one expert) are L2 hits.
//
// Design.  bf16 with 16-byte rows (every serving shape) takes
// gmm_tma_kernel at every capacity: 64 x 128 output tiles, TMA copies
// into a 3-deep ring of shared memory fed by a producer warp, wgmma
// m64n128k16 in one consumer warpgroup (see the kernel's note; the wgmma,
// descriptor, mbarrier and TMA helpers are hopper.cuh's).  90
// registers and 73 KB of shared memory a CTA (ptxas -v, the flags of
// _build.py; no spills), so three CTAs share an SM.  The weights' TMA
// maps are kept between calls.  Measured against it on the H100
// (PERF.md), and lost at every capacity: 128-row tiles (two consumer
// warpgroups) and 256-column ones, which fit fewer CTAs on an SM;
// clusters of 2 and 4 row tiles sharing w by TMA multicast; and mma.sync
// tiles fed by cp.async, with or without a split of D at decode (w's
// bytes bound decode, not the number of CTAs).  At C 256 the 640 tiles
// fill 1.6 waves of the card's 396 CTA slots, which costs about a fifth.
//
// f32, or bf16 with a ragged D, F or x stride, takes gmm_simple_kernel on
// the CUDA cores: one thread per (expert, output column, block of 4 rows),
// w read through L2 (each element once per 4 rows) 8 loads at a time, the
// x element of a step shared by the whole warp.  It is the reference
// path's and the odd shapes' kernel; no serving shape of a bf16 model
// reaches it.  Its in-order sum is the only order that held 1e-5.

#include <cuda.h>

#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro_torch::fence_regs;
using repro_torch::mbar_arrive;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_init;
using repro_torch::mbar_init_fence;
using repro_torch::mbar_wait;
using repro_torch::smem_desc;
using repro_torch::smem_u32;
using repro_torch::tma_load3;
using repro_torch::wgmma_commit;
using repro_torch::wgmma_fence;
using repro_torch::wgmma_ss_m64n128k16;
using repro_torch::wgmma_wait;

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

// ------------------------------------------------------ the bf16 kernel
// gmm_tma_kernel: one CTA per (64-row tile, 128 columns, expert), blocks
// numbered row tile fastest, then column tile, then expert, so the tiles
// of one expert run side by side and the second reads of its x and w come
// from L2.  Five warps:
//   - the last is the producer: one lane issues, for each 64-deep chunk
//     of D, one TMA copy of the x box [64 rows][64] and two of the w boxes
//     [64][64 columns] into a free slot of a 3-deep ring, and arms the
//     slot's "full" barrier with their byte count;
//   - warps 0-3 are one consumer warpgroup: it waits on the slot's full
//     barrier, runs four wgmma m64n128k16 on it (A = x and B = w read from
//     shared memory through descriptors, f32 accumulators in registers),
//     and once the products of a chunk are done arrives on its slot's
//     "empty" barrier, which the producer waits on before refilling it.
// No CTA-wide barrier in the loop.  The ring holds what the descriptors
// name, in the 128-byte swizzle that TMA writes:
//   x box, K-major: row r at 128 r bytes, its 16-byte piece j at
//     (j ^ (r % 8)) * 16; 8-row groups 1024 bytes apart (SBO);
//   w boxes, N-major: two 64-column halves 8192 bytes apart (LBO), row k
//     of a half at 128 k bytes, piece j at (j ^ (k % 8)) * 16; 8-row
//     groups 1024 bytes apart (SBO).
// A step of 16 in K moves the x descriptor by 32 bytes and the w one by
// 2048.  TMA fills the boxes' rows past C, columns past F and depths past
// D with zeros, so every tail is exact.
constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kXBytes = kBM * kBK * 2;     // 8 KB
constexpr int kWBytes = kBK * kBN * 2;     // 16 KB
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kTmaThreads = kConsumers + 32;
// the ring, and room to align it to the swizzle's 1024 bytes
constexpr size_t kTmaSmem = static_cast<size_t>(kStages) * kStageBytes + 1024;

__global__ void __launch_bounds__(kTmaThreads)
gmm_tma_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               __nv_bfloat16* __restrict__ y, int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kBM;
  const int f0 = blockIdx.y * kBN;
  const int e = blockIdx.z;
  const int nk = (D + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp; one lane issues
    if (tid == kConsumers) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        unsigned char* xs = ring + s * kStageBytes;
        unsigned char* ws = xs + kXBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load3(xs, &map_x, kt * kBK, r0, e, &full[s]);
        tma_load3(ws, &map_w, f0, kt * kBK, e, &full[s]);
        tma_load3(ws + 8192, &map_w, f0 + 64, kt * kBK, e, &full[s]);
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const unsigned char* xs = ring + s * kStageBytes;
    const unsigned char* ws = xs + kXBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_ss_m64n128k16<1>(acc, smem_desc(xs + kk * 32, 16, 1024),
                             smem_desc(ws + kk * 2048, 8192, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // chunk kt - 1's products are done: free its slot
    fence_regs(acc);
    if (kt > 0 && tid == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the C layout: rows 16 (warp) + lane / 4 (+ 8), columns 8 j + 2 (lane
  // % 4) (+ 1); F is a multiple of 8, so both columns are in or out
  const int lane = tid % 32;
  const int row = r0 + (tid / 32) * 16 + lane / 4;
  __nv_bfloat16* ye = y + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = f0 + 8 * j + 2 * (lane % 4);
    if (col >= F) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= C) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          ye + static_cast<long long>(r) * F + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// A 3-D bf16 map (dims innermost first, strides of dims 1 and 2 in
// elements) with a box of (64, box1, 1) and the 128-byte swizzle.  Maps
// are kept by everything they encode (the weights' maps repeat every
// call; the caching allocator often hands x the same address), 256 of
// them, replaced round robin.
struct MapKey {
  const void* ptr;
  long long d0, d1, d2, s1, s2;
  int box1;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && d0 == o.d0 && d1 == o.d1 && d2 == o.d2 &&
           s1 == o.s1 && s2 == o.s2 && box1 == o.box1;
  }
};

constexpr int kMaps = 256;
std::mutex map_lock;
MapKey map_keys[kMaps];
CUtensorMap map_vals[kMaps];
int map_used = 0, map_next = 0;

int make_map(CUtensorMap* out, const MapKey& k) {
  std::lock_guard<std::mutex> guard(map_lock);
  for (int i = 0; i < map_used; ++i) {
    if (map_keys[i] == k) {
      *out = map_vals[i];
      return 0;
    }
  }
  repro_torch::EncodeTiled encode = repro_torch::tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k.d0),
                              static_cast<cuuint64_t>(k.d1),
                              static_cast<cuuint64_t>(k.d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k.s1) * 2,
                                 static_cast<cuuint64_t>(k.s2) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(k.box1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(k.ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slot = map_used < kMaps ? map_used++ : map_next++ % kMaps;
  map_keys[slot] = k;
  map_vals[slot] = *out;
  return 0;
}

int launch_bf16_tma(const void* x, const void* w, void* y, int E, int C,
                    int D, int F, long long xs_e, long long xs_c,
                    cudaStream_t stream) {
  CUtensorMap mx, mw;
  // x [E][C][D] through its strides; w [E][D][F] contiguous
  int err = make_map(&mx, MapKey{x, D, C, E, xs_c, xs_e, kBM});
  if (err != 0) return err;
  err = make_map(&mw, MapKey{w, F, D, E, F, static_cast<long long>(D) * F,
                             kBK});
  if (err != 0) return err;
  // the attribute is the function's on each device: set it once per device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  if (dev >= kMaxDevices || !allowed[dev]) {
    cerr = cudaFuncSetAttribute(gmm_tma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kTmaSmem));
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const dim3 grid((C + kBM - 1) / kBM, (F + kBN - 1) / kBN, E);
  gmm_tma_kernel<<<grid, kTmaThreads, kTmaSmem, stream>>>(
      mx, mw, static_cast<__nv_bfloat16*>(y), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch.
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
    // TMA needs 16-byte rows: D, F and the x strides multiples of 8
    // elements, x and w 16-byte aligned
    const bool rows16 = D % 8 == 0 && F % 8 == 0 && xs_e % 8 == 0 &&
                        xs_c % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (rows16) return launch_bf16_tma(x, w, y, E, C, D, F, xs_e, xs_c, s);
    return launch_simple<__nv_bfloat16>(x, w, y, E, C, D, F, xs_e, xs_c,
                                         s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
