// The backward of the grouped (per-expert) matrix product K5
// (grouped_matmul.cu) for Hopper (sm_90a): both gradients of
// y[e] = x[e] @ w[e] in one launch,
//
//   dx [E, C, D]   dx[e] = dy[e] @ w[e]^T     (summed over F)
//   dw [E, D, F]   dw[e] = x[e]^T @ dy[e]     (summed over C)
//
// from x [E, C, D] (any expert and row strides, rows contiguous: the
// forward's saved input, possibly the dispatch's view), w [E, D, F] and
// dy [E, C, F] contiguous, in x's dtype, every sum in f32 and rounded
// once.  Nothing is copied or transposed in device memory.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, and
// XLA differentiates its expert einsums (src/repro/models/blocks.py,
// "becd,edf->becf" and "becf,efd->becd").  Before this source the port
// ran K5 twice for it, each time on a transposed contiguous copy (of w
// for dx, of x for dw), since K5 contracts only over its x rows'
// contiguous axis.
//
// Bound (3.35 TB/s, 989 TFLOP/s bf16; granite-moe training, E 40, C 1,024
// = two sequences at capacity 512, D/F 1,536/512 for gate/up, swapped for
// down): one product reads its two operands and writes its result once,
// 230.7 MB for 64.4 GFLOP, 0.069 ms of bytes against 0.065 ms of
// products; the pair reads x, w and dy once and writes dx and dw once,
// 419.4 MB for gate/up (0.125 ms) and 335.5 MB for down (0.100 ms), for
// 128.8 GFLOP (0.130 ms): bound by operations.
//
// bf16 with 16-byte rows (D and F multiples of 8, x's strides too; every
// training shape of a bf16 model) takes gmm_bwd_tma_kernel: 128 x 256
// output tiles on two consumer warpgroups (wgmma m64n256k16, 128 f32
// accumulators a thread), fed by a producer warpgroup that gives up its
// registers (setmaxnreg: 24 and 240 a thread) and keeps a 4-deep ring
// of 48 KB stages full by TMA (128-byte swizzle, 64 x 64 boxes read in
// place: depths past the contraction read as zeros; boxes wholly past
// the tile's rows or columns are not loaded, and those outputs are not
// stored).  The two products differ only in how a stage is read:
//   dx: A = dy[e] tiles, K = F contiguous (K-major); B = w[e] rows, N = D,
//       K = F contiguous (K-major, TB 0);
//   dw: A = x[e]^T, M = D contiguous (MN-major: the A-transpose bit,
//       TA 1); B = dy[e], N = F contiguous (MN-major, TB 1); the
//       contraction runs down C.
// Each warpgroup stages its 64 x 256 outputs in shared memory, 128
// columns at a time, and TMA stores them (rows past C or D and columns
// past D or F are clipped), so that the next tile's products start as
// soon as a tile is staged.  ptxas -v (the flags of _build.py): 168
// registers at launch (the consumers take 240 by setmaxnreg), no spills;
// 230,400 bytes of dynamic shared memory (the ring, the two warpgroups'
// 16 KB output boxes, the alignment), so one CTA an SM.
// The grid is persistent, one CTA an SM: each walks tiles CTA, CTA +
// grid, ... over the union of both products' tiles, expert by expert (an
// expert's dw tiles, then its dx tiles), so that the CTAs in flight share
// two or three experts' operands in L2 and dy[e] comes from HBM about
// once; the ring runs on across a CTA's tiles, so the next tile's loads
// overlap this one's stores.  At granite's shapes the union is 960 dw and
// 1,920 dx tiles (gate/up) and 960 dw and 640 dx tiles (down); a static
// walk in that order leaves the busiest CTA 2.5 % (gate/up) and 9.5 %
// (down) above the mean.  A 128 x 256 tile stages 48 KB for 4.2 MFLOP a
// 64-deep step, twice K5's 64 x 128 tile's operations a byte (K5 is sized
// for serving, C 4 to 256, where bytes bound it).
// Measured on the H100 (PERF.md) at granite's shapes, gate/up and down,
// and lost: the tile's outputs stored straight from the accumulators
// (4-byte stores; 0.322 and 0.256 ms against 0.212 and 0.201: the
// consumers stall on them between tiles, 0.189 ms with no store at all);
// a whole 64 x 256 output box a warpgroup, which leaves room for 3 ring
// stages only (0.234, 0.229); 64-column output boxes (0.215, 0.203),
// double-buffered so that staging never waits on a store's read (no
// change); dx tiles before dw tiles in an expert (no change, with the
// register stores).

// Determinism: each output element is one CTA's f32 sum over the whole
// contraction, in one order (64-deep steps in order, wgmma's order inside
// a step); no split of the contraction, no atomics.
//
// f32, or bf16 with a ragged D, F or x stride (the train-reference
// check's f32 runs, odd smoke widths), takes gmm_bwd_simple_kernel on the
// CUDA cores: 64 x 64 output tiles of either product (grid z = 2 E + the
// product), 16-deep chunks of both operands staged in shared memory
// through their strides, each thread a 4 x 4 block summed with fmaf over
// the contraction in order from 0: the order of K5's CUDA-core kernel,
// the one that holds 1e-5 against the plain version in f32.

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro_torch::bulk_commit;
using repro_torch::bulk_wait;
using repro_torch::bulk_wait_read;
using repro_torch::fence_proxy_async;
using repro_torch::fence_regs;
using repro_torch::mbar_arrive;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_init;
using repro_torch::mbar_init_fence;
using repro_torch::mbar_wait;
using repro_torch::named_barrier;
using repro_torch::setmaxnreg_dec;
using repro_torch::setmaxnreg_inc;
using repro_torch::smem_desc;
using repro_torch::smem_u32;
using repro_torch::tma_load3;
using repro_torch::tma_store3;
using repro_torch::wgmma_commit;
using repro_torch::wgmma_fence;
using repro_torch::wgmma_ss_m64n256k16;
using repro_torch::wgmma_wait;

using bf16 = __nv_bfloat16;

constexpr int kMaxDevices = 64;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// ------------------------------------------------------------ CUDA cores
// out[e] (M x N, contiguous) = A(e) (M x K) . B(e) (K x N), A and B read
// through element strides: dx (product 0) A = dy[e] (i c, k f), B = w[e]^T
// (k f, j d); dw (product 1) A = x[e]^T (i d, k c), B = dy[e] (k c, j f).
constexpr int kST = 64;       // output tile rows and columns
constexpr int kSK = 16;       // depth of a staged chunk
constexpr int kSThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(kSThreads)
gmm_bwd_simple_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      T* __restrict__ dw, int C, int D, int F, long long xs_e,
                      long long xs_c) {
  const int e = blockIdx.z >> 1;
  const bool is_dw = blockIdx.z & 1;
  const int M = is_dw ? D : C, N = is_dw ? F : D, K = is_dw ? C : F;
  const int m0 = blockIdx.y * kST, n0 = blockIdx.x * kST;
  if (m0 >= M || n0 >= N) return;
  const long long cf = static_cast<long long>(C) * F;
  const T* a;
  const T* b;
  long long sa_i, sa_k, sb_k, sb_j;
  if (is_dw) {
    a = x + e * xs_e, sa_i = 1, sa_k = xs_c;
    b = dy + e * cf, sb_k = F, sb_j = 1;
  } else {
    a = dy + e * cf, sa_i = F, sa_k = 1;
    b = w + e * static_cast<long long>(D) * F, sb_k = 1, sb_j = F;
  }
  T* out = (is_dw ? dw + e * static_cast<long long>(D) * F : dx + e *
            static_cast<long long>(C) * D);

  // rows padded by 4 floats: the k-fastest stores spread over the banks
  __shared__ __align__(16) float sa[kSK][kST + 4];
  __shared__ __align__(16) float sb[kSK][kST + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSK) {
    // stage A (64 x 16) and B (16 x 64), the contiguous axis fastest
    // across threads; zeros past M, N and K
#pragma unroll
    for (int u = 0; u < kST * kSK / kSThreads; ++u) {
      const int idx = tid + u * kSThreads;
      int i, k;
      if (sa_k == 1) {
        k = idx % kSK, i = idx / kSK;
      } else {
        i = idx % kST, k = idx / kST;
      }
      sa[k][i] = m0 + i < M && k0 + k < K
                     ? to_f(a[(m0 + i) * sa_i + (k0 + k) * sa_k])
                     : 0.f;
      int j;
      if (sb_k == 1) {
        k = idx % kSK, j = idx / kSK;
      } else {
        j = idx % kST, k = idx / kST;
      }
      sb[k][j] = n0 + j < N && k0 + k < K
                     ? to_f(b[(k0 + k) * sb_k + (n0 + j) * sb_j])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {  // in order over the contraction
      const float4 av = *reinterpret_cast<const float4*>(&sa[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[kk][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
    if (r >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tx + j;
      if (c < N) out[static_cast<long long>(r) * N + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_simple(const void* x, const void* w, const void* dy, void* dx,
                  void* dw, int E, int C, int D, int F, long long xs_e,
                  long long xs_c, cudaStream_t stream) {
  const int rows = (C > D ? C : D), cols = (D > F ? D : F);
  const dim3 grid((cols + kST - 1) / kST, (rows + kST - 1) / kST, 2 * E);
  gmm_bwd_simple_kernel<T><<<grid, kSThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<T*>(dw), C,
      D, F, xs_e, xs_c);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ the bf16 kernel
// A stage: A, two 64 x 64 boxes (one per consumer warpgroup's 64 rows),
// then B, four boxes (the tile's 256 columns), each box 8 KB of [64 rows]
// [64] bf16 in the 128-byte swizzle.  How the descriptors read them (see
// hopper.cuh):
//   dx, K-major: box rows are M (A) or N (B), 64 of K along a row; a k16
//     step moves both starts 32 bytes; B's four boxes are one [256][64]
//     K-major block (8-row groups 1024 bytes apart throughout);
//   dw, MN-major: box rows are K (C), 64 of M (A, one box a warpgroup) or
//     N (B, boxes 8 KB apart: LBO) along a row; a k16 step moves both
//     starts 16 rows, 2048 bytes.
constexpr int kBM = 128;
constexpr int kBN = 256;
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr int kBox = 64 * 64 * 2;
constexpr int kABytes = 2 * kBox;
constexpr int kStageBytes = kABytes + 4 * kBox;  // 48 KB
// a warpgroup stages its 64 x 256 outputs for the TMA stores kOutCols
// columns at a time, in boxes like the ring's
constexpr int kOutCols = 128;
constexpr int kOutBytes = 64 * kOutCols * 2;
constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kTmaThreads = kConsumers + 128;    // and the producer's
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536,
              "the register file is 65536 registers");
// the ring, each warpgroup's output boxes, and room to align them to the
// swizzle's 1024 bytes
constexpr size_t kTmaSmem =
    static_cast<size_t>(kStages) * kStageBytes + 2 * kOutBytes + 1024;

struct Tiles {
  int C, D, F;
  int dw_n;       // dw tiles across F
  int dw_tiles;   // dw tiles of an expert
  int dx_n;       // dx tiles across D
  int per_expert;
  int total;
};

struct Tile {
  bool is_dw;
  int e, m0, n0, nk;
};

__device__ __forceinline__ Tile tile_at(const Tiles& t, int i) {
  Tile r;
  r.e = i / t.per_expert;
  int j = i % t.per_expert;
  r.is_dw = j < t.dw_tiles;
  if (r.is_dw) {
    r.m0 = (j / t.dw_n) * kBM;
    r.n0 = (j % t.dw_n) * kBN;
    r.nk = (t.C + kBK - 1) / kBK;
  } else {
    j -= t.dw_tiles;
    r.m0 = (j / t.dx_n) * kBM;
    r.n0 = (j % t.dx_n) * kBN;
    r.nk = (t.F + kBK - 1) / kBK;
  }
  return r;
}

__global__ void __launch_bounds__(kTmaThreads, 1)
gmm_bwd_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_dy,
                   const __grid_constant__ CUtensorMap map_dx,
                   const __grid_constant__ CUtensorMap map_dw,
                   const Tiles tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup; one thread issues
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      int it = 0;  // the CTA's 64-deep steps so far, over all its tiles
      for (int i = blockIdx.x; i < tiles.total; i += gridDim.x) {
        const Tile t = tile_at(tiles, i);
        for (int kt = 0; kt < t.nk; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
          unsigned char* a = ring + s * kStageBytes;
          unsigned char* b = a + kABytes;
          const int k0 = kt * kBK;
          // boxes wholly past M or N are not loaded: their rows and
          // columns of the tile are never stored
          const int M = t.is_dw ? tiles.D : tiles.C;
          const int N = t.is_dw ? tiles.F : tiles.D;
          const int na = t.m0 + 64 < M ? 2 : 1;
          const int nb = min(4, (N - t.n0 + 63) / 64);
          mbar_expect_tx(&full[s], (na + nb) * kBox);
          if (t.is_dw) {  // x[e] rows k0.. (C), columns m0.. (D)
            for (int j = 0; j < na; ++j) {
              tma_load3(a + j * kBox, &map_x, t.m0 + 64 * j, k0, t.e,
                        &full[s]);
            }
            for (int j = 0; j < nb; ++j) {  // dy[e] rows k0.., columns n0..
              tma_load3(b + j * kBox, &map_dy, t.n0 + 64 * j, k0, t.e,
                        &full[s]);
            }
          } else {  // dy[e] rows m0.. (C), columns k0.. (F)
            for (int j = 0; j < na; ++j) {
              tma_load3(a + j * kBox, &map_dy, k0, t.m0 + 64 * j, t.e,
                        &full[s]);
            }
            for (int j = 0; j < nb; ++j) {  // w[e] rows n0.. (D), columns k0..
              tma_load3(b + j * kBox, &map_w, k0, t.n0 + 64 * j, t.e,
                        &full[s]);
            }
          }
        }
      }
    }
  } else {  // the consumer warpgroups: the paths never join again
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid >> 7;
    const int wt = tid & 127;
    const int lane = tid & 31;
    unsigned char* out_stage = ring + kStages * kStageBytes + wg * kOutBytes;
    float acc[128];
    int it = 0;
    for (int i = blockIdx.x; i < tiles.total; i += gridDim.x) {
      const Tile t = tile_at(tiles, i);
      for (int kt = 0; kt < t.nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const unsigned char* a = ring + s * kStageBytes + wg * kBox;
        const unsigned char* b = ring + s * kStageBytes + kABytes;
        fence_regs(acc);
        wgmma_fence();
        if (t.is_dw) {
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            wgmma_ss_m64n256k16<1, 1>(acc, smem_desc(a + kk * 2048, kBox, 1024),
                                      smem_desc(b + kk * 2048, kBox, 1024),
                                      kt > 0 || kk > 0);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            wgmma_ss_m64n256k16<0, 0>(acc, smem_desc(a + kk * 32, 16, 1024),
                                      smem_desc(b + kk * 32, 16, 1024),
                                      kt > 0 || kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // step it - 1's products are done: free its slot
        fence_regs(acc);
        if (kt > 0 && wt == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (wt == 0) mbar_arrive(&empty[(it - 1) % kStages]);

      // the tile's outputs to global by TMA stores, so that the next
      // tile's products start as soon as they are staged.  The C layout
      // (hopper.cuh): rows 16 (warp) + lane / 4 (+ 8), columns 8 j + 2
      // (lane % 4) (+ 1), into the boxes' swizzle; rows past M and
      // columns past N are not written
      const CUtensorMap* map_out = t.is_dw ? &map_dw : &map_dx;
      const int M = t.is_dw ? tiles.D : tiles.C;
      const int N = t.is_dw ? tiles.F : tiles.D;
      const int row0 = t.m0 + 64 * wg;
#pragma unroll
      for (int part = 0; part < kBN / kOutCols; ++part) {
        if (wt == 0) bulk_wait_read<0>();  // the last stores have read it
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < kOutCols / 8; ++jj) {
          const int j = part * (kOutCols / 8) + jj;
          unsigned char* box = out_stage + (jj / 8) * kBox;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (wt / 32) * 16 + lane / 4 + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(
                box + r * 128 + (((jj % 8) ^ (r & 7)) << 4) + (lane % 4) * 4) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]);
          }
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
        if (wt == 0 && row0 < M) {
          for (int b = 0; b < kOutCols / 64; ++b) {
            const int col = t.n0 + part * kOutCols + 64 * b;
            if (col < N) tma_store3(map_out, out_stage + b * kBox, col, row0,
                                    t.e);
          }
          bulk_commit();
        }
      }
    }
    if (wt == 0) bulk_wait<0>();  // the stores are done before the CTA ends
  }
}

// A 3-D bf16 map of [d2][d1][d0] (d0 contiguous; strides of d1 and d2 in
// elements), 64 x 64 boxes, the 128-byte swizzle
int make_map(CUtensorMap* out, const void* ptr, long long d0, long long d1,
             long long d2, long long s1, long long s2) {
  repro_torch::EncodeTiled encode = repro_torch::tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1) * 2,
                                 static_cast<cuuint64_t>(s2) * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

int launch_bf16_tma(const void* x, const void* w, const void* dy, void* dx,
                    void* dw, int E, int C, int D, int F, long long xs_e,
                    long long xs_c, cudaStream_t stream) {
  CUtensorMap mx, mw, mdy, mdx, mdw;
  const long long cd = static_cast<long long>(C) * D;
  const long long df = static_cast<long long>(D) * F;
  const long long cf = static_cast<long long>(C) * F;
  int err = make_map(&mx, x, D, C, E, xs_c, xs_e);
  if (err == 0) err = make_map(&mw, w, F, D, E, F, df);
  if (err == 0) err = make_map(&mdy, dy, F, C, E, F, cf);
  if (err == 0) err = make_map(&mdx, dx, D, C, E, D, cd);
  if (err == 0) err = make_map(&mdw, dw, F, D, E, F, df);
  if (err != 0) return err;
  // the attribute and the SM count are the device's: read them once each
  static bool ready[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  int n_sm = dev < kMaxDevices ? sms[dev] : 0;
  if (dev >= kMaxDevices || !ready[dev]) {
    cerr = cudaFuncSetAttribute(gmm_bwd_tma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kTmaSmem));
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    cerr = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    if (dev < kMaxDevices) {
      sms[dev] = n_sm;
      ready[dev] = true;
    }
  }
  Tiles t;
  t.C = C, t.D = D, t.F = F;
  t.dw_n = (F + kBN - 1) / kBN;
  t.dw_tiles = (D + kBM - 1) / kBM * t.dw_n;
  t.dx_n = (D + kBN - 1) / kBN;
  t.per_expert = t.dw_tiles + (C + kBM - 1) / kBM * t.dx_n;
  const long long total = static_cast<long long>(E) * t.per_expert;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  t.total = static_cast<int>(total);
  const int grid = t.total < n_sm ? t.total : n_sm;
  gmm_bwd_tma_kernel<<<grid, kTmaThreads, kTmaSmem, stream>>>(
      mx, mw, mdy, mdx, mdw, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch.
extern "C" int launch_grouped_matmul_bwd(const void* x, const void* w,
                                         const void* dy, void* dx, void* dw,
                                         int E, int C, int D, int F,
                                         long long xs_e, long long xs_c,
                                         int dtype, void* stream) {
  if (E < 1 || C < 1 || D < 1 || F < 1 || E > 32767) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_simple<float>(x, w, dy, dx, dw, E, C, D, F, xs_e, xs_c, s);
  }
  if (dtype == 1) {
    // TMA needs 16-byte rows: D, F and x's strides multiples of 8
    // elements, the three inputs 16-byte aligned
    const bool rows16 = D % 8 == 0 && F % 8 == 0 && xs_e % 8 == 0 &&
                        xs_c % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    if (rows16) {
      return launch_bf16_tma(x, w, dy, dx, dw, E, C, D, F, xs_e, xs_c, s);
    }
    return launch_simple<bf16>(x, w, dy, dx, dw, E, C, D, F, xs_e, xs_c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
