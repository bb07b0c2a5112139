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
// Bound: operations.  A 1024-token prefill of mamba2 (nh 80, hd 64,
// ds 128, Q 256) needs about 4.1 GFLOP of f32 for 43 MB of inputs and
// output: 61 us at 67 TFLOP/s against 13 us at 3.35 TB/s.  The sums stay
// in f32 on the CUDA cores, as the TPU kernel keeps every contraction
// in f32; TF32 tensor cores would cost about 1e-3 relative.
//
// Design.  The TPU kernel walks the chunks of one head in order and
// keeps the state in VMEM between grid steps; here nothing carries
// between blocks, so the scan is the three passes of _ssd_scan's own
// decomposition, all on the current stream:
//   1. ssd_chunk_state_kernel, one CTA per (chunk, head, batch): the
//      chunk's running decay seg (summed in order, as the plain
//      version's cumsum is, so both give the same seg) and, but for the
//      last chunk, its outgoing state
//      S_c = sum_j exp(total - seg_j) dt_j x_j B_j^T;
//   2. ssd_state_pass_kernel (when there are two chunks or more):
//      H_c = exp(total_c) H_{c-1} + S_c in chunk order, one thread per
//      state element, each chunk's incoming state written over S_c;
//   3. ssd_chunk_output_kernel, one CTA per (64 query rows, head,
//      batch): exp(seg_i) C_i . H_in, then the key tiles on or below the
//      diagonal: the 64 x 64 scores C B^T, L = exp(seg_i - seg_j) built
//      from seg and masked before the exp, times dt_j, times x.
// The Q x Q decay matrix (256 KB at Q 256) never exists: each CTA holds
// one 64 x 64 tile of it.  Operands sit in shared memory laid out so
// that a thread's 4 x 4 register tile reads two float4s per step.
//
// Later work: C B^T once for all the heads of a chunk (it is the same
// for every head), tensor cores at a stated tolerance, and the final
// state for the decode cache (pass 1 on the last chunk, one more step
// of pass 2).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // query rows and key columns of one tile
constexpr int kPitch = 68;     // shared-memory row pitch of 64-wide tiles
constexpr int kMaxChunk = 256;
constexpr int kMaxHd = 64;
constexpr int kMaxDs = 128;
constexpr int kSteps = 32;     // positions per step of the state sweep
constexpr int kBPitch = kMaxDs + 4;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[r][k] += a[r] * b[k]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(av[r], bv[k], acc[r][k]);
  }
}

// ---------------------------------------------------------- pass 1
// grid (nc, nh, B).  seg [B, nh, nc*Q], total [B, nh, nc],
// state [B, nh, nc, hd, ds].
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       float* __restrict__ seg_out,
                       float* __restrict__ total_out,
                       float* __restrict__ state_out,
                       int S, int nh, int hd, int ds, int Q) {
  __shared__ float s_seg[kMaxChunk];
  __shared__ float s_w[kMaxChunk];
  __shared__ __align__(16) float s_x[kSteps * kPitch];   // [t][p]
  __shared__ __align__(16) float s_b[kSteps * kBPitch];  // [t][d]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const long long pos0 = static_cast<long long>(c) * Q;
  const long long bh = static_cast<long long>(b) * nh + h;

  // running decay inside the chunk, summed in order by one thread with
  // every product and sum rounded on its own: the plain version's
  // cumsum of dt A along the chunk (sequential on the CPU and on the
  // card) gives the same bits, and exp(seg_i - seg_j) of two sums of
  // order 10^3 keeps their rounding
  float dtv = 0.f;
  if (tid < Q && pos0 + tid < S) {
    dtv = dt[(static_cast<long long>(b) * S + pos0 + tid) * nh + h];
  }
  if (tid < Q) s_w[tid] = __fmul_rn(dtv, A[h]);
  __syncthreads();
  // positions past S add dt A = 0: their seg repeats the last one
  const int valid = static_cast<int>(min(static_cast<long long>(Q), S - pos0));
  if (tid == 0) {
    float v = 0.f;
    for (int t = 0; t < valid; ++t) {
      v = __fadd_rn(v, s_w[t]);
      s_seg[t] = v;
    }
    for (int t = valid; t < Q; ++t) s_seg[t] = v;
  }
  __syncthreads();
  const float total = s_seg[Q - 1];
  if (tid < Q) {
    const float v = s_seg[tid];
    seg_out[bh * nc * Q + pos0 + tid] = v;
    s_w[tid] = expf(total - v) * dtv;
  }
  if (tid == 0) total_out[bh * nc + c] = total;
  // no chunk reads the last chunk's outgoing state
  if (c == nc - 1) return;
  __syncthreads();

  // S_c[p][d] = sum_t w_t x[t][p] B[t][d]: this thread's rows
  // p = 4 ty .. 4 ty + 3 and columns d = 4 tx + 64 g .. + 3 (g < 2)
  const int ty = tid >> 4, tx = tid & 15;
  const int groups = (ds + kTile - 1) / kTile;
  float acc[2][4][4] = {};
  for (int t0 = 0; t0 < valid; t0 += kSteps) {
    for (int e = tid; e < kSteps * hd; e += kThreads) {
      const int t = e / hd, p = e - t * hd;
      const long long pos = pos0 + t0 + t;
      s_x[t * kPitch + p] =
          (t0 + t < Q && pos < S)
              ? s_w[t0 + t] *
                    x[((static_cast<long long>(b) * S + pos) * nh + h) * hd + p]
              : 0.f;
    }
    for (int e = tid; e < kSteps * ds; e += kThreads) {
      const int t = e / ds, d = e - t * ds;
      const long long pos = pos0 + t0 + t;
      s_b[t * kBPitch + d] =
          (t0 + t < Q && pos < S)
              ? Bm[(static_cast<long long>(b) * S + pos) * ds + d]
              : 0.f;
    }
    __syncthreads();
    const int steps = min(kSteps, valid - t0);
    for (int t = 0; t < steps; ++t) {
      const float4 xv = ld4(&s_x[t * kPitch + 4 * ty]);
      outer4(acc[0], xv, ld4(&s_b[t * kBPitch + 4 * tx]));
      if (groups > 1) outer4(acc[1], xv, ld4(&s_b[t * kBPitch + 64 + 4 * tx]));
    }
    __syncthreads();
  }
  float* out = state_out + (bh * nc + c) * hd * ds;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = 4 * ty + r, d = 64 * g + 4 * tx + k;
        if (p < hd && d < ds) out[p * ds + d] = acc[g][r][k];
      }
    }
  }
}

// ---------------------------------------------------------- pass 2
// grid (ceil(hd ds / 256), nh, B), launched when nc > 1: H_in of chunk
// c + 1 written over S_c (chunk 0 takes no state in; the last chunk's
// outgoing state is never computed).
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(float* __restrict__ state,
                      const float* __restrict__ total, int nh, int nc,
                      int hd_ds) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= hd_ds) return;
  const long long bh = static_cast<long long>(blockIdx.z) * nh + blockIdx.y;
  float* st = state + bh * nc * hd_ds + e;
  const float* tot = total + bh * nc;
  float H = 0.f;
  for (int c = 0; c + 1 < nc; ++c) {
    float* slot = st + static_cast<long long>(c) * hd_ds;
    // rounded as the plain version's exp(total) * H + S_c, not fused
    H = __fadd_rn(__fmul_rn(expf(tot[c]), H), *slot);
    *slot = H;
  }
}

// ---------------------------------------------------------- pass 3
// grid (nc * tiles, nh, B), tiles = ceil(Q / 64): one CTA per 64 query
// rows of one chunk.  Dynamic shared memory, floats:
//   s_cT [ds][68]  C of the query rows, d-major
//   s_bT [ds][68]  B of the key rows, d-major (first H_in^T [d][p])
//   s_x  [64][68]  x of the key rows
//   s_mT [64][68]  M^T of the tile: [key][query]
//   s_segq, s_segk, s_dtk [64]
__global__ void __launch_bounds__(kThreads)
ssd_chunk_output_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ Bm,
                        const float* __restrict__ C,
                        const float* __restrict__ seg,
                        const float* __restrict__ h_in,
                        float* __restrict__ y,
                        int S, int nh, int hd, int ds, int Q, int tiles) {
  extern __shared__ __align__(16) float smem[];
  float* s_cT = smem;
  float* s_bT = s_cT + ds * kPitch;
  float* s_x = s_bT + ds * kPitch;
  float* s_mT = s_x + kTile * kPitch;
  float* s_segq = s_mT + kTile * kPitch;
  float* s_segk = s_segq + kTile;
  float* s_dtk = s_segk + kTile;

  const int c = blockIdx.x / tiles, rt = blockIdx.x - c * tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / tiles;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long pos0 = static_cast<long long>(c) * Q;
  const long long bh = static_cast<long long>(b) * nh + h;
  const long long bS = static_cast<long long>(b) * S;
  const int q0 = rt * kTile;
  // query rows of this tile inside the chunk and the sequence
  const int rows =
      static_cast<int>(min(static_cast<long long>(min(kTile, Q - q0)),
                           S - pos0 - q0));
  if (rows <= 0) return;  // a tile wholly past S (uniform over the CTA)
  const float* seg_c = seg + bh * nc * Q + pos0;

  for (int e = tid; e < kTile * ds; e += kThreads) {
    const int i = e / ds, d = e - i * ds;
    s_cT[d * kPitch + i] =
        i < rows ? C[(bS + pos0 + q0 + i) * ds + d] : 0.f;
  }
  if (tid < kTile) s_segq[tid] = tid < rows ? seg_c[q0 + tid] : 0.f;

  float acc[4][4] = {};
  if (c > 0) {
    // inter-chunk: y_i = exp(seg_i) sum_d C[i][d] H_in[p][d]
    const float* H = h_in + (bh * nc + c - 1) * hd * ds;
    for (int e = tid; e < hd * ds; e += kThreads) {
      const int p = e / ds, d = e - p * ds;
      s_bT[d * kPitch + p] = H[e];
    }
    __syncthreads();
    for (int d = 0; d < ds; ++d) {
      outer4(acc, ld4(&s_cT[d * kPitch + 4 * ty]),
             ld4(&s_bT[d * kPitch + 4 * tx]));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float g = expf(s_segq[4 * ty + r]);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] *= g;
    }
  }

  // intra-chunk: the key tiles on or below the diagonal
  for (int kt = 0; kt <= rt; ++kt) {
    const int k0 = kt * kTile;
    const int keys = min(kTile, Q - k0);
    __syncthreads();  // the previous tile's operands are consumed
    for (int e = tid; e < kTile * ds; e += kThreads) {
      const int j = e / ds, d = e - j * ds;
      const long long pos = pos0 + k0 + j;
      s_bT[d * kPitch + j] =
          (j < keys && pos < S) ? Bm[(bS + pos) * ds + d] : 0.f;
    }
    for (int e = tid; e < kTile * hd; e += kThreads) {
      const int j = e / hd, p = e - j * hd;
      const long long pos = pos0 + k0 + j;
      s_x[j * kPitch + p] =
          (j < keys && pos < S) ? x[((bS + pos) * nh + h) * hd + p] : 0.f;
    }
    if (tid < kTile) {
      const long long pos = pos0 + k0 + tid;
      const bool ok = tid < keys && pos < S;
      s_segk[tid] = tid < keys ? seg_c[k0 + tid] : 0.f;
      s_dtk[tid] = ok ? dt[(bS + pos) * nh + h] : 0.f;
    }
    __syncthreads();
    // scores of rows 4 ty + r against keys 4 tx + k
    float sc[4][4] = {};
    for (int d = 0; d < ds; ++d) {
      outer4(sc, ld4(&s_cT[d * kPitch + 4 * ty]),
             ld4(&s_bT[d * kPitch + 4 * tx]));
    }
    // M = scores * exp(seg_i - seg_j) * dt_j on j <= i, masked before
    // the exp (above the diagonal the exponent is large and positive)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * tx + k;
      float m[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ty + r;
        const bool keep = j < keys && i < rows && k0 + j <= q0 + i;
        m[r] = keep ? sc[r][k] * expf(s_segq[i] - s_segk[j]) * s_dtk[j]
                    : 0.f;
      }
      *reinterpret_cast<float4*>(&s_mT[j * kPitch + 4 * ty]) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
    __syncthreads();
    // y += M x
    for (int j = 0; j < keys; ++j) {
      outer4(acc, ld4(&s_mT[j * kPitch + 4 * ty]),
             ld4(&s_x[j * kPitch + 4 * tx]));
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    if (i >= rows) continue;
    float* out = y + ((bS + pos0 + q0 + i) * nh + h) * hd;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * tx + k;
      if (p < hd) out[p] = acc[r][k];
    }
  }
}

size_t output_smem_bytes(int ds) {
  return sizeof(float) *
         (static_cast<size_t>(2 * ds + 2 * kTile) * kPitch + 3 * kTile);
}

}  // namespace

// x [B, S, nh, hd], dt [B, S, nh], A [nh], Bm and C [B, S, ds], y
// [B, S, nh, hd], all f32 and contiguous; scratch seg [B, nh, nc Q],
// total [B, nh, nc], state [B, nh, nc, hd, ds] with nc = ceil(S / Q).
// Two or three kernels on ``stream``; returns the first launch error (0
// if none).
extern "C" int launch_ssd_scan(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* C, void* y,
                               void* seg, void* total, void* state, int B,
                               int S, int nh, int hd, int ds, int Q,
                               void* stream) {
  if (B < 1 || S < 1 || nh < 1 || hd < 1 || ds < 1 || Q < 1 ||
      B > 65535 || nh > 65535 || Q > kMaxChunk || hd > kMaxHd ||
      ds > kMaxDs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (S + Q - 1) / Q;
  const int tiles = (Q + kTile - 1) / kTile;
  const size_t smem = output_smem_bytes(ds);
  // the attribute is the function's on each device: set it once per device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(ssd_chunk_output_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(output_smem_bytes(kMaxDs)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(Bm);
  float* segf = static_cast<float*>(seg);
  float* totf = static_cast<float*>(total);
  float* stf = static_cast<float*>(state);

  ssd_chunk_state_kernel<<<dim3(nc, nh, B), kThreads, 0, s>>>(
      xf, dtf, static_cast<const float*>(A), bf, segf, totf, stf, S, nh, hd,
      ds, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nc > 1) {
    ssd_state_pass_kernel<<<dim3((hd * ds + kThreads - 1) / kThreads, nh, B),
                            kThreads, 0, s>>>(stf, totf, nh, nc, hd * ds);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_chunk_output_kernel<<<dim3(nc * tiles, nh, B), kThreads, smem, s>>>(
      xf, dtf, bf, static_cast<const float*>(C), segf, stf,
      static_cast<float*>(y), S, nh, hd, ds, Q, tiles);
  return static_cast<int>(cudaGetLastError());
}
