// Helpers shared by the port's CUDA kernels: 16-byte loads of 8 elements
// into f32 registers, the element strides a kernel takes for a tensor
// whose last dimension is contiguous, and the SSD scans' in-order sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// the finite masking value of the JAX package (a fully masked softmax row
// averages instead of giving NaN)
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // elements, of the (batch, head, sequence) dims
};

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// seg[t] = w[0] + ... + w[t] for t < n <= kMaxN, summed in order by the
// calling thread with every sum rounded on its own (the plain version's
// sequential cumsum gives the same bits); w is read 16 at a time, so that
// the chain waits on the adds and not on the loads.  The SSD scan and its
// backward sum each chunk's dt A so.
template <int kMaxN>
__device__ __forceinline__ float in_order_sum(const float* w, float* seg,
                                              int n) {
  float v = 0.f;
  for (int t0 = 0; t0 < n; t0 += 16) {
    float wv[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) wv[u] = w[min(t0 + u, kMaxN - 1)];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (t0 + u < n) {
        v = __fadd_rn(v, wv[u]);
        seg[t0 + u] = v;
      }
    }
  }
  return v;
}

}  // namespace repro_torch
