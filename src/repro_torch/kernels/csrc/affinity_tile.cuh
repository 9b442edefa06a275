// Shared affinity-tile math of the fused Nystrom kernels (nystrom.cu) and
// the affinity kernels (affinity.cu).
//
// Replaces `_affinity_tile` and `_quantize_rows` of
// src/repro/kernels/nystrom_pallas.py (l.58-103): one RBF cross-affinity
// entry
//
//     C_ij = exp(-gamma * max(|x~_i|^2 + |z~_j|^2 - 2 x~_i . z~_j, 0))
//
// on operands rounded to the tile precision:
//
//   f32   the operands as they are, f32 dot;
//   bf16  operands rounded with __float2bfloat16_rn, products and sums in
//         f32 (a bf16 x bf16 product is exact in f32);
//   int8  per-row symmetric scale s = max(amax / 127, 1e-8), values
//         q = clip(rint(a / s), -127, 127) (round half to even), an exact
//         int32 dot, xy = dot * (s_x * s_z).  The norms come from the
//         DEQUANTIZED operands q * s, so d^2 is the squared distance of the
//         quantized points, as on the TPU.
//
// With d = 8 one entry is 8 FMAs and one expf: every kernel of
// nystrom.cu is bound by FMA and exp throughput on the CUDA cores, not by a
// tensor-core product, so the tile routine stays scalar.
//
// A "prepared point" is what the dot reads: `v[k]` holds the rounded
// operand (f32 / bf16) or, for int8, the bits of the integer value
// (__int_as_float), `norm` is |dequantized point|^2 and `scale` the int8
// row scale (1 otherwise).  Point sets in shared memory are stored
// transposed, element k of point t at v[k * cap + t], so that consecutive
// threads reading consecutive points hit consecutive banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

enum AffinityDtype : int { kF32 = 0, kBF16 = 1, kINT8 = 2 };

constexpr float kEps = 1e-12f;   // degree / row-norm floor
constexpr float kQEps = 1e-8f;   // int8 scale floor for all-zero rows

inline unsigned blocks_for(long long work, int threads) {
  return static_cast<unsigned>((work + threads - 1) / threads);
}

// Round one (d,) row to the tile precision.  Loops run to the
// compile-time bound MAXD with a `k < d` guard so that a register array
// `v` stays in registers.
template <int DT, int MAXD>
__device__ __forceinline__ void prepare_point(const float* __restrict__ row,
                                              int d, float* v, float& norm,
                                              float& scale) {
  norm = 0.f;
  scale = 1.f;
  if (DT == kINT8) {
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < MAXD; ++k)
      if (k < d) amax = fmaxf(amax, fabsf(row[k]));
    scale = fmaxf(amax / 127.f, kQEps);
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      if (k < d) {
        const float q = fminf(fmaxf(rintf(row[k] / scale), -127.f), 127.f);
        const float deq = q * scale;
        norm = fmaf(deq, deq, norm);
        v[k] = __int_as_float(static_cast<int>(q));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < MAXD; ++k) {
      if (k < d) {
        float a = row[k];
        if (DT == kBF16) a = __bfloat162float(__float2bfloat16_rn(a));
        norm = fmaf(a, a, norm);
        v[k] = a;
      }
    }
  }
}

// Squared distance between two prepared points in the norm form
// max(|a|^2 + |b|^2 - 2 a.b, 0); element k of `a` is a[k * sa], of `b` is
// b[k * sb].
template <int DT, int MAXD>
__device__ __forceinline__ float sq_dist(const float* a, int sa,
                                         float a_norm, float a_scale,
                                         const float* b, int sb,
                                         float b_norm, float b_scale, int d) {
  float xy;
  if (DT == kINT8) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < MAXD; ++k)
      if (k < d) acc += __float_as_int(a[k * sa]) * __float_as_int(b[k * sb]);
    xy = static_cast<float>(acc) * (a_scale * b_scale);
  } else {
    xy = 0.f;
#pragma unroll
    for (int k = 0; k < MAXD; ++k)
      if (k < d) xy = fmaf(a[k * sa], b[k * sb], xy);
  }
  return fmaxf(a_norm + b_norm - 2.f * xy, 0.f);
}

// One affinity entry exp(-gamma * d^2) between two prepared points.
template <int DT, int MAXD>
__device__ __forceinline__ float affinity(const float* a, int sa,
                                          float a_norm, float a_scale,
                                          const float* b, int sb,
                                          float b_norm, float b_scale, int d,
                                          float gamma) {
  return expf(-gamma * sq_dist<DT, MAXD>(a, sa, a_norm, a_scale, b, sb,
                                         b_norm, b_scale, d));
}

// Prepare rows [first, first + count) of the row-major (., d) array `src`
// into a transposed shared-memory point set of capacity `cap`; slots past
// `count` are zero points.  Called by every thread of the block.
template <int DT, int MAXD>
__device__ __forceinline__ void load_points(const float* __restrict__ src,
                                            int first, int count, int cap,
                                            int d, float* v, float* norm,
                                            float* scale) {
  for (int t = threadIdx.x; t < cap; t += blockDim.x) {
    float pv[MAXD];
    float pn = 0.f, ps = 1.f;
#pragma unroll
    for (int k = 0; k < MAXD; ++k) pv[k] = 0.f;
    if (t < count)
      prepare_point<DT, MAXD>(src + static_cast<size_t>(first + t) * d, d,
                              pv, pn, ps);
#pragma unroll
    for (int k = 0; k < MAXD; ++k)
      if (k < d) v[k * cap + t] = pv[k];
    norm[t] = pn;
    scale[t] = ps;
  }
}

}  // namespace rt
