// Shared affinity-tile math of the fused Nystrom kernels (nystrom.cu) and
// the affinity kernels (affinity.cu), and the one materialized affinity
// kernel both instantiate (cross_tile_kernel, at the end).
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
#include <stdint.h>

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


// One float (VEC false) or 16 bytes (VEC true) global -> shared with
// cp.async; `in` false zero-fills the destination.
template <bool VEC>
__device__ __forceinline__ void panel_copy(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 4 : 0));
}

// `count` floats global -> shared by cp.async, 16-byte pieces when VEC
// (both ends 16-byte aligned), then the tail by 4-byte pieces.
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             int count, bool vec) {
  int head = 0;
  if (vec) {
    head = count & ~3;
    for (int e = 4 * threadIdx.x; e < head; e += 4 * blockDim.x)
      panel_copy<true>(dst + e, src + e, true);
  }
  for (int e = head + threadIdx.x; e < count; e += blockDim.x)
    panel_copy<false>(dst + e, src + e, true);
}

// ---------------------------------------------------------------------------
// The materialized affinities (B1, B6, B7 and B8)
// ---------------------------------------------------------------------------
//
// Replaces quantized_cross_affinity_pallas (src/repro/kernels/
// nystrom_pallas.py l.340) and rbf_cross_affinity_pallas,
// pairwise_sq_dists_pallas and rbf_affinity_pallas
// (src/repro/kernels/affinity_pallas.py l.128, 79, 103): out (n, m) = an
// entry of (x_i, y_j) on operands rounded to the tile precision.  The
// epilogue EPI says which entry:
//   kRbf          affinity(x_i, y_j), B1 at every precision and B6 (at
//                 f32 the two are one function: "reproduces
//                 rbf_cross_affinity_pallas exactly");
//   kRbfZeroDiag  the same, then 0 where i == j (B8, launched with
//                 y = x);
//   kSqDistDiff   the squared distance in the difference form
//                 sum_k (x_k - y_k)^2, folded in k order with fmaf (B7):
//                 exactly 0 on the diagonal and exactly symmetric, no
//                 cancellation.  At f32 a prepared point is its
//                 coordinates as they are, so the fold reads the packed
//                 rows and landmarks; the norm and scale slots go unused.
// kRbfZeroDiag and kSqDistDiff take f32 only.  rt_quantized_cross_affinity
// (nystrom.cu) and the three entries of affinity.cu launch this one
// template.
//
// Bound by the bytes it writes: at the unfused Nystrom path's 10^5 x 512
// x 8 it writes 205 MB and reads 0.8 MB, ~62 us at 3.35 TB/s, while an
// entry is ~20 issue slots (~35 us on 132 SMs).  So:
//   - every point is prepared once a block, not once an entry: the
//     block's landmarks are rounded one a thread into shared memory
//     (transposed), and each thread keeps its kCols consecutive columns
//     in registers for the block's life; a tile of x rows arrives by
//     cp.async, is rounded once a row and packed as (coordinates, |x|^2,
//     int8 scale, 0) float4s that a warp reads as a broadcast;
//   - a thread writes its kCols columns of a row as one 16-byte (8-byte
//     at kCols = 2) streaming store (st.global.cs: the output is larger
//     than L2 and never read back); where m % 4 != 0 or `out` is not
//     16-byte aligned, as kCols scalar streaming stores;
//   - a block owns one (row tile, column tile): gridDim.y column tiles of
//     kCrossColThreads * kCols columns, gridDim.x row tiles of `rows`
//     rows (kernels/affinity.py::cross_tile_plan picks them).  With 4
//     blocks an SM resident and the rest queued, one block's staging
//     overlaps the others' stores.  Persistent blocks that walk the row
//     tiles were 4-6 % slower in turns (PERF.md, section 6).
// Bits: prepare_point and affinity are the functions every earlier
// version called, on the same float operands (a staged row is the same
// floats), and the difference fold is the same fmaf chain in k order, so
// every entry keeps its bits.  No sums across threads, no atomics.

enum CrossEpilogue : int { kRbf = 0, kRbfZeroDiag = 1, kSqDistDiff = 2 };

constexpr int kCrossThreads = 256;
constexpr int kCrossColThreads = 64;    // threads across a column tile
constexpr int kCrossLanes = kCrossThreads / kCrossColThreads;   // row lanes
constexpr int kCrossMaxRows = 64;       // rows a tile, at most

template <int MAXD>
struct CrossCfg {
  static constexpr int kCols = MAXD <= 8 ? 4 : 2;   // columns a thread
  static_assert(kCols == 4 || kCols == 2, "4- or 2-wide vectors");
  static constexpr int kTile = kCrossColThreads * kCols;
  static constexpr int kMinBlocks = MAXD <= 8 ? 4 : 1;   // an SM, at <= 64 regs
  static constexpr int kRow = MAXD + 4;              // floats a packed row
};

template <int DT, int MAXD, bool VEC, int EPI>
__global__ void __launch_bounds__(kCrossThreads, CrossCfg<MAXD>::kMinBlocks)
cross_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float gamma, float* __restrict__ out, int n, int m, int d,
                  int rows) {
  static_assert(EPI == kRbf || DT == kF32, "B7's and B8's entries are f32");
  using Cf = CrossCfg<MAXD>;
  constexpr int C = Cf::kCols;
  __shared__ float4 packed[kCrossMaxRows * Cf::kRow / 4];
  __shared__ __align__(16) float raw[kCrossMaxRows * MAXD];
  // the column tile's landmarks, transposed: v, then |y|^2, then scale
  __shared__ __align__(16) float lm[Cf::kTile * (MAXD + 2)];
  const int tid = threadIdx.x;
  const int lane = tid / kCrossColThreads;
  const int col = (tid % kCrossColThreads) * C;     // within the tile
  const int first = blockIdx.y * Cf::kTile;
  const int j0 = first + col;
  const int row0 = blockIdx.x * rows;
  const int cnt = min(rows, n - row0);
  // the row tile by cp.async (16-byte pieces: rows % 4 == 0), while the
  // landmarks are prepared one a thread into shared memory (neighbouring
  // threads read neighbouring rows)
  stage_floats(raw, x + static_cast<size_t>(row0) * d, cnt * d,
               reinterpret_cast<uintptr_t>(x) % 16 == 0);
  asm volatile("cp.async.commit_group;\n" ::);
  load_points<DT, MAXD>(y, first, min(Cf::kTile, m - first), Cf::kTile, d,
                        lm, lm + MAXD * Cf::kTile, lm + (MAXD + 1) * Cf::kTile);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int t = tid; t < cnt; t += kCrossThreads) {
    float pv[MAXD];
    float pn, ps;
#pragma unroll
    for (int k = 0; k < MAXD; ++k) pv[k] = 0.f;
    prepare_point<DT, MAXD>(raw + t * d, d, pv, pn, ps);
    float4* row = packed + t * (Cf::kRow / 4);
#pragma unroll
    for (int q = 0; q < MAXD / 4; ++q)
      row[q] = make_float4(pv[4 * q], pv[4 * q + 1], pv[4 * q + 2],
                           pv[4 * q + 3]);
    row[MAXD / 4] = make_float4(pn, ps, 0.f, 0.f);
  }
  __syncthreads();
  if (j0 >= m) return;

  // this thread's C consecutive landmark columns, as C-wide vectors
  float yv[C][MAXD], yn[C], ys[C];
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    const float* src = lm + k * Cf::kTile + col;
#pragma unroll
    for (int c = 0; c < C; ++c) yv[c][k] = 0.f;
    if (k >= d) continue;
    if constexpr (C == 4) {
      const float4 q = *reinterpret_cast<const float4*>(src);
      yv[0][k] = q.x; yv[1][k] = q.y; yv[2][k] = q.z; yv[3][k] = q.w;
    } else {
      const float2 q = *reinterpret_cast<const float2*>(src);
      yv[0][k] = q.x; yv[C - 1][k] = q.y;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    yn[c] = lm[MAXD * Cf::kTile + col + c];
    ys[c] = lm[(MAXD + 1) * Cf::kTile + col + c];
  }

  // unrolled by 2; by 1 for B8, whose d <= 8 instances spill at 2
#pragma unroll (EPI == kRbfZeroDiag ? 1 : 2)
  for (int t = lane; t < cnt; t += kCrossLanes) {
    const float4* row = packed + t * (Cf::kRow / 4);
    float xv[MAXD];
#pragma unroll
    for (int q = 0; q < MAXD / 4; ++q) {
      const float4 v = row[q];
      xv[4 * q] = v.x; xv[4 * q + 1] = v.y; xv[4 * q + 2] = v.z;
      xv[4 * q + 3] = v.w;
    }
    const float4 tail = row[MAXD / 4];     // |x|^2, int8 scale
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (EPI == kSqDistDiff) {
        v[c] = 0.f;
#pragma unroll
        for (int k = 0; k < MAXD; ++k) {
          if (k < d) {
            const float diff = xv[k] - yv[c][k];
            v[c] = fmaf(diff, diff, v[c]);
          }
        }
      } else {
        v[c] = affinity<DT, MAXD>(xv, 1, tail.x, tail.y, yv[c], 1, yn[c],
                                  ys[c], d, gamma);
      }
    }
    float* o = out + static_cast<size_t>(row0 + t) * m + j0;
    if constexpr (VEC && C == 4) {
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(v[0], v[1], v[2], v[3]));
    } else if constexpr (VEC && C == 2) {
      __stcs(reinterpret_cast<float2*>(o), make_float2(v[0], v[1]));
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (j0 + c < m) __stcs(o + c, v[c]);
    }
  }
  if constexpr (EPI == kRbfZeroDiag) {
    // B8's diagonal, after the loop (a compare an entry inside it made
    // B8 15 % slower on an H100): entry (j, j) of this thread's column j
    // is this thread's if row j lies in the tile and in this lane; it is
    // stored again, as 0, after the row's store (one thread, one address,
    // in order)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = j0 + c - row0;
      if (j0 + c < m && t >= 0 && t < cnt && t % kCrossLanes == lane)
        out[static_cast<size_t>(j0 + c) * m + j0 + c] = 0.f;
    }
  }
}

// One launch of cross_tile_kernel with epilogue EPI: rows a tile (a
// multiple of 4, at most kCrossMaxRows) from the wrapper's plan; the grid,
// and columns a thread, follow from n, m and d.
template <int DT, int EPI, int MAXD>
int launch_cross_tile_d(const float* x, const float* y, float gamma,
                        float* out, int n, int m, int d, int rows,
                        cudaStream_t s) {
  const unsigned col_tiles = blocks_for(m, CrossCfg<MAXD>::kTile);
  if (col_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(n, rows), col_tiles);
  if (m % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    cross_tile_kernel<DT, MAXD, true, EPI><<<grid, kCrossThreads, 0, s>>>(
        x, y, gamma, out, n, m, d, rows);
  else
    cross_tile_kernel<DT, MAXD, false, EPI><<<grid, kCrossThreads, 0, s>>>(
        x, y, gamma, out, n, m, d, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int DT, int EPI = kRbf>
int launch_cross_tile(const float* x, const float* y, float gamma, float* out,
                      int n, int m, int d, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || m < 1 || rows < 4 || rows > kCrossMaxRows || rows % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d >= 1 && d <= 8)
    return launch_cross_tile_d<DT, EPI, 8>(x, y, gamma, out, n, m, d, rows,
                                           s);
  if (d > 8 && d <= 32)
    return launch_cross_tile_d<DT, EPI, 32>(x, y, gamma, out, n, m, d, rows,
                                            s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rt
