// Materialized affinity kernels for Hopper (sm_90a).
//
// Ports of the three Pallas kernels of src/repro/kernels/affinity_pallas.py:
//
//   rt_pairwise_sq_dists   <- pairwise_sq_dists_pallas (l.79)
//   rt_rbf_cross_affinity  <- rbf_cross_affinity_pallas (l.128)
//   rt_rbf_affinity        <- rbf_affinity_pallas (l.103)
//
// The TPU kernels tile the (n, m) output into 128 x 128 VMEM blocks and
// run the x . y^T inner product on the MXU.  With d <= 32 an entry is a
// handful of FMAs, so on the card these kernels are bound by the bytes
// they write, not by arithmetic: at the dense path's n = m = 2048, d = 8
// the 16.8 MB output takes ~5 us at 3.35 TB/s, and the unfused Nystrom
// block (N = 100 000, m = 512) writes 205 MB, ~62 us.
//
// rt_rbf_cross_affinity launches cross_tile_kernel (affinity_tile.cuh),
// the kernel of B1 too: points prepared once a block, 16-byte streaming
// stores.  The square kernels keep the simpler design:
//
//   block (row group, column tile): kAffCols threads, one output column
//   each, walk kAffRows consecutive rows.  A thread holds its y row in
//   registers for the whole walk; the x row of each step is the same
//   address for every thread of the block (a broadcast load), and the
//   kAffCols threads of a row store to consecutive addresses.
//
// Epilogues: squared distance in the difference form sum_k (x_k - y_k)^2
// (exact zero on the diagonal, no cancellation); the RBF kernels use
// the norm form of affinity_tile.cuh's f32 path, the same entry the fused
// Nystrom kernels compute, with the diagonal zeroed for the square one.
// Every C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (cudaErrorInvalidValue for a d it does not
// take).

#include <cuda_runtime.h>

#include "affinity_tile.cuh"

namespace rt {

enum Epilogue : int { kSqDist = 0, kRbfZeroDiag = 2 };

constexpr int kAffCols = 128;   // threads = output columns per block
constexpr int kAffRows = 8;     // output rows per block

template <int EPI, int MAXD>
__global__ void __launch_bounds__(kAffCols)
affinity_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float gamma, float* __restrict__ out, int n, int m, int d) {
  const int j = blockIdx.y * kAffCols + threadIdx.x;
  if (j >= m) return;
  float yv[MAXD];
  float yn, ys;
  prepare_point<kF32, MAXD>(y + static_cast<size_t>(j) * d, d, yv, yn, ys);
  const int i0 = blockIdx.x * kAffRows;
  const int i1 = min(n, i0 + kAffRows);
  for (int i = i0; i < i1; ++i) {
    const float* xr = x + static_cast<size_t>(i) * d;
    float v;
    if (EPI == kSqDist) {
      v = 0.f;
#pragma unroll
      for (int k = 0; k < MAXD; ++k) {
        if (k < d) {
          const float t = xr[k] - yv[k];
          v = fmaf(t, t, v);
        }
      }
    } else {
      float xv[MAXD];
      float xn, xs;
      prepare_point<kF32, MAXD>(xr, d, xv, xn, xs);
      v = affinity<kF32, MAXD>(xv, 1, xn, xs, yv, 1, yn, ys, d, gamma);
      if (EPI == kRbfZeroDiag && i == j) v = 0.f;
    }
    out[static_cast<size_t>(i) * m + j] = v;
  }
}

template <int EPI>
int launch_affinity(const float* x, const float* y, float gamma, float* out,
                    int n, int m, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(n, kAffRows), blocks_for(m, kAffCols));
  if (d >= 1 && d <= 8) {
    affinity_kernel<EPI, 8><<<grid, kAffCols, 0, s>>>(x, y, gamma, out, n,
                                                       m, d);
  } else if (d > 8 && d <= 32) {
    affinity_kernel<EPI, 32><<<grid, kAffCols, 0, s>>>(x, y, gamma, out, n,
                                                        m, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt

using namespace rt;

extern "C" {

// out (n, m) = max(|x_i - y_j|^2, 0)
int rt_pairwise_sq_dists(const float* x, const float* y, float* out, int n,
                         int m, int d, void* stream) {
  return launch_affinity<kSqDist>(x, y, 0.f, out, n, m, d, stream);
}

// out (n, m) = exp(-gamma * d^2(x_i, y_j)): cross_tile_kernel at f32 with
// the wrapper's rows a tile
int rt_rbf_cross_affinity(const float* x, const float* y, float gamma,
                          float* out, int n, int m, int d, int rows,
                          void* stream) {
  return launch_cross_tile<kF32>(x, y, gamma, out, n, m, d, rows, stream);
}

// out (n, n) = exp(-gamma * d^2(x_i, x_j)), zero diagonal
int rt_rbf_affinity(const float* x, float gamma, float* out, int n, int d,
                    void* stream) {
  return launch_affinity<kRbfZeroDiag>(x, x, gamma, out, n, n, d, stream);
}

}  // extern "C"
