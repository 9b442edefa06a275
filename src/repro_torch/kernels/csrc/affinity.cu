// Materialized affinity kernels for Hopper (sm_90a): the C entries of
// three Pallas kernels of src/repro/kernels/affinity_pallas.py, each one
// launch of cross_tile_kernel (affinity_tile.cuh) at f32:
//
//   rt_pairwise_sq_dists   <- pairwise_sq_dists_pallas (l.79), epilogue
//                             kSqDistDiff
//   rt_rbf_cross_affinity  <- rbf_cross_affinity_pallas (l.128), kRbf
//   rt_rbf_affinity        <- rbf_affinity_pallas (l.103), kRbfZeroDiag
//                             with y = x
//
// The TPU kernels tile the (n, m) output into 128 x 128 VMEM blocks and
// run the x . y^T inner product on the MXU.  With d <= 32 an entry is a
// handful of FMAs, so on the card these kernels are bound by the bytes
// they write, not by arithmetic: at the dense path's n = m = 2048, d = 8
// the 16.8 MB output takes ~5 us at 3.35 TB/s, and the unfused Nystrom
// block (N = 100 000, m = 512) writes 205 MB, ~62 us.  cross_tile_kernel
// (B1's kernel too) prepares every point once a block and writes each row
// of a thread's columns with one 16-byte streaming store.
//
// Every entry takes `rows`, the rows of a tile, from the wrapper's
// kernels/affinity.py::cross_tile_plan, launches on the caller's stream,
// allocates nothing and returns cudaGetLastError()
// (cudaErrorInvalidValue for a d or rows it does not take).

#include <cuda_runtime.h>

#include "affinity_tile.cuh"

using namespace rt;

extern "C" {

// out (n, m) = |x_i - y_j|^2 in the difference form
int rt_pairwise_sq_dists(const float* x, const float* y, float* out, int n,
                         int m, int d, int rows, void* stream) {
  return launch_cross_tile<kF32, kSqDistDiff>(x, y, 0.f, out, n, m, d, rows,
                                              stream);
}

// out (n, m) = exp(-gamma * d^2(x_i, y_j))
int rt_rbf_cross_affinity(const float* x, const float* y, float gamma,
                          float* out, int n, int m, int d, int rows,
                          void* stream) {
  return launch_cross_tile<kF32>(x, y, gamma, out, n, m, d, rows, stream);
}

// out (n, n) = exp(-gamma * d^2(x_i, x_j)), zero diagonal
int rt_rbf_affinity(const float* x, float gamma, float* out, int n, int d,
                    int rows, void* stream) {
  return launch_cross_tile<kF32, kRbfZeroDiag>(x, x, gamma, out, n, n, d,
                                               rows, stream);
}

}  // extern "C"
