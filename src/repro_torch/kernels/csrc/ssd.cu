// Mamba-2 SSD intra-chunk block (the per-chunk dual form) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_pallas.py ::
// ssd_chunk_pallas.  Per (batch b, chunk, head h), with the head's group
// g = h / (H / G):
//   att[i, j] = C[i] . B[j]                                   (Q, Q)
//   M[i, j]   = att[i, j] * exp(cs[i] - cs[j]) for j <= i, else 0
//   y[i]      = sum_j M[i, j] * xdt[j]                        (Q, P)
//   state     = sum_q xdt[q]^T (B[q] * exp(cs[Q-1] - cs[q]))   (P, N)
// The inter-chunk recurrence stays in PyTorch (models/mamba.py).
//
// Bound on an H100 (chip_smoke.py::_ssd_bound computes it per call): at
// the mamba2 prefill, Q = 256, P = 64, N = 128, the lower triangle of
// C.B^T and of M.xdt plus the state are ~17 MFLOP a cell, ~11 GFLOP over
// the 640 cells of S = 2048, against ~106 MB.  The table's bound counts
// the bf16 C.B^T (5.4 GFLOP) at the 989 TFLOP/s of the tensor cores and
// the rest (5.4 GFLOP) at the 67 TFLOP/s of f32 FMA: 0.087 ms, by
// operations.  All of it at the f32 rate, as this kernel computes it on
// the CUDA cores, would take 0.16 ms.
//
// Design.  One block of 256 threads per (head, chunk, batch).  The TPU
// kernel keeps the whole (Q, Q) M in VMEM; at Q = 256 that is 256 KB of
// f32, more than a block's 227 KB of shared memory, so the block walks M in
// 64 x 64 tiles: for each row tile i it builds M[i, j-tile] for the column
// tiles on or below the diagonal only (C_i B_j^T, then the decay) and
// accumulates y_i in registers.  exp(cs_i - cs_j) is evaluated only where
// j <= i: cs falls within a chunk, so the upper triangle could overflow to
// inf, and inf * 0 is NaN.  A second pass over the rows accumulates the
// (P, N) state in registers.  Thread (ty, tx) of a 16 x 16 grid owns a
// 4 x 4 patch of each score tile; C and B tiles are staged transposed so
// the inner product reads float4s.  B and C are f32 or bf16, converted to
// f32 in shared memory; every sum is f32.  P and N are template parameters
// (the reduced 16/16 and mamba2's 64/128); Q is any length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 256;
constexpr int LDT = TILE + 4;   // row stride of the transposed tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int P, int N>
constexpr size_t smem_floats() {
  // cT [N][LDT] (reused as the state pass's bw [TILE][N]), bT [N][LDT],
  // xs [TILE][P], mT [TILE][LDT], csi and csj [TILE]
  return 2 * (size_t)N * LDT + (size_t)TILE * P + (size_t)TILE * LDT +
         2 * TILE;
}

template <typename TB, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ cs,
                 const TB* __restrict__ bm, const TB* __restrict__ cm,
                 float* __restrict__ y, float* __restrict__ st, int nc,
                 int Q, int H, int G) {
  constexpr int PC = P / 16;    // y columns per thread
  constexpr int SR = P / 16;    // state rows per thread
  constexpr int SC = N / 16;    // state columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* cT = smem;                 // cT[n][i]
  float* bT = cT + N * LDT;         // bT[n][j]
  float* xs = bT + N * LDT;         // xs[j][p]
  float* mT = xs + TILE * P;        // mT[j][i]
  float* csi = mT + TILE * LDT;
  float* csj = csi + TILE;
  float* bw = cT;                   // state pass: bw[q][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int h = blockIdx.x;
  const int chunk = (int)blockIdx.z * nc + (int)blockIdx.y;   // b * c + ci
  const int g = h / (H / G);
  const long long row0 = (long long)chunk * Q;   // first row of the chunk
  const float* xb = xdt + row0 * H * P + (long long)h * P;    // row q: q*H*P
  const float* csb = cs + row0 * H + h;                       // row q: q*H
  const TB* bb = bm + row0 * G * N + (long long)g * N;        // row q: q*G*N
  const TB* cb = cm + row0 * G * N + (long long)g * N;
  float* yb = y + row0 * H * P + (long long)h * P;
  float* sb = st + ((long long)chunk * H + h) * P * N;

  const int ntiles = (Q + TILE - 1) / TILE;
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * TILE;
    __syncthreads();   // the previous row tile's C is consumed
    for (int idx = tid; idx < TILE * N; idx += THREADS) {
      const int r = idx / N, n = idx % N;
      const int i = i0 + r;
      cT[n * LDT + r] = i < Q ? to_f32(cb[(long long)i * G * N + n]) : 0.f;
    }
    for (int r = tid; r < TILE; r += THREADS)
      csi[r] = i0 + r < Q ? csb[(long long)(i0 + r) * H] : 0.f;

    float yacc[4][PC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < PC; ++e) yacc[a][e] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {   // column tiles on or below the diagonal
      const int j0 = jt * TILE;
      __syncthreads();   // the previous column tile's B, x and M are consumed
      for (int idx = tid; idx < TILE * N; idx += THREADS) {
        const int r = idx / N, n = idx % N;
        const int j = j0 + r;
        bT[n * LDT + r] = j < Q ? to_f32(bb[(long long)j * G * N + n]) : 0.f;
      }
      for (int idx = tid; idx < TILE * P; idx += THREADS) {
        const int r = idx / P, p = idx % P;
        const int j = j0 + r;
        xs[r * P + p] = j < Q ? xb[(long long)j * H * P + p] : 0.f;
      }
      for (int r = tid; r < TILE; r += THREADS)
        csj[r] = j0 + r < Q ? csb[(long long)(j0 + r) * H] : 0.f;
      __syncthreads();

      float att[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) att[a][c] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float4 cv4 = *reinterpret_cast<const float4*>(cT + n * LDT + 4 * ty);
        const float4 bv4 = *reinterpret_cast<const float4*>(bT + n * LDT + 4 * tx);
        const float cv[4] = {cv4.x, cv4.y, cv4.z, cv4.w};
        const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) att[a][c] = fmaf(cv[a], bv[c], att[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = 4 * ty + a;
        const int i = i0 + il;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int jl = 4 * tx + c;
          const int j = j0 + jl;
          // mask before the exp: above the diagonal exp may overflow
          const float mval = (j <= i && i < Q)
                                 ? att[a][c] * expf(csi[il] - csj[jl])
                                 : 0.f;
          mT[jl * LDT + il] = mval;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int jl = 0; jl < TILE; ++jl) {
        const float4 m4 = *reinterpret_cast<const float4*>(mT + jl * LDT + 4 * ty);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
        float xv[PC];
#pragma unroll
        for (int e = 0; e < PC; ++e) xv[e] = xs[jl * P + tx * PC + e];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < PC; ++e) yacc[a][e] = fmaf(mv[a], xv[e], yacc[a][e]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + 4 * ty + a;
      if (i >= Q) continue;
#pragma unroll
      for (int e = 0; e < PC; ++e)
        yb[(long long)i * H * P + tx * PC + e] = yacc[a][e];
    }
  }

  // state = xdt^T (B * exp(cs[Q-1] - cs)), (P, N)
  const float cs_last = csb[(long long)(Q - 1) * H];
  float sacc[SR][SC];
#pragma unroll
  for (int a = 0; a < SR; ++a)
#pragma unroll
    for (int e = 0; e < SC; ++e) sacc[a][e] = 0.f;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * TILE;
    __syncthreads();
    for (int idx = tid; idx < TILE * N; idx += THREADS) {
      const int r = idx / N, n = idx % N;
      const int j = j0 + r;
      bw[r * N + n] = j < Q ? to_f32(bb[(long long)j * G * N + n]) *
                                  expf(cs_last - csb[(long long)j * H])
                            : 0.f;
    }
    for (int idx = tid; idx < TILE * P; idx += THREADS) {
      const int r = idx / P, p = idx % P;
      const int j = j0 + r;
      xs[r * P + p] = j < Q ? xb[(long long)j * H * P + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < TILE; ++r) {
      float xv[SR], bv[SC];
#pragma unroll
      for (int a = 0; a < SR; ++a) xv[a] = xs[r * P + ty * SR + a];
#pragma unroll
      for (int e = 0; e < SC; ++e) bv[e] = bw[r * N + tx * SC + e];
#pragma unroll
      for (int a = 0; a < SR; ++a)
#pragma unroll
        for (int e = 0; e < SC; ++e) sacc[a][e] = fmaf(xv[a], bv[e], sacc[a][e]);
    }
  }
#pragma unroll
  for (int a = 0; a < SR; ++a)
#pragma unroll
    for (int e = 0; e < SC; ++e)
      sb[(ty * SR + a) * N + tx * SC + e] = sacc[a][e];
}

template <typename TB, int P, int N>
int launch(const float* xdt, const float* cs, const void* bm, const void* cm,
           float* y, float* st, int B, int nc, int Q, int H, int G,
           cudaStream_t stream) {
  const size_t smem = smem_floats<P, N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<TB, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, nc, B);
  ssd_chunk_kernel<TB, P, N><<<grid, THREADS, smem, stream>>>(
      xdt, cs, static_cast<const TB*>(bm), static_cast<const TB*>(cm), y, st,
      nc, Q, H, G);
  return (int)cudaGetLastError();
}

template <typename TB>
int dispatch_shape(int P, int N, const float* xdt, const float* cs,
                   const void* bm, const void* cm, float* y, float* st,
                   int B, int nc, int Q, int H, int G, cudaStream_t stream) {
  if (P == 16 && N == 16)
    return launch<TB, 16, 16>(xdt, cs, bm, cm, y, st, B, nc, Q, H, G, stream);
  if (P == 64 && N == 128)
    return launch<TB, 64, 128>(xdt, cs, bm, cm, y, st, B, nc, Q, H, G,
                               stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xdt (B, c, Q, H, P) f32, cs (B, c, Q, H) f32, bm and cm (B, c, Q, G, N),
// all contiguous; y (B, c, Q, H, P) and st (B, c, H, P, N) f32 outputs.
// bc_dtype 0 = f32, 1 = bf16 (bm and cm).
extern "C" int rt_ssd_chunk(const void* xdt, const void* cs, const void* bm,
                            const void* cm, void* y, void* st, int bc_dtype,
                            int B, int nc, int Q, int H, int G, int P, int N,
                            void* stream) {
  if (B < 1 || nc < 1 || Q < 1 || G < 1 || H % G != 0 || nc > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xdt);
  const float* c = static_cast<const float*>(cs);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(st);
  if (bc_dtype == 0)
    return dispatch_shape<float>(P, N, x, c, bm, cm, yo, so, B, nc, Q, H, G,
                                 s);
  if (bc_dtype == 1)
    return dispatch_shape<__nv_bfloat16>(P, N, x, c, bm, cm, yo, so, B, nc,
                                         Q, H, G, s);
  return (int)cudaErrorInvalidValue;
}
