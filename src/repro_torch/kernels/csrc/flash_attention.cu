// Flash attention (GQA, causal and/or sliding window) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_pallas.py ::
// flash_attention_pallas.  out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h/G]
// * scale, masked) @ v[b, t, h/G], with the masks applied per element:
// t < T, causal t <= s, window t > s - window.  Same constants as the TPU
// kernel: masked scores are -1e30, and the row sum is clamped at 1e-30.
//
// Bound on an H100 (chip_smoke.py::_flash_bound computes it per call): at
// the LM server's prefill, causal S = 2048 against a 2112-row cache,
// H = 28, dh = 128, bf16, the causal mask leaves S (S + 1) / 2 scores a
// head at 4 dh + 5 operations each, ~30 GFLOP against ~34 MB of q, k, v
// and out.  The table's bound counts bf16 inputs at the 989 TFLOP/s of
// the tensor cores: 0.031 ms, by operations.  This kernel does its
// arithmetic in f32 on the CUDA cores, whose 67 TFLOP/s give 0.45 ms; a
// later wgmma redesign aims at the first figure.
//
// Design.  One block of 256 threads per (q tile of BQ = 64 rows, b * H + h);
// a loop over KV tiles of BK = 64 rows inside the block takes the place of
// the TPU's sequential KV grid axis and its VMEM scratch.  The running max
// m, sum l and the (BQ, dh) accumulator stay in f32 registers: thread (ty,
// tx) of a 16 x 16 grid owns q rows 4*ty .. 4*ty+3, the score columns
// 4*tx .. 4*tx+3 of each tile and the output columns tx*dh/16 ..; a row's
// max and sum are reduced across the 16 lanes of a half warp with
// shuffles.  q, k and v are read in the JAX layout (B, S, H, dh) through
// their strides (q head h reads KV head h / G), converted to f32 once, and
// staged in shared memory transposed, so the inner products read float4s.
// KV tiles that the causal or window mask hides entirely are skipped, so a
// prefill against a max_seq cache costs O(S^2), not O(S * max_seq).  The
// tiles take up to 117 KB of dynamic shared memory at dh = 128.  Inputs are
// f32 or bf16; the sums are f32; out is written in v's dtype (the same).
// The products run on the CUDA cores in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDQ = BQ + 4;   // row stride of the transposed q and p tiles
constexpr int LDK = BK + 4;   // row stride of the transposed k tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)DH * LDQ + (size_t)DH * LDK + (size_t)BK * DH +
         (size_t)BK * LDQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int T_len, int H, int G, float scale, int causal,
                       int window, long long q_sb, long long q_ss,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh) {
  constexpr int NC = DH / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;                  // [DH][LDQ]: qT[d][r]
  float* kT = qT + DH * LDQ;         // [DH][LDK]: kT[d][c]
  float* vs = kT + DH * LDK;         // [BK][DH]
  float* pT = vs + BK * DH;          // [BK][LDQ]: pT[c][r]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q_start = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / G;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int s = q_start + r;
    qT[d * LDQ + r] = s < S ? to_f32(qb[s * q_ss + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  const int nk = (T_len + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * BK;
    // the TPU kernel's block-level skip (the same for every thread)
    bool live = true;
    if (causal) live = live && k_start <= q_start + BQ - 1;
    if (window > 0) live = live && k_start + BK - 1 > q_start - window;
    if (!live) continue;

    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int idx = tid; idx < BK * DH; idx += THREADS) {
      const int c = idx / DH, d = idx % DH;
      const int t = k_start + c;
      const bool in = t < T_len;
      kT[d * LDK + c] = in ? to_f32(kb[t * k_ss + d]) : 0.f;
      vs[c * DH + d] = in ? to_f32(vb[t * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * LDQ + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(kT + d * LDK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_start + 4 * ty + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k_start + 4 * tx + j;
        bool ok = kp < T_len;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        row_max = fmaxf(row_max, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        pT[(4 * tx + j) * LDQ + 4 * ty + i] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(pT + c * LDQ + 4 * ty);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = vs[c * DH + tx * NC + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q_start + 4 * ty + i;
    if (s >= S) continue;           // q rows past S are not stored
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * S + s) * H + h) * DH + tx * NC;
#pragma unroll
    for (int j = 0; j < NC; ++j) store(orow + j, acc[i][j] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_len, int H, int G, float scale, int causal,
           int window, const long long* st, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, H, G, scale,
      causal, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                int B, int S, int T_len, int H, int G, float scale,
                int causal, int window, const long long* st,
                cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, T_len, H, G, scale, causal,
                           window, st, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, T_len, H, G, scale, causal,
                           window, st, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, T_len, H, G, scale, causal,
                            window, st, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, dh), k and v (B, T, K, dh), each with unit stride along dh
// and element strides (batch, seq, head) given in `strides` as q's, k's,
// then v's; out (B, S, H, dh) contiguous.  dtype 0 = f32, 1 = bf16, for all
// four.  window <= 0 means no window.
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, int dtype, int B,
                                  int S, int T_len, int H, int K, int dh,
                                  float scale, int causal, int window,
                                  const long long* strides, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || K < 1 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k, v, out, B, S, T_len, H, G, scale,
                              causal, window, strides, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, out, B, S, T_len, H, G,
                                      scale, causal, window, strides, s);
  return (int)cudaErrorInvalidValue;
}
