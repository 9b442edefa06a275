// Flash attention (GQA, causal and/or sliding window) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention_pallas.py ::
// flash_attention_pallas.  out[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h/G]
// * scale, masked) @ v[b, t, h/G], with the masks applied per element:
// t < T, causal t <= s, window t > s - window.  Same constants as the TPU
// kernel: masked scores are -1e30, and the row sum is clamped at 1e-30.
// The scale is the caller's (1 / sqrt(dh) by default, in the wrapper).  q
// and k are dh wide and v dv wide, so out is (B, S, H, dv): the square
// widths 32, 64, 128 and 256, and deepseek-v3's MLA prefill, q/k 192 (128
// without RoPE + 64 with) against v 128, and its reduced config's 48
// against 32.  Both bodies are templates on (DH, DV): Q K^T runs over DH;
// P V, the O accumulator and the stores over DV.
//
// Bound on an H100 (chip_smoke.py::_flash_bound computes it per call): at
// the LM server's prefill, causal S = 2048 against a 2112-row cache,
// H = 28, dh = 128, bf16, the causal mask leaves S (S + 1) / 2 scores a
// head at 4 dh + 5 operations each, ~30 GFLOP against ~34 MB of q, k, v
// and out: 0.031 ms at the 989 TFLOP/s of the bf16 tensor cores, bound
// by operations.  The bf16 kernel issues P.V twice (the hi/lo split
// below), so its tensor-core work is 1.5x that of the bound, ~0.046 ms.
//
// Two bodies.
//
// bf16 (flash_bf16_kernel): FlashAttention-2's forward schedule on the
// tensor cores.  A block of 4 warps owns BQ = 64 q rows of one (b, h),
// 16 rows a warp, and loops over KV tiles of BK rows (64; 32 at dh = 256,
// where the 128-float O accumulator leaves no registers for more).  The
// grid is (B * H, q tiles); a causal call walks the q tiles from the last
// (longest rows) to the first, so the triangle's long blocks start first
// and the short ones fill the tail.  Only the live KV tiles are visited:
// fully masked ones are never loaded.
//   - q, k and v arrive by cp.async 16-byte copies (rows of the JAX
//     layout through the given strides, which must be multiples of 8
//     elements, the base 16-byte aligned; rows past S or T are zero
//     filled) into shared memory padded by 16 bytes a row, so ldmatrix
//     reads are conflict-free.  K and V tiles go through a 2-stage ring:
//     tile j + 1 is in flight while tile j computes.
//   - S = Q K^T with mma.sync m16n8k16 (bf16 in, f32 accumulate).  Q
//     fragments come from ldmatrix; at dh <= 128 each warp loads them
//     once and keeps them in registers for the whole KV loop; at dh = 192
//     and 256 it reloads them from shared memory every tile, for want of
//     registers (the kernel sits at 255 at 256, with a small spill).
//     Row-major K is K^T column-major: the B operand by plain ldmatrix.
//   - The online softmax runs on the accumulator fragments in f32: a
//     row's max over the 4 lanes that share it (__shfl_xor_sync), p =
//     exp2(s * scale * log2 e - m) as one FMA, the per-element masks
//     only in tiles that straddle a mask edge, l summed from the f32 p.
//   - O += P V with V by ldmatrix.trans; the S accumulator is repacked
//     in registers as the next mma's A operand (P never goes through
//     shared memory).  The reference takes P.V in f32, and one bf16
//     rounding of P would cost ~2^-9 of the output, the size of the bf16
//     test limit's floor.  So P is split into p_hi = bf16(p) and p_lo =
//     bf16(p - p_hi), two mmas a step: P is then good to 2^-16 of p.
//     Products of bf16 values are exact in f32; every sum is f32.
//   - The output goes through the warp's own rows of the Q tile in shared
//     memory (dv <= dh, so a row of out fits a row of Q) and out to device
//     memory in 16-byte stores.
// wgmma with TMA and warp specialisation (FlashAttention-3's design) is
// the next redesign: mma.sync cannot reach the card's tensor-core peak.
//
// f32 (flash_f32_kernel): the reduced f32 configs' body, exact f32 on the
// CUDA cores (TF32 would break the 1e-5 limit).  One block of 256 threads
// per (64 q rows, b * H + h); thread (ty, tx) of a 16 x 16 grid owns q
// rows 4 ty .. 4 ty + 3, score columns 4 tx .. 4 tx + 3 of each KV tile
// and output columns tx * dv / 16 ..; a row's max and sum are reduced over
// the 16 lanes of a half warp.  q and k are staged in shared memory
// transposed, v as it is (up to 222,208 bytes at dh = dv = 256).  Fully
// masked KV tiles are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;             // q rows a block
constexpr int WARPS = 4;           // 16 q rows a warp
constexpr int TC_THREADS = 32 * WARPS;
constexpr int PAD = 8;             // bf16 elements of padding a smem row

template <int DH, int DV>
struct TcCfg {
  static constexpr int BK = DH == 256 ? 32 : 64;   // KV rows a tile
  static constexpr bool Q_IN_REGS = DH <= 128;
  static constexpr int LD = DH + PAD;              // smem row of Q and K
  static constexpr int LDV = DV + PAD;             // smem row of V
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int K_ELEMS = BK * LD;          // one K tile
  static constexpr int V_ELEMS = BK * LDV;         // one V tile
  static constexpr size_t SMEM =
      (size_t)(Q_ELEMS + 2 * K_ELEMS + 2 * V_ELEMS) * sizeof(__nv_bfloat16);
  static_assert(DH % 16 == 0 && DV % 16 == 0 && DV <= DH,
                "k-steps of 16; out staged in Q's rows");
  static_assert(SMEM <= 232448, "within the 227 KB a block can use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> bf16 hi pair and the bf16 pair of what hi leaves out
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x - __low2float(h),
                                       y - __high2float(h)));
}

// Copy `rows` rows of W bf16 (row r at src + r * stride) into smem rows
// of LD elements; rows at or past `valid` are zero-filled.
template <int W, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int rows,
                                          int valid) {
  constexpr int CHUNKS = W / 8;
  for (int c = threadIdx.x; c < rows * CHUNKS; c += TC_THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const bool in = r < valid;
    cp_async16(dst + r * LD + col, in ? src + r * stride + col : src,
               in ? 16 : 0);
  }
}

template <int DH, int DV>
__global__ void __launch_bounds__(TC_THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int S, int T_len, int H,
                  int G, float scale, int causal, int window,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh) {
  using C = TcCfg<DH, DV>;
  constexpr int BK = C::BK, LD = C::LD, LDV = C::LDV;
  constexpr int KSTEPS = DH / 16;   // k-steps of Q K^T
  constexpr int SN = BK / 8;        // n-tiles of S (8 keys each)
  constexpr int PK = BK / 16;       // k-steps of P V
  constexpr int ON = DV / 8;        // n-tiles of O (8 columns each)

  extern __shared__ float4 smem4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sK = sQ + C::Q_ELEMS;          // 2 stages
  __nv_bfloat16* sV = sK + 2 * C::K_ELEMS;      // 2 stages

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / G;
  const int nq = gridDim.y;
  const int qt = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q_start = qt * BQ;

  // the live KV tiles: [kt_begin, kt_end)
  const int nk = (T_len + BK - 1) / BK;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (q_start + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int x = q_start - window - BK + 1;   // live iff kt * BK > x
    kt_begin = x < 0 ? 0 : x / BK + 1;
  }

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh + q_start * q_ss;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  // this warp's rows
  const int row0 = q_start + warp * 16;
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};   // rows g and g + 8, log2 domain
  float l_r[2] = {0.f, 0.f};           // this lane's part of the row sums
  const float sl2 = scale * LOG2E;

  if (kt_begin < kt_end) {
    load_rows<DH, LD>(sQ, qb, q_ss, BQ, S - q_start);
    {
      const int k0 = kt_begin * BK;
      load_rows<DH, LD>(sK, kb + k0 * k_ss, k_ss, BK, T_len - k0);
      load_rows<DV, LDV>(sV, vb + k0 * v_ss, v_ss, BK, T_len - k0);
    }
    cp_async_commit();

    // Q fragments (A operand): lane address row (lane & 15), col 8 (lane/16)
    const __nv_bfloat16* q_frag =
        sQ + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
    uint32_t qf[C::Q_IN_REGS ? KSTEPS : 1][4];

    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int stage = (kt - kt_begin) & 1;
      if (kt + 1 < kt_end) {
        const int k1 = (kt + 1) * BK;
        load_rows<DH, LD>(sK + (stage ^ 1) * C::K_ELEMS, kb + k1 * k_ss,
                          k_ss, BK, T_len - k1);
        load_rows<DV, LDV>(sV + (stage ^ 1) * C::V_ELEMS, vb + k1 * v_ss,
                           v_ss, BK, T_len - k1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* tK = sK + stage * C::K_ELEMS;
      const __nv_bfloat16* tV = sV + stage * C::V_ELEMS;
      if constexpr (C::Q_IN_REGS) {
        if (kt == kt_begin) {
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks) ldmatrix_x4(qf[ks], q_frag + ks * 16);
        }
      }

      // ---- S = Q K^T (16 x BK a warp) --------------------------------
      float s[SN][4];
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      // K (B operand): lane address key (lane & 7) + 8 (lane / 16),
      // col 8 ((lane / 8) & 1); r0, r1 -> n-tile j, r2, r3 -> j + 1
      const __nv_bfloat16* k_frag =
          tK + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t a[4];
        if constexpr (C::Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
        } else {
          ldmatrix_x4(a, q_frag + ks * 16);
        }
#pragma unroll
        for (int n = 0; n < SN; n += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, k_frag + n * 8 * LD + ks * 16);
          mma_bf16(s[n], a, bk[0], bk[1]);
          mma_bf16(s[n + 1], a, bk[2], bk[3]);
        }
      }

      // ---- online softmax --------------------------------------------
      const int k_start = kt * BK;
      // does any entry of this warp's 16 x BK tile need a mask?
      bool edge = k_start + BK > T_len;
      if (causal) edge = edge || k_start + BK - 1 > row0;
      if (window > 0) edge = edge || k_start <= row0 + 15 - window;
      float mx[2] = {NEG_INF, NEG_INF};
      if (edge) {
#pragma unroll
        for (int n = 0; n < SN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = row0 + g + (e >> 1) * 8;
            const int kp = k_start + n * 8 + 2 * t4 + (e & 1);
            bool ok = kp < T_len;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            s[n][e] = ok ? s[n][e] * sl2 : NEG_INF;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < SN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
      float m_new[2], corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // a live tile's raw max scales to the max of the scaled scores
        m_new[i] = fmaxf(m_r[i], edge ? mx[i] : mx[i] * sl2);
        corr[i] = exp2f(m_r[i] - m_new[i]);
        m_r[i] = m_new[i];
        l_r[i] *= corr[i];
      }
      if (edge) {
#pragma unroll
        for (int n = 0; n < SN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = exp2f(s[n][e] - m_new[e >> 1]);
      } else {
#pragma unroll
        for (int n = 0; n < SN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = exp2f(fmaf(s[n][e], sl2, -m_new[e >> 1]));
      }
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        l_r[0] += s[n][0] + s[n][1];
        l_r[1] += s[n][2] + s[n][3];
      }
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // ---- O += P V ----------------------------------------------------
      // V (B operand, transposed): lane address key (lane & 15), col
      // 8 (lane / 16); r0, r1 -> n-tile d, r2, r3 -> d + 1
      const __nv_bfloat16* v_frag =
          tV + (lane & 15) * LDV + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < PK; ++ks) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * ks][0], s[2 * ks][1], ph[0], pl[0]);
        split_bf16(s[2 * ks][2], s[2 * ks][3], ph[1], pl[1]);
        split_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int n = 0; n < ON; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, v_frag + ks * 16 * LDV + n * 8);
          mma_bf16(acc[n], ph, bv[0], bv[1]);
          mma_bf16(acc[n], pl, bv[0], bv[1]);
          mma_bf16(acc[n + 1], ph, bv[2], bv[3]);
          mma_bf16(acc[n + 1], pl, bv[2], bv[3]);
        }
      }
      __syncthreads();   // the stage is free for the load after next
    }
  }

  // ---- out = acc / l, through this warp's 16 rows of sQ --------------
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
  __nv_bfloat16* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ON; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(sO + g * LD + col) =
        __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(sO + (g + 8) * LD + col) =
        __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CHUNKS = DV / 8;
  for (int c = lane; c < 16 * CHUNKS; c += 32) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const int s_pos = row0 + r;
    if (s_pos >= S) continue;
    __nv_bfloat16* dst = o + (((long long)b * S + s_pos) * H + h) * DV + col;
    *reinterpret_cast<float4*>(dst) =
        *reinterpret_cast<const float4*>(sO + r * LD + col);
  }
}

template <int DH, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int T_len, int H, int G, float scale, int causal,
                int window, const long long* st, cudaStream_t stream) {
  const size_t smem = TcCfg<DH, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DH, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + BQ - 1) / BQ;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, nq);
  flash_bf16_kernel<DH, DV><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, T_len, H, G, scale, causal, window, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;
constexpr int F_BK = 64;
constexpr int F_THREADS = 256;
constexpr int LDQ = F_BQ + 4;   // row stride of the transposed q and p tiles
constexpr int LDK = F_BK + 4;   // row stride of the transposed k tile

template <int DH, int DV>
constexpr size_t f32_smem_floats() {
  return (size_t)DH * LDQ + (size_t)DH * LDK + (size_t)F_BK * DV +
         (size_t)F_BK * LDQ;
}

template <int DH, int DV>
__global__ void __launch_bounds__(F_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int T_len, int H, int G, float scale, int causal,
                 int window, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh) {
  constexpr int NC = DV / 16;   // output columns per thread
  static_assert(DV % 16 == 0, "16 threads share a row of out");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;                  // [DH][LDQ]: qT[d][r]
  float* kT = qT + DH * LDQ;         // [DH][LDK]: kT[d][c]
  float* vs = kT + DH * LDK;         // [F_BK][DV]
  float* pT = vs + F_BK * DV;        // [F_BK][LDQ]: pT[c][r]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q_start = blockIdx.x * F_BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / G;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  for (int idx = tid; idx < F_BQ * DH; idx += F_THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int s = q_start + r;
    qT[d * LDQ + r] = s < S ? qb[s * q_ss + d] : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  const int nk = (T_len + F_BK - 1) / F_BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * F_BK;
    // the TPU kernel's block-level skip (the same for every thread)
    bool live = true;
    if (causal) live = live && k_start <= q_start + F_BQ - 1;
    if (window > 0) live = live && k_start + F_BK - 1 > q_start - window;
    if (!live) continue;

    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int idx = tid; idx < F_BK * DH; idx += F_THREADS) {
      const int c = idx / DH, d = idx % DH;
      const int t = k_start + c;
      kT[d * LDK + c] = t < T_len ? kb[t * k_ss + d] : 0.f;
    }
    for (int idx = tid; idx < F_BK * DV; idx += F_THREADS) {
      const int c = idx / DV, d = idx % DV;
      const int t = k_start + c;
      vs[c * DV + d] = t < T_len ? vb[t * v_ss + d] : 0.f;
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
    for (int c = 0; c < F_BK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(pT + c * LDQ + 4 * ty);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = vs[c * DV + tx * NC + j];
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
    float* orow = o + (((long long)b * S + s) * H + h) * DV + tx * NC;
#pragma unroll
    for (int j = 0; j < NC; ++j) orow[j] = acc[i][j] / denom;
  }
}

template <int DH, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int T_len, int H, int G, float scale, int causal,
               int window, const long long* st, cudaStream_t stream) {
  const size_t smem = f32_smem_floats<DH, DV>() * sizeof(float);
  static_assert(f32_smem_floats<DH, DV>() * sizeof(float) <= 232448,
                "within the 227 KB a block can use");
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DH, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + F_BQ - 1) / F_BQ, B * H);
  flash_f32_kernel<DH, DV><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T_len, H, G,
      scale, causal, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8]);
  return (int)cudaGetLastError();
}

template <int DH, int DV>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int B, int S, int T_len, int H, int G, float scale, int causal,
           int window, const long long* st, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<DH, DV>(q, k, v, o, B, S, T_len, H, G, scale, causal,
                              window, st, stream);
  if (dtype == 1)
    return launch_bf16<DH, DV>(q, k, v, o, B, S, T_len, H, G, scale, causal,
                               window, st, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q and k (B, S or T, H or K, dh), v (B, T, K, dv), each with unit
// stride along its width and element strides (batch, seq, head) given in
// `strides` as q's, k's, then v's; out (B, S, H, dv) contiguous.  (dh, dv)
// is one of the pairs below; dtype 0 = f32, 1 = bf16, for all of them;
// bf16 strides are multiples of 8 and the pointers 16-byte aligned.
// window <= 0 means no window.
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, int dtype, int B,
                                  int S, int T_len, int H, int K, int dh,
                                  int dv, float scale, int causal,
                                  int window, const long long* strides,
                                  void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || K < 1 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_FLASH_PAIR(DH, DV)                                              \
  if (dh == DH && dv == DV)                                                \
    return launch<DH, DV>(dtype, q, k, v, out, B, S, T_len, H, G, scale,  \
                          causal, window, strides, s);
  RT_FLASH_PAIR(32, 32)
  RT_FLASH_PAIR(64, 64)
  RT_FLASH_PAIR(128, 128)
  RT_FLASH_PAIR(256, 256)
  RT_FLASH_PAIR(192, 128)   // deepseek-v3's MLA prefill
  RT_FLASH_PAIR(48, 32)     // its reduced config
#undef RT_FLASH_PAIR
  return (int)cudaErrorInvalidValue;
}
