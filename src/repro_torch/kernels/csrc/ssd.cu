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
// the mamba2 prefill, B = 1, 8 chunks of Q = 256, H = 80 heads in G = 1
// group, P = 64, N = 128.  C.B^T depends on the group only: 8 products of
// 8.4 MFLOP (lower triangle), 67 MFLOP on the bf16 tensor cores, ~0.1 us.
// What is left is per head and in f32 on the CUDA cores: M.x (4.2 MFLOP
// a head and chunk) and the state (4.2 MFLOP), 5.4 GFLOP over the 640
// (chunk, head) cells: 0.081 ms at 67 TFLOP/s, by operations (~106 MB of
// inputs and outputs take 0.032 ms).
//
// Design.  Every head of a group shares C.B^T (80 heads at G = 1), and
// 4 x 4 register tiles are bound by shared-memory reads (8 floats for 16
// FMAs), so:
//   - A block owns a head set: kHeads heads of one group (the last set of
//     a group is masked when kHeads does not divide H / G), one chunk,
//     and one role: a 64-row tile of y, or a 64-column slice of the
//     states.  The grid lists the roles heaviest first (the state slices
//     and the last row tile walk every row of the chunk; row tile i walks
//     i + 1 tiles), then (batch, chunk, head set): at mamba2's shape 6
//     roles x 8 chunks x 20 sets = 960 blocks, 3.6 waves of 2 blocks an
//     SM.
//   - A row-tile block walks its columns j <= i in steps of kStep rows.
//     Each step builds att = C_i B_j^T ONCE for all its heads: bf16 B/C on
//     the tensor cores (mma.sync m16n8k16 with ldmatrix fragments, f32
//     accumulate: the products of bf16 inputs are exact in f32); f32 B/C
//     on the CUDA cores in f32.  Then per head only the decay differs:
//     M = att * exp(cs_i - cs_j), evaluated only where j <= i (cs falls
//     within a chunk, so the upper triangle could overflow to inf, and
//     inf * 0 is NaN), stored transposed in shared memory.
//   - y += M x and the state += x^T (B * decay) run on the CUDA cores in
//     exact f32, 8 x 8 outputs a thread (16 shared-memory floats for 64
//     FMAs): 64 threads a head, 4 heads x 64 rows x P = 64 columns a
//     block.  A thread's columns (and a state thread's rows) are two
//     float4 groups half the tile apart, so a warp's float4 reads are
//     contiguous or broadcast; a y thread's 8 rows are contiguous.
//   - B, x and cs rows stream through a cp.async ring of kStages stages
//     in their natural row layout (16-byte copies; cs, 4 bytes), the next
//     step's rows in flight while this one computes; C's row tile is
//     loaded once.  76 KB (bf16) or 100 KB (f32) of shared memory: 2
//     blocks an SM.
// On the card (PERF.md, section 6) the FMA loop alone runs at about 70 % of
// the f32 peak; a step's M build (the mma chain, 16 exps a thread, the
// barrier after it) takes about a quarter of the time and the copies of
// x a tenth, with 2 blocks an SM at the 128-register cap (~100 bytes of
// spill).
// Every sum runs in one fixed order (j ascending; the mma's own order
// within a step), with no atomics: a repeat call is bit-identical.  P and
// N are template parameters (the reduced 16/16, mamba2's 64/128 and
// jamba's 64/16); Q is any length.  Where N < kStateCols one state block
// owns all N columns (2 a thread at N = 16).  xdt, B and C must be
// 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 4;        // heads of one group a block owns
constexpr int kRowTile = 64;     // rows of y a row-tile block owns
constexpr int kStep = 16;        // rows of B, x and cs a ring stage holds
constexpr int kStages = 2;       // stages of the ring
constexpr int kStateCols = 64;   // state columns a state block owns
constexpr int kLdm = kRowTile + 4;   // row stride of M^T and B * decay

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// Element e of the T values that owner o (0..7) holds along an axis of
// width W = 8 T: for T = 8 two float4 groups W / 2 apart (o*4 + e % 4 and
// W/2 + o*4 + e % 4), so that a warp's float4 reads are contiguous; for
// T = 2 two neighbours.
template <int T, int W>
__device__ __forceinline__ int lane_idx(int o, int e) {
  static_assert(T * 8 == W && (T == 8 || T == 2), "8 owners of 8 or 2");
  if constexpr (T == 8) return (e / 4) * (W / 2) + o * 4 + e % 4;
  return o * T + e;
}
template <int T, int W>
__device__ __forceinline__ void load_vec(const float* p, int o,
                                         float (&v)[T]) {
  if constexpr (T == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(p + h * (W / 2) +
                                                        o * 4);
      v[4 * h] = x.x; v[4 * h + 1] = x.y; v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p + o * 2);
    v[0] = x.x; v[1] = x.y;
  }
}
template <int T, int W>
__device__ __forceinline__ void store_vec(float* p, int o,
                                          const float (&v)[T]) {
  if constexpr (T == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(p + h * (W / 2) + o * 4) = make_float4(
          v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  } else {
    *reinterpret_cast<float2*>(p + o * 2) = make_float2(v[0], v[1]);
  }
}

// Shared-memory layout (byte offsets): C's row tile; the ring of kStages
// stages (B rows, x rows of the head set, cs); M^T (the state blocks:
// B * decay); cs of the tile's rows (the state blocks: of the last row).
// C and B rows are padded by 16 bytes so ldmatrix is conflict-free.
template <typename TB, int P, int N>
struct SsdCfg {
  static constexpr int kLdc = N + 16 / static_cast<int>(sizeof(TB));
  static constexpr int kNs = N < kStateCols ? N : kStateCols;
  static constexpr int kStateBlocks = N / kNs;
  static constexpr int kTn = P / 8;    // y columns a thread
  static constexpr int kTm = P / 8;    // state rows a thread
  static constexpr int kTs = kNs / 8;  // state columns a thread
  static constexpr size_t kCBytes = (size_t)kRowTile * kLdc * sizeof(TB);
  static constexpr size_t kBBytes = (size_t)kStep * kLdc * sizeof(TB);
  static constexpr size_t kXBytes = (size_t)kStep * kHeads * P * 4;
  static constexpr size_t kCsBytes = (size_t)kStep * kHeads * 4;
  static constexpr size_t kStageBytes = kBBytes + kXBytes + kCsBytes;
  static constexpr size_t kRing = kCBytes;
  static constexpr size_t kM = kRing + kStages * kStageBytes;
  static constexpr size_t kCsi = kM + (size_t)kHeads * kStep * kLdm * 4;
  static constexpr size_t kSmem = kCsi + (size_t)kHeads * kRowTile * 4;
  static_assert(N % kNs == 0 && kNs + 4 <= kLdm, "state slices fit M^T");
  static_assert(kCBytes % 16 == 0 && kBBytes % 16 == 0 && kXBytes % 16 == 0
                    && kCsBytes % 16 == 0, "16-byte aligned regions");
  static_assert(N % 16 == 0 && kHeads * kStep * 4 == kThreads, "layout");
};

// Rows j0 .. j0 + kStep - 1 of B, of x for the head set, and of cs into
// ring stage `stage`; rows past Q and heads past the set are zero-filled.
template <typename TB, int P, int N>
__device__ __forceinline__ void load_stage(char* smem, int stage,
                                           const float* xdt, const float* cs,
                                           const TB* bm, long long row0,
                                           int j0, int Q, int H, int G,
                                           int g, int h0, int nheads) {
  using Cf = SsdCfg<TB, P, N>;
  char* base = smem + Cf::kRing + stage * Cf::kStageBytes;
  TB* bs = reinterpret_cast<TB*>(base);
  float* xs = reinterpret_cast<float*>(base + Cf::kBBytes);
  float* css = reinterpret_cast<float*>(base + Cf::kBBytes + Cf::kXBytes);
  constexpr int EL = 16 / sizeof(TB);       // B elements a 16-byte piece
  constexpr int BCH = N / EL;
  for (int e = threadIdx.x; e < kStep * BCH; e += kThreads) {
    const int r = e / BCH, c = e % BCH;
    const bool in = j0 + r < Q;
    cp_async16(bs + r * Cf::kLdc + c * EL,
               bm + ((row0 + (in ? j0 + r : 0)) * G + g) * N + c * EL,
               in ? 16 : 0);
  }
  constexpr int XCH = P / 4;
  for (int e = threadIdx.x; e < kStep * kHeads * XCH; e += kThreads) {
    const int r = e / (kHeads * XCH), t = (e / XCH) % kHeads, c = e % XCH;
    const bool in = j0 + r < Q && t < nheads;
    cp_async16(xs + (r * kHeads + t) * P + c * 4,
               xdt + ((row0 + (in ? j0 + r : 0)) * H + h0 + (in ? t : 0)) * P
                   + c * 4,
               in ? 16 : 0);
  }
  for (int e = threadIdx.x; e < kStep * kHeads; e += kThreads) {
    const int r = e / kHeads, t = e % kHeads;
    const bool in = j0 + r < Q && t < nheads;
    cp_async4(css + e,
              cs + (row0 + (in ? j0 + r : 0)) * H + h0 + (in ? t : 0),
              in ? 4 : 0);
  }
}

// att for warp w's 16 x 8 piece of the (kRowTile x kStep) score tile:
// rows (w % 4) * 16 + lane / 4 (+ 8), columns (w / 4) * 8 + (lane % 4) * 2
// (+ 1), in mma's accumulator order d[0..3].
template <int N, int LDC>
__device__ __forceinline__ void scores(const __nv_bfloat16* ct,
                                       const __nv_bfloat16* bs, int warp,
                                       int lane, float (&d)[4]) {
  const __nv_bfloat16* a = ct + ((warp % 4) * 16 + lane % 16) * LDC +
                           (lane / 16) * 8;
  const __nv_bfloat16* b = bs + ((warp / 4) * 8 + lane % 8) * LDC +
                           ((lane / 8) % 2) * 8;
  d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t af[4], bf[2];
    ldmatrix_x4(af, a + ks * 16);
    ldmatrix_x2(bf, b + ks * 16);
    mma_bf16(d, af, bf[0], bf[1]);
  }
}
template <int N, int LDC>
__device__ __forceinline__ void scores(const float* ct, const float* bs,
                                       int warp, int lane, float (&d)[4]) {
  const float* c0 = ct + ((warp % 4) * 16 + lane / 4) * LDC;
  const float* c1 = c0 + 8 * LDC;
  const float* b0 = bs + ((warp / 4) * 8 + (lane % 4) * 2) * LDC;
  const float* b1 = b0 + LDC;
  d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll 4
  for (int k = 0; k < N; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(c0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(c1 + k);
    const float4 y0 = *reinterpret_cast<const float4*>(b0 + k);
    const float4 y1 = *reinterpret_cast<const float4*>(b1 + k);
    const float cr[2][4] = {{x0.x, x0.y, x0.z, x0.w}, {x1.x, x1.y, x1.z, x1.w}};
    const float br[2][4] = {{y0.x, y0.y, y0.z, y0.w}, {y1.x, y1.y, y1.z, y1.w}};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      d[0] = fmaf(cr[0][kk], br[0][kk], d[0]);
      d[1] = fmaf(cr[0][kk], br[1][kk], d[1]);
      d[2] = fmaf(cr[1][kk], br[0][kk], d[2]);
      d[3] = fmaf(cr[1][kk], br[1][kk], d[3]);
    }
  }
}

// M^T for step s of a row tile: att = C_i B_j^T once for the head set,
// then per head the decay and the mask.
template <typename TB, int P, int N>
__device__ __forceinline__ void build_m(char* smem, int s, int i0, int Q,
                                        int warp, int lane) {
  using Cf = SsdCfg<TB, P, N>;
  const TB* ct = reinterpret_cast<const TB*>(smem);
  const char* stage = smem + Cf::kRing + (s % kStages) * Cf::kStageBytes;
  const TB* bs = reinterpret_cast<const TB*>(stage);
  const float* css =
      reinterpret_cast<const float*>(stage + Cf::kBBytes + Cf::kXBytes);
  const float* csi = reinterpret_cast<const float*>(smem + Cf::kCsi);
  float* mt = reinterpret_cast<float*>(smem + Cf::kM);
  float att[4];
  scores<N, Cf::kLdc>(ct, bs, warp, lane, att);
  const int il0 = (warp % 4) * 16 + lane / 4;
  const int jl0 = (warp / 4) * 8 + (lane % 4) * 2;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int il = il0 + (e / 2) * 8, jl = jl0 + e % 2;
    const int i = i0 + il;
    // mask before the exp: above the diagonal exp may overflow
    const bool live = s * kStep + jl <= i && i < Q;
#pragma unroll
    for (int t = 0; t < kHeads; ++t)
      mt[(t * kStep + jl) * kLdm + il] =
          live ? att[e] * expf(csi[t * kRowTile + il] - css[jl * kHeads + t])
               : 0.f;
  }
}

// B * exp(cs[Q-1] - cs) for step s of a state slice: thread (head pt,
// row pj) takes one exp and a quarter of the columns.
template <typename TB, int P, int N>
__device__ __forceinline__ void build_bw(char* smem, int s, int n0, int Q,
                                         int nheads) {
  using Cf = SsdCfg<TB, P, N>;
  constexpr int kPer = Cf::kNs / 4;
  const int tid = threadIdx.x;
  const int pt = (tid / 4) / kStep, pj = (tid / 4) % kStep, part = tid % 4;
  const char* stage = smem + Cf::kRing + (s % kStages) * Cf::kStageBytes;
  const TB* bs = reinterpret_cast<const TB*>(stage);
  const float* css =
      reinterpret_cast<const float*>(stage + Cf::kBBytes + Cf::kXBytes);
  const float* csl = reinterpret_cast<const float*>(smem + Cf::kCsi);
  float* bw = reinterpret_cast<float*>(smem + Cf::kM);
  const bool in = s * kStep + pj < Q && pt < nheads;
  const float dec = in ? expf(csl[pt] - css[pj * kHeads + pt]) : 0.f;
  const TB* brow = bs + pj * Cf::kLdc + n0 + part * kPer;
  float* wrow = bw + (pt * kStep + pj) * kLdm + part * kPer;
#pragma unroll
  for (int n = 0; n < kPer; ++n) wrow[n] = to_f32(brow[n]) * dec;
}

// The block's walk over its steps of kStep rows (a row-tile block: the
// columns j <= i of its rows; a state block: every row of the chunk).
// Step s waits for its ring stage, starts the copies of step
// s + kStages - 1, builds M^T (or B * decay) for its heads, then runs the
// 8 x 8 FMAs.
template <typename TB, int P, int N, bool kState>
__device__ __forceinline__ void run_block(char* smem, const float* xdt,
                                          const float* cs, const TB* bm,
                                          const TB* cm, float* out,
                                          long long row0, int bc, int first,
                                          int Q, int H, int G, int g, int h0,
                                          int nheads) {
  using Cf = SsdCfg<TB, P, N>;
  constexpr int TR = kState ? Cf::kTm : 8;        // rows a thread
  constexpr int TC = kState ? Cf::kTs : Cf::kTn;  // columns a thread
  constexpr int WR = P;                           // width of x^T's row axis
  constexpr int WC = kState ? Cf::kNs : P;        // width of the column axis
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hg = tid / 64, ry = (tid % 64) / 8, cx = tid % 8;
  float* csx = reinterpret_cast<float*>(smem + Cf::kCsi);

  int nsteps;
  if constexpr (kState) {
    if (tid < kHeads)
      csx[tid] = tid < nheads ? cs[(row0 + Q - 1) * H + h0 + tid] : 0.f;
    nsteps = (Q + kStep - 1) / kStep;
  } else {
    constexpr int EL = 16 / sizeof(TB);
    constexpr int CCH = N / EL;
    TB* ct = reinterpret_cast<TB*>(smem);
    for (int e = tid; e < kRowTile * CCH; e += kThreads) {
      const int r = e / CCH, c = e % CCH;
      const bool in = first + r < Q;
      cp_async16(ct + r * Cf::kLdc + c * EL,
                 cm + ((row0 + (in ? first + r : 0)) * G + g) * N + c * EL,
                 in ? 16 : 0);
    }
    for (int e = tid; e < kHeads * kRowTile; e += kThreads) {   // [t][i]
      const int t = e / kRowTile, i = first + e % kRowTile;
      csx[e] = i < Q && t < nheads ? cs[(row0 + i) * H + h0 + t] : 0.f;
    }
    nsteps = (min(first + kRowTile, Q) + kStep - 1) / kStep;
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nsteps)
      load_stage<TB, P, N>(smem, st, xdt, cs, bm, row0, st * kStep, Q, H, G,
                           g, h0, nheads);
    cp_async_commit();
  }

  float acc[TR][TC];
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int b = 0; b < TC; ++b) acc[a][b] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step s has landed; step s - 1 is consumed
    const int pre = s + kStages - 1;
    if (pre < nsteps)
      load_stage<TB, P, N>(smem, pre % kStages, xdt, cs, bm, row0,
                           pre * kStep, Q, H, G, g, h0, nheads);
    cp_async_commit();
    if constexpr (kState) build_bw<TB, P, N>(smem, s, first, Q, nheads);
    else build_m<TB, P, N>(smem, s, first, Q, warp, lane);
    __syncthreads();   // M^T (or B * decay) is complete
    if (hg < nheads) {
      const float* xs = reinterpret_cast<const float*>(
          smem + Cf::kRing + (s % kStages) * Cf::kStageBytes + Cf::kBBytes)
          + hg * P;
      const float* ms = reinterpret_cast<const float*>(smem + Cf::kM) +
                        hg * kStep * kLdm;
#pragma unroll
      for (int jl = 0; jl < kStep; ++jl) {
        float rv[TR], cv[TC];
        if constexpr (kState) {   // x^T rows p, B * decay columns n
          load_vec<TR, WR>(xs + jl * kHeads * P, ry, rv);
          load_vec<TC, WC>(ms + jl * kLdm, cx, cv);
        } else {                  // M rows i (8 in a row), x columns p
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 m = *reinterpret_cast<const float4*>(
                ms + jl * kLdm + ry * 8 + 4 * h);
            rv[4 * h] = m.x; rv[4 * h + 1] = m.y; rv[4 * h + 2] = m.z;
            rv[4 * h + 3] = m.w;
          }
          load_vec<TC, WC>(xs + jl * kHeads * P, cx, cv);
        }
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int b = 0; b < TC; ++b)
            acc[a][b] = fmaf(rv[a], cv[b], acc[a][b]);
      }
    }
  }
  if (hg >= nheads) return;
  if constexpr (kState) {
    float* sb = out + ((long long)bc * H + h0 + hg) * P * N + first;
#pragma unroll
    for (int a = 0; a < TR; ++a)
      store_vec<TC, WC>(sb + (long long)lane_idx<TR, WR>(ry, a) * N, cx,
                        acc[a]);
  } else {
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int i = first + ry * 8 + a;
      if (i < Q)
        store_vec<TC, WC>(out + ((row0 + i) * H + h0 + hg) * P, cx, acc[a]);
    }
  }
}

// One block from blockIdx.x: its role (the state slices, then the row
// tiles from the last: the heaviest blocks first), then its (batch,
// chunk) and head set.
template <typename TB, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ cs,
                 const TB* __restrict__ bm, const TB* __restrict__ cm,
                 float* __restrict__ y, float* __restrict__ st, int nbc,
                 int Q, int H, int G) {
  using Cf = SsdCfg<TB, P, N>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int R = H / G;
  const int per_group = (R + kHeads - 1) / kHeads;
  const long long cells = (long long)nbc * G * per_group;
  const int ntiles = (Q + kRowTile - 1) / kRowTile;
  const int role = static_cast<int>(blockIdx.x / cells);
  const long long cell = blockIdx.x % cells;
  const int set = static_cast<int>(cell % (G * per_group));
  const int bc = static_cast<int>(cell / (G * per_group));   // b * c + chunk
  const int g = set / per_group;
  const int h0 = g * R + (set % per_group) * kHeads;
  const int nheads = min(kHeads, (g + 1) * R - h0);
  const long long row0 = (long long)bc * Q;
  if (role < Cf::kStateBlocks) {
    run_block<TB, P, N, true>(smem, xdt, cs, bm, cm, st, row0, bc,
                              role * Cf::kNs, Q, H, G, g, h0, nheads);
  } else {
    const int tile = ntiles - 1 - (role - Cf::kStateBlocks);
    run_block<TB, P, N, false>(smem, xdt, cs, bm, cm, y, row0, bc,
                               tile * kRowTile, Q, H, G, g, h0, nheads);
  }
}

template <typename TB, int P, int N>
int launch(const float* xdt, const float* cs, const void* bm, const void* cm,
           float* y, float* st, int B, int nc, int Q, int H, int G,
           cudaStream_t stream) {
  using Cf = SsdCfg<TB, P, N>;
  const long long sets = (long long)G * ((H / G + kHeads - 1) / kHeads);
  const long long roles = Cf::kStateBlocks + (Q + kRowTile - 1) / kRowTile;
  const long long blocks = roles * B * nc * sets;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<TB, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cf::kSmem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<TB, P, N><<<(unsigned)blocks, kThreads, Cf::kSmem,
                               stream>>>(
      xdt, cs, static_cast<const TB*>(bm), static_cast<const TB*>(cm), y, st,
      B * nc, Q, H, G);
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
  if (P == 64 && N == 16)     // jamba-v0.1's Mamba layers
    return launch<TB, 64, 16>(xdt, cs, bm, cm, y, st, B, nc, Q, H, G,
                              stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xdt (B, c, Q, H, P) f32, cs (B, c, Q, H) f32, bm and cm (B, c, Q, G, N),
// all contiguous, xdt, bm and cm 16-byte aligned; y (B, c, Q, H, P) and
// st (B, c, H, P, N) f32 outputs.  bc_dtype 0 = f32, 1 = bf16 (bm, cm).
extern "C" int rt_ssd_chunk(const void* xdt, const void* cs, const void* bm,
                            const void* cm, void* y, void* st, int bc_dtype,
                            int B, int nc, int Q, int H, int G, int P, int N,
                            void* stream) {
  if (B < 1 || nc < 1 || Q < 1 || G < 1 || H % G != 0 ||
      (long long)B * nc > INT_MAX / 2 ||
      ((reinterpret_cast<uintptr_t>(xdt) | reinterpret_cast<uintptr_t>(bm) |
        reinterpret_cast<uintptr_t>(cm)) % 16) != 0)
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
