// Fused gated feed-forward of the LM substrate for Hopper (sm_90a):
//
//   swiglu_fwd  replaces fused_swiglu_pallas
//               (src/repro/kernels/fused_swiglu.py:49; kernel body _kernel
//               :27, pallas_call :64)
//
// out = (act(x @ Wg) * (x @ Wu)) @ Wd, x (M, D), Wg / Wu (D, F), Wd (F, D),
// act = silu (SwiGLU) or the tanh form of gelu (GeGLU), f32 or bf16
// operands.  g and u accumulate in f32, the activation runs in f32, and
// h = act(g) * u is rounded to the operand type before the down product,
// where the TPU kernel rounds it; the down product accumulates in f32 and
// rounds once.  The TPU kernel's bf16 output block sums its F/256 block
// partials in bf16 (56 roundings at F = 14336); here they stay f32, so in
// bf16 the two agree to bf16 rounding (the 3e-2 bound of DESIGN.md §4).
//
// Bound on this card: llama3-8b prefill (M = 2048, D = 4096, F = 14336,
// bf16) does 6 M D F = 721 GFLOP, 0.73 ms at 989 TFLOP/s: operations.  A
// decode step (M = 4) reads 3 D F bf16 weights, 352 MB, 0.105 ms at
// 3.35 TB/s: bytes.
//
// Design.  The TPU kernel carries the down product in its output block
// across its sequential F grid axis and keeps h in VMEM.  Blocks on this
// card run in no order, so the call is two GEMM kernels (plus, with
// split-K, a small fixed-order sum), each owning its whole reduction:
//   1. gate/up: for a (row tile, F tile) the block computes g = x Wg and
//      u = x Wu in f32 registers and writes h = act(g) u, rounded to the
//      operand type, to an (M, F) scratch buffer the wrapper allocates;
//   2. down: out = h Wd, each (row tile, D tile) owning K = F in f32 and
//      storing once; or, with split-K, f32 partials (splits, M, D) that
//      swiglu_split_sum adds in split order.
// h goes through device memory where the TPU kernel keeps it in VMEM: at
// prefill 2048 x 14336 bf16 = 59 MB written and read back, about 0.035 ms
// at 3.35 TB/s.  That replaces the earlier single kernel's 470 MB of f32
// group partials and its shared-memory cap on F per block.
//
// bf16 mainloop: wgmma.mma_async (m64nNk16, f32 accumulators) on operands
// in 128-byte-swizzled shared memory, x / h tiles K-major, weight tiles
// N-major (the weights are row-major (K, N): the transposed-B form).  One
// producer warpgroup (setmaxnreg down to 40) feeds a 4-stage ring with TMA
// (cp.async.bulk.tensor, descriptors from cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint: no -lcuda link) and full / empty mbarriers;
// consumer warpgroups (setmaxnreg up to 232) each own 64 rows and keep one
// wgmma group in flight while the next stage lands.  Two schedules, picked
// by kernels/ops.py swiglu_plan:
//   wide   (M > 64): 2 consumer warpgroups, 128-row tiles; gate/up tiles
//          128 x 128 (g and u: 128 accumulators a thread), down tiles
//          128 x 256; 192 KB of ring, one block per SM;
//   narrow (M <= 64, decode, bound by bytes): 1 consumer warpgroup, 64-row
//          tiles, 64-column tiles in both products and split-K for the
//          down product so that >= 2 x 132 blocks stream Wd; 2-3 blocks
//          and 64-128 KB of TMA loads in flight per SM.
// Grids run row tiles fastest, so the blocks of a wave share weight tiles
// through L2 and each weight byte leaves device memory about once.
// Shapes TMA cannot take (D or F not a multiple of 8, or a base that is
// not 16-byte aligned) run the same kernels with an element-wise producer:
// the producer warpgroup loads with zero fill, writes the swizzled layout
// with st.shared and fences it to the async proxy (cp.async needs rows
// aligned to its copy size, which such shapes do not have).
//
// f32: the same two-kernel structure on the tensor cores in split f32
// (3xTF32, hopper.cuh: each operand split into TF32 hi and lo parts, a_lo
// b_hi + a_hi b_lo + a_hi b_hi per k8 step, small products first, f32
// accumulators), as kernel 7 and kernel 11's f32 path run; one TF32
// product alone would miss the f32 tier's 1e-4 bound.  Bound at M = 128,
// D = 4096, F = 14336: 6 M D F = 45.1 GFLOP, issued three times, 0.27 ms
// at 495 TFLOP/s TF32 (0.67 ms as f32 FMAs); the weights' 705 MB take
// 0.21 ms at 3.35 TB/s, so decode (M <= 16) is bound by bytes.
//  - mma.sync m16n8k8 on tiles staged by a cp.async ring (16-byte copies
//    where rows are 16-byte aligned, 4-byte ones element by element
//    otherwise, so both stay in the ring).  Wide plan: 8 warps as 4 x 2
//    on 128-row tiles, gate/up 64 columns of each weight (224 blocks at F
//    = 14336, more than the 132 SMs), down 128 columns with split-K into
//    at most two waves, 3 stages of K 64; narrow plan (M <= 16): 4 warps
//    side by side on 16-row tiles, 64 columns, 4 stages of K 32, so that
//    224 gate/up and 256 down blocks, two an SM, stream the weights.
//  - Both operands are split at fragment load, in registers.  An element
//    of x or h is split by the 2 warps that share its rows, a weight
//    element by the 4 that share its columns (1 in the narrow plan): at
//    4 instructions a split that is about 2 instructions per mma.sync,
//    fewer than the tensor pipe leaves idle.  Splitting once a stage into
//    shared memory would double each stage and the fragment loads.
//  - Fragment order as in gated_mlp.cu: k = t / t + 4 are A columns 2t /
//    2t + 1 (one 8-byte load) and B rows 2t / 2t + 1.  A row strides of
//    40 words (= 8 mod 32) and B row strides of 68 / 132 (= 4 mod 32)
//    make both fragment loads free of bank conflicts.
//  - The tensor cores add each mma.sync's products into its accumulator
//    rounding toward zero, so one accumulator carried over K = 14336
//    (5,376 additions into it) drifts by ~1e-4 of the result: the first
//    version of this kernel came near the f32 tier's bound on the card,
//    and the CPU model in tests/test_torch_split_f32.py gives 1.3e-4.
//    Each ring stage's products (12 or 24 an accumulator) therefore start
//    from zero and are added into the f32 sum once a stage, rounding to
//    nearest (3.8e-6 at M = 128 on the H100).
//  - The gate/up epilogue computes h = act(g) u on the accumulators (g
//    and u share one fragment layout) and stores h in f32; the down
//    product stores once, or writes f32 partials for swiglu_split_sum.
//
// Any M, D, F >= 1: rows, columns and K past the edge load as zeros (TMA's
// out-of-bounds fill or the producers' masks) and are masked on store.
// Deterministic: no atomics, every sum in a fixed order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int SMEM_LIMIT = 232448;  // a block's dynamic shared memory
constexpr int BK = 64;              // K per ring stage: one 128-byte row
constexpr int STAGES = 4;

// Parameters of one GEMM launch: C = A (m, k) B (k, n), or with `b1` the
// gate/up pair.  Blocks (x, y, z) own rows [x BM, +BM), columns [y BN,
// +BN) and K [z k_split, +k_split).
struct Gemm {
  const void* a;
  const void* b0;
  const void* b1;
  void* out;  // h or out in the operand type, or f32 partials (z, m, n)
  int m, n, k, k_split;
  int act;      // 0 silu, 1 gelu (gate/up only)
  int partial;  // 1: f32 partials at out + z m n
};

__device__ __forceinline__ float activate(float g, int act) {
  if (act == 0) return g * (1.0f / (1.0f + expf(-g)));  // silu
  // gelu, tanh form (jax.nn.gelu(approximate=True))
  const float inner = 0.7978845608028654f * (g + 0.044715f * (g * g * g));
  return g * (0.5f * (1.0f + tanhf(inner)));
}

// Store the pair (v0, v1) at (row, col), (row, col + 1) of the row-major
// (m, n) output, masked; T the output type.
template <typename T>
__device__ __forceinline__ void store2(T* out, int m, int n, int row, int col,
                                       float v0, float v1) {
  if (row >= m || col >= n) return;
  T* p = out + (size_t)row * n + col;
  if constexpr (std::is_same<T, bf16>::value) {
    if (col + 1 < n && (n & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      return;
    }
    p[0] = __float2bfloat16(v0);
    if (col + 1 < n) p[1] = __float2bfloat16(v1);
  } else {
    if (col + 1 < n && (n & 1) == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      return;
    }
    p[0] = v0;
    if (col + 1 < n) p[1] = v1;
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma GEMM
// ---------------------------------------------------------------------------

// byte offset of element (r, c), c < 64, in a tile of 128-byte rows under
// the 128-byte swizzle (16-byte chunk c / 8 XOR r % 8), as TMA writes it
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

template <int N>
__device__ __forceinline__ void wgmma_bn(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_n64(d, da, db, 1);
  if constexpr (N == 128) wgmma_n128(d, da, db, 1);
  if constexpr (N == 256) wgmma_n256(d, da, db, 1);
}

// WG consumer warpgroups (BM = 64 WG rows) + 1 producer warpgroup; BN
// columns per tile; DUAL: gate/up (h = act(A B0) * (A B1)), else one
// product; TMA: the producer loads with TMA, else element by element.
// Shared memory, 1024-byte aligned: STAGES x [A (BM x 64), B0 (and B1)
// (64 x BN, as BN / 64 chunks of 64 x 64)], then the full / empty barriers.
template <int WG, int BN, bool DUAL, bool TMA>
__global__ void __launch_bounds__(128 * (WG + 1), WG == 1 ? 2 : 1)
    wgmma_gemm(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb0,
               const __grid_constant__ CUtensorMap tb1, const Gemm p) {
  constexpr int BM = 64 * WG;
  constexpr int NB = DUAL ? 2 : 1;
  constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
  constexpr int STAGE = A_BYTES + NB * B_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * p.k_split;
  const int k_end = min(p.k, k_begin + p.k_split);
  const int steps = (k_end - k_begin + BK - 1) / BK;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], TMA ? 1 : 128);
      mbar_init(&empty[s], WG * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == WG) {
    // ---- producer warpgroup ----
    if constexpr (WG > 1) setmaxnreg_dec<40>();
    if constexpr (TMA) {
      if (tid == 0) {
        for (int s = 0; s < steps; ++s) {
          const int st = s % STAGES;
          mbar_wait(&empty[st], ((s / STAGES) & 1) ^ 1);
          unsigned char* base = smem + st * STAGE;
          const int k0 = k_begin + s * BK;
          mbar_arrive_expect_tx(&full[st], STAGE);
          tma_load_2d(base, &ta, k0, m0, &full[st]);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            tma_load_2d(base + A_BYTES + j * 8192, &tb0, n0 + 64 * j, k0,
                        &full[st]);
            if constexpr (DUAL)
              tma_load_2d(base + A_BYTES + B_BYTES + j * 8192, &tb1,
                          n0 + 64 * j, k0, &full[st]);
          }
        }
      }
    } else {
      const bf16* a = static_cast<const bf16*>(p.a);
      const bf16* b0 = static_cast<const bf16*>(p.b0);
      const bf16* b1 = static_cast<const bf16*>(p.b1);
      const bf16 zero = __float2bfloat16(0.0f);
      for (int s = 0; s < steps; ++s) {
        const int st = s % STAGES;
        mbar_wait(&empty[st], ((s / STAGES) & 1) ^ 1);
        unsigned char* base = smem + st * STAGE;
        const int k0 = k_begin + s * BK;
        for (int i = tid; i < BM * 64; i += 128) {
          const int r = i >> 6, c = i & 63;
          const int gr = m0 + r, gc = k0 + c;
          *reinterpret_cast<bf16*>(base + swz(r, c)) =
              gr < p.m && gc < p.k ? a[(size_t)gr * p.k + gc] : zero;
        }
        for (int i = tid; i < 64 * BN; i += 128) {
          const int r = i / BN, c = i - r * BN;
          const int gr = k0 + r, gc = n0 + c;
          const bool in = gr < p.k && gc < p.n;
          const int off = A_BYTES + (c >> 6) * 8192 + swz(r, c & 63);
          *reinterpret_cast<bf16*>(base + off) =
              in ? b0[(size_t)gr * p.n + gc] : zero;
          if constexpr (DUAL)
            *reinterpret_cast<bf16*>(base + B_BYTES + off) =
                in ? b1[(size_t)gr * p.n + gc] : zero;
        }
        fence_proxy_async();
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---- consumer warpgroup wg: rows [m0 + 64 wg, +64) ----
    if constexpr (WG > 1) setmaxnreg_inc<232>();
    float acc0[BN / 2], acc1[DUAL ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc0[i] = 0.0f;
    if constexpr (DUAL) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc1[i] = 0.0f;
    }
    const int lane = tid & 31;
    for (int s = 0; s < steps; ++s) {
      const int st = s % STAGES;
      mbar_wait(&full[st], (s / STAGES) & 1);
      const uint32_t a_addr = smem_u32(smem + st * STAGE + wg * 64 * 128);
      const uint32_t b_addr = smem_u32(smem + st * STAGE + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = wgmma_desc(a_addr + kk * 32, 16, 1024);
        wgmma_bn<BN>(acc0, da, wgmma_desc(b_addr + kk * 2048, 8192, 1024));
        if constexpr (DUAL)
          wgmma_bn<BN>(acc1, da,
                       wgmma_desc(b_addr + B_BYTES + kk * 2048, 8192, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % STAGES]);
    }
    wgmma_wait<0>();

    // epilogue: accumulator (row 16 w + l / 4 + 8 e2, col 8 j + 2 (l % 4))
    const int row = m0 + wg * 64 + (tid >> 5) * 16 + (lane >> 2);
    const int col = n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float v0 = acc0[4 * j + 2 * h2], v1 = acc0[4 * j + 2 * h2 + 1];
        if constexpr (DUAL) {
          v0 = activate(v0, p.act) * acc1[4 * j + 2 * h2];
          v1 = activate(v1, p.act) * acc1[4 * j + 2 * h2 + 1];
        }
        if (p.partial)
          store2(static_cast<float*>(p.out) + (size_t)blockIdx.z * p.m * p.n,
                 p.m, p.n, row + 8 * h2, col + 8 * j, v0, v1);
        else
          store2(static_cast<bf16*>(p.out), p.m, p.n, row + 8 * h2,
                 col + 8 * j, v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: split-f32 (3xTF32) GEMM on mma.sync
// ---------------------------------------------------------------------------

// Tile shape of one instantiation: WM x WN warps, each owning MT m16 tiles
// by NT n8 tiles of every B operand (NB = 2 for the gate/up pair); a ring
// of STAGES stages of SK (32 or 64) K each.
template <int MT, int NT, int WM, int WN, bool DUAL, int SK_, int STAGES_>
struct SplitShape {
  static constexpr int NB = DUAL ? 2 : 1, SK = SK_, STAGES = STAGES_;
  static constexpr int BM = WM * 16 * MT, BN = WN * 8 * NT;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int LDA = SK + 8;  // A rows: stride = 8 (mod 32) words
  static constexpr int LDB = BN + 4;  // B rows: stride = 4 (mod 32) words
  // a stage: A (BM, LDA), then NB B tiles (SK, LDB)
  static constexpr int STAGE = BM * LDA + NB * SK * LDB;  // floats
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;
};

// the (ROWS, COLS) tile at (r0, c0) of a row-major (nrows, ncols) f32
// matrix into shared memory with row stride ld, zeros outside the matrix;
// vec: 16-byte cp.async (ncols % 4 == 0, 16-byte aligned base), else
// 4-byte cp.async, so that both stay in the ring.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int nrows, int ncols, int r0,
                                          int c0, bool vec) {
  if (vec) {
    constexpr int VPR = COLS / 4;
    for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
      const int r = i / VPR, c = (i - r * VPR) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < nrows && gc < ncols;
      cp_async16(dst + r * ld + c, in ? src + (size_t)gr * ncols + gc : src,
                 in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i - r * COLS;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < nrows && gc < ncols;
      cp_async4(dst + r * ld + c, in ? src + (size_t)gr * ncols + gc : src,
                in);
    }
  }
}

// Block (x, y, z) owns rows [x BM, +BM), columns [y BN, +BN) and K [z
// k_split, +k_split).  Warp w owns rows [(w % WM) 16 MT, +16 MT) and
// columns [(w / WM) 8 NT, +8 NT) of the tile.  Fragment order (as in
// gated_mlp.cu): k = t / t + 4 of each k8 step are A columns 2t / 2t + 1
// (one 8-byte load) and B rows 2t / 2t + 1.
template <int MT, int NT, int WM, int WN, bool DUAL, int SK_, int STAGES_>
__global__ void __launch_bounds__(
    SplitShape<MT, NT, WM, WN, DUAL, SK_, STAGES_>::THREADS)
    split_gemm(const Gemm p, bool vec) {
  using S = SplitShape<MT, NT, WM, WN, DUAL, SK_, STAGES_>;
  constexpr int NB = S::NB, BM = S::BM, BN = S::BN, LDB = S::LDB;
  constexpr int SK = S::SK, S_STAGES = S::STAGES, SA_LD = S::LDA;
  extern __shared__ __align__(16) float ssm[];
  const float* a = static_cast<const float*>(p.a);
  const float* b[2] = {static_cast<const float*>(p.b0),
                       static_cast<const float*>(p.b1)};
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * p.k_split;
  const int k_end = min(p.k, k_begin + p.k_split);
  const int steps = (k_end - k_begin + SK - 1) / SK;

  // columns of A and rows of B past k_end are never reached: k_end is k
  // (zero fill past it) or a multiple of SK
  auto issue = [&](int s) {
    if (s < steps) {
      float* slot = ssm + (s % S_STAGES) * S::STAGE;
      const int k0 = k_begin + s * SK;
      load_tile<BM, SK, S::THREADS>(slot, SA_LD, a, p.m, p.k, m0, k0, vec);
#pragma unroll
      for (int o = 0; o < NB; ++o)
        load_tile<SK, BN, S::THREADS>(slot + BM * SA_LD + o * SK * LDB, LDB,
                                      b[o], p.k, p.n, k0, n0, vec);
    }
    // one group per stage, empty past the end, so the wait counts hold
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp % WM) * 16 * MT, wc = (warp / WM) * 8 * NT;
  float acc[NB][MT][NT][4];
#pragma unroll
  for (int o = 0; o < NB; ++o)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][i][j][e] = 0.0f;

  for (int s = 0; s < S_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S_STAGES - 2>();
    // stage s is visible to every warp, and every warp is done with stage
    // s - 1, whose slot the issue below refills
    __syncthreads();
    issue(s + S_STAGES - 1);
    const float* as = ssm + (s % S_STAGES) * S::STAGE + (wr + g) * SA_LD +
                      2 * t;
    const float* bs = ssm + (s % S_STAGES) * S::STAGE + BM * SA_LD +
                      2 * t * LDB + wc + g;
    // this stage's products sum into fresh accumulators, added into acc
    // once a stage (see the header: the tensor cores round toward zero)
    float part[NB][MT][NT][4];
#pragma unroll
    for (int o = 0; o < NB; ++o)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[o][i][j][e] = 0.0f;
#pragma unroll
    for (int k8 = 0; k8 < SK / 8; ++k8) {
      // A fragments (rows g, g + 8 of each m tile), split once a warp
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float2 top = *reinterpret_cast<const float2*>(
            as + 16 * i * SA_LD + k8 * 8);
        const float2 bot = *reinterpret_cast<const float2*>(
            as + (16 * i + 8) * SA_LD + k8 * 8);
        const float xa[4] = {top.x, bot.x, top.y, bot.y};
        split_frag(xa, ah[i], al[i]);
      }
#pragma unroll
      for (int o = 0; o < NB; ++o) {
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            split_tf32(bs[o * SK * LDB + (k8 * 8 + e) * LDB + j * 8],
                       bh[j][e], bl[j][e]);
        // a_lo b_hi, a_hi b_lo, a_hi b_hi, each pass over all MT x NT
        // accumulators of this operand before the next
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma_tf32(part[o][i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma_tf32(part[o][i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma_tf32(part[o][i][j], ah[i], bh[j][0], bh[j][1]);
      }
    }
#pragma unroll
    for (int o = 0; o < NB; ++o)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[o][i][j][e] += part[o][i][j][e];
  }
  cp_async_wait<0>();

  // epilogue on the accumulators: this thread holds columns 2t, 2t + 1 of
  // rows g (e = 0, 1) and g + 8 (e = 2, 3) of each (m tile, n tile); g and
  // u share the layout, so h = act(g) u needs no shared memory
  float* out = static_cast<float*>(p.out) +
               (p.partial ? (size_t)blockIdx.z * p.m * p.n : 0);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float v0 = acc[0][i][j][2 * h2], v1 = acc[0][i][j][2 * h2 + 1];
        if constexpr (DUAL) {
          v0 = activate(v0, p.act) * acc[NB - 1][i][j][2 * h2];
          v1 = activate(v1, p.act) * acc[NB - 1][i][j][2 * h2 + 1];
        }
        store2(out, p.m, p.n, m0 + wr + 16 * i + g + 8 * h2,
               n0 + wc + 8 * j + 2 * t, v0, v1);
      }
}

// out[i] = sum of partial[s][i] over the splits, in split order
template <typename T>
__global__ void swiglu_split_sum(const float* __restrict__ partial,
                                 T* __restrict__ out, size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + i];
    if constexpr (std::is_same<T, bf16>::value)
      out[i] = __float2bfloat16(s);
    else
      out[i] = s;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (no link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// 2-D bf16 tensor map of a row-major (rows, cols) matrix, boxes of (64
// columns, box_rows rows), 128-byte swizzle, out-of-bounds zero fill
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WG, int BN, bool DUAL, bool TMA>
int launch_wgmma(const Gemm& p, int splits, cudaStream_t stream) {
  constexpr int BM = 64 * WG;
  constexpr int STAGE = BM * 128 + (DUAL ? 2 : 1) * BN * 128;
  constexpr size_t smem = (size_t)STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(smem <= (size_t)SMEM_LIMIT, "ring exceeds shared memory");
  CUtensorMap ta = {}, tb0 = {}, tb1 = {};
  if (TMA) {
    if (!tensor_map(&ta, p.a, p.m, p.k, BM) ||
        !tensor_map(&tb0, p.b0, p.k, p.n, 64) ||
        (DUAL && !tensor_map(&tb1, p.b1, p.k, p.n, 64)))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = wgmma_gemm<WG, BN, DUAL, TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.m + BM - 1) / BM, (p.n + BN - 1) / BN, splits);
  kernel<<<grid, 128 * (WG + 1), smem, stream>>>(ta, tb0, tb1, p);
  return (int)cudaGetLastError();
}

template <int MT, int NT, int WM, int WN, bool DUAL, int SK, int STAGES>
int launch_split(const Gemm& p, int splits, bool vec, cudaStream_t stream) {
  using S = SplitShape<MT, NT, WM, WN, DUAL, SK, STAGES>;
  static_assert(S::SMEM <= (size_t)SMEM_LIMIT, "ring exceeds shared memory");
  auto kernel = split_gemm<MT, NT, WM, WN, DUAL, SK, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.m + S::BM - 1) / S::BM, (p.n + S::BN - 1) / S::BN,
                  splits);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(p, vec);
  return (int)cudaGetLastError();
}

// f32 schedules (kernels/ops.py swiglu_plan): wide, 8 warps as 4 x 2 on
// 128-row tiles, gate/up 64 columns of each weight (2 x 4 n8 tiles a
// warp), down 128 columns (8 n8 tiles a warp), a ring of 3 stages of K 64
// (210 KB: one block an SM); narrow (M <= 16, decode), 4 warps side by
// side on 16-row tiles, 64 columns in both products, 4 stages of K 32 (78
// KB: two blocks an SM keep more weight bytes in flight)
int launch_f32(const Gemm& gate, const Gemm& down, int wide, int splits,
               bool vec, cudaStream_t stream) {
  int err = wide ? launch_split<2, 4, 4, 2, true, 64, 3>(gate, 1, vec, stream)
                 : launch_split<1, 2, 1, 4, true, 32, 4>(gate, 1, vec, stream);
  if (err != 0) return err;
  return wide
             ? launch_split<2, 8, 4, 2, false, 64, 3>(down, splits, vec, stream)
             : launch_split<1, 2, 1, 4, false, 32, 4>(down, splits, vec,
                                                      stream);
}

template <bool TMA>
int launch_bf16(const Gemm& gate, const Gemm& down, int wide, int splits,
                cudaStream_t stream) {
  int err = wide ? launch_wgmma<2, 128, true, TMA>(gate, 1, stream)
                 : launch_wgmma<1, 64, true, TMA>(gate, 1, stream);
  if (err != 0) return err;
  return wide ? launch_wgmma<2, 256, false, TMA>(down, splits, stream)
              : launch_wgmma<1, 64, false, TMA>(down, splits, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).  dtype 0 =
// f32, 1 = bf16 (x, the weights, h and out alike); activation 0 = silu,
// 1 = gelu.  h is (m, f) scratch in the operand type; with splits > 1,
// `partial` is f32 scratch of splits * m * d elements, else unused.  The
// plan (kernels/ops.py swiglu_plan): wide = 1 for the 128-row schedule,
// 0 for the 64-row bf16 / 16-row f32 one; the down product's K =
// f runs in `splits` slices of k_split (a multiple of 64) rows; tma = 1
// loads the bf16 tiles with TMA (d, f multiples of 8, 16-byte aligned
// bases), 0 element by element.  The caller checks shapes (x (m, d),
// w_gate / w_up (d, f), w_down (f, d)), dtypes and contiguity.
int swiglu_fwd(const void* x, const void* w_gate, const void* w_up,
               const void* w_down, void* out, void* h, float* partial, int m,
               int d, int f, int wide, int splits, int k_split, int dtype,
               int activation, int tma, void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || dtype < 0 || dtype > 1 ||
      activation < 0 || activation > 1 || splits < 1 || k_split < 1 ||
      k_split % 64 || (long long)splits * k_split < f ||
      (long long)(splits - 1) * k_split >= f || (splits > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  void* down_out = splits > 1 ? static_cast<void*>(partial) : out;
  const Gemm gate = {x, w_gate, w_up, h, m, f, d, d, activation, 0};
  const Gemm down = {h,     w_down, nullptr, down_out, m,
                     d,     f,      k_split, 0,        splits > 1};
  int err;
  if (dtype == 1) {
    if (tma && !(d % 8 == 0 && f % 8 == 0 && aligned16(x) &&
                 aligned16(w_gate) && aligned16(w_up) && aligned16(w_down) &&
                 aligned16(h)))
      return (int)cudaErrorInvalidValue;
    err = tma ? launch_bf16<true>(gate, down, wide, splits, st)
              : launch_bf16<false>(gate, down, wide, splits, st);
  } else {
    const bool vec = d % 4 == 0 && f % 4 == 0 && aligned16(x) &&
                     aligned16(w_gate) && aligned16(w_up) &&
                     aligned16(w_down) && aligned16(h);
    err = launch_f32(gate, down, wide, splits, vec, st);
  }
  if (err != 0 || splits == 1) return err;
  const size_t n = (size_t)m * d;
  const size_t blocks = (n + 255) / 256;
  const int grid = (int)(blocks < 1024 ? blocks : 1024);
  if (dtype == 1)
    swiglu_split_sum<bf16>
        <<<grid, 256, 0, st>>>(partial, static_cast<bf16*>(out), n, splits);
  else
    swiglu_split_sum<float>
        <<<grid, 256, 0, st>>>(partial, static_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
