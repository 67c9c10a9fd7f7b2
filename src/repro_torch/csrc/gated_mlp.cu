// Fused GatedMLP for Hopper (sm_90a): the MLP of the unfused message path
// and of the angle update at mlp_impl="pallas".
//
//   gated_mlp_fwd       replaces fused_gated_mlp_pallas
//   gated_mlp_bf16_fwd  (src/repro/kernels/fused_gated_mlp.py:52; kernel
//                       body _kernel :33), in f32 and in bf16
//
// out = silu(LN(y_c)) * sigmoid(LN(y_g)),  y = x @ W + b = [y_c | y_g],
// with W = [Wc | Wg] packed (d_in, 2D) and the LayerNorm parameters packed
// [core | gate] (2D,).  Every row of x is computed, the padded ones too, as
// the TPU kernel does.  LayerNorm: f32, two passes (mean, then the mean of
// squared deviations), rsqrt(var + 1e-5), over the D columns of each half.
//
// Bound on this card: at FAST_PALLAS (D = 64, d_in = 192 or 256, 381k-394k
// rows at batch 128) a call does 2 M d_in 2D flops, 19-25 GFLOP, on M
// (d_in + D) 4 bytes, ~50 flops per byte.  As f32 FMAs that is 0.37 ms at
// 67 TFLOP/s; here the GEMM runs on the tensor cores in split f32 (3xTF32,
// hopper.cuh), 3 x 25 GFLOP at 495 TFLOP/s = 0.15 ms, the same as the
// 0.145 ms the bytes take at 3.35 TB/s.  The design:
//  - a persistent grid (one block of 8 warps per SM, kernels/ops.py
//    gated_mlp_plan, which the launch checks) walks row tiles of
//    TM = 256 rows (128 for D = 128) and, inside each, K chunks of 64
//    columns; each (tile, chunk) stage brings the x chunk (TM, 64) and the
//    W chunk (64, 2D) into shared memory with cp.async, double-buffered,
//    so the next stage loads while this one computes (W, 128 KB at the
//    path shapes, is read again from L2 for every tile, so any d_in fits);
//  - a warp owns 32 rows (two m16 tiles; 16 for D = 128) by all 2D
//    columns: 2D / 8 n8 tiles, 4 accumulators each per m tile, in
//    registers from the first chunk to the epilogue.  Each B fragment of W
//    is split once in registers and feeds both m tiles; the three products
//    of the split run as passes over 8 n tiles (hopper.cuh);
//  - the epilogue runs on the accumulators: a row's 2D columns lie in the
//    4 threads of its quad, so the bias, both LayerNorms (quad shuffles)
//    and the gate (core column c and gate column D + c are in the same
//    thread; one fast reciprocal for both sigmoids) need no shared memory
//    beyond the parameters, and y never leaves registers.
// Fragment order: k = t / t + 4 of each 8-wide step are x columns 2t / 2t
// + 1 (one 8-byte load) and W rows 2t / 2t + 1; row strides 72 floats (x)
// and 2D + 4 (W) keep the loads free of bank conflicts.  Each output is
// summed in a fixed order, with no atomics.
//
// bf16 (gated_mlp_bf16_fwd, DESIGN.md §4, the mixed tiers): x, W, the bias
// and out are bf16, the LayerNorm parameters f32 (the wrapper widens bf16
// ones), as the JAX kernel reads them: the product accumulates in f32,
// the bias, LayerNorms and gate are f32, and each output is rounded to
// bf16 once, as it is stored.  The same tiles, stages, warp layout and
// epilogue; a stage's x chunk is 64 bf16 columns (128 bytes a row) at a
// row stride of 72 (144 bytes, 16 mod 128: ldmatrix's eight row reads of
// 16 bytes fall in distinct banks) and W's rows 2D + 8 (16 mod 128 bytes
// too); each 16 columns of K are one mma.sync m16n8k16 bf16 product per
// n8 tile, A fragments by ldmatrix, B fragments by ldmatrix.trans from W's
// k-major rows.  Columns of x and rows of W past d_in are zeros, so any
// d_in works (16-byte copies where d_in % 8 == 0 and x is aligned, else
// plain 2-byte loads).  Bound at the path shapes: the bond convs' 380,928
// rows x (256 + 64) bf16 are 244 MB, 0.073 ms at 3.35 TB/s, above the
// 0.025 ms their 25 GFLOP take at 989 TFLOP/s: bound by bytes.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float LN_EPS = 1e-5f;
constexpr int KC = 64;  // d_in columns per stage
constexpr int STAGES = 2;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

template <int D, typename T = float>
struct MlpShape {
  static constexpr int NT = 2 * D / 8;          // n8 tiles of [core | gate]
  static constexpr int RW = D <= 64 ? 2 : 1;    // m16 tiles per warp
  static constexpr int TM = WARPS * 16 * RW;    // rows per tile
  // row strides in elements: x padded by 8, W by 16 bytes
  static constexpr int LDX = KC + 8, LDW = 2 * D + 16 / (int)sizeof(T);
  // a stage: the x chunk (TM, LDX), then the W chunk (KC, LDW)
  static constexpr int STAGE = TM * LDX + KC * LDW;  // elements
  // the stages, then bias, ln_scale and ln_bias (2D f32 each)
  static constexpr size_t SMEM =
      sizeof(T) * STAGES * STAGE + sizeof(float) * 6 * D;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// silu(c) sigmoid(g) = c / ((1 + e^-c) (1 + e^-g)): two fast
// exponentials and one fast reciprocal (a few ulp each, no division's slow
// path); a denominator that overflows gives 0, the limit
__device__ __forceinline__ float gated(float c, float g) {
  return __fdividef(c, (1.0f + __expf(-c)) * (1.0f + __expf(-g)));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// vec_x: d_in a multiple of a 16-byte copy's columns (4 f32, 8 bf16) and
// x 16-byte aligned (16-byte copies of x, else 4-byte copies in f32 and
// 2-byte loads in bf16); vec_w: w 16-byte aligned (2D a multiple of them
// always).  T = float: the split-f32 product; T = bf16: one bf16 product
// per 16 columns, the LayerNorm parameters f32.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    gated_mlp_split_kernel(const T* __restrict__ x,
                           const T* __restrict__ w,
                           const T* __restrict__ bias,
                           const float* __restrict__ lns,
                           const float* __restrict__ lnb,
                           T* __restrict__ out, int m, int d_in,
                           bool vec_x, bool vec_w) {
  using S = MlpShape<D, T>;
  constexpr bool BF = std::is_same<T, bf16>::value;
  constexpr int NT = S::NT, RW = S::RW, TM = S::TM;
  constexpr int LDX = S::LDX, LDW = S::LDW, N2 = 2 * D;
  constexpr int SEG = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(16) float smem[];
  T* const stages = reinterpret_cast<T*>(smem);

  const int nk = max(1, (d_in + KC - 1) / KC);
  const int n_tiles = (m + TM - 1) / TM;
  const int my_tiles = (int)blockIdx.x < n_tiles
                           ? (n_tiles - 1 - (int)blockIdx.x) / gridDim.x + 1
                           : 0;
  const int total = my_tiles * nk;

  // stage s of this block: chunk s % nk of its tile s / nk; columns past
  // d_in and rows past m are zeros (in x and in W, so no 0 x NaN)
  auto load_stage = [&](int s) {
    if (s < total) {
      const int r0 = (blockIdx.x + (s / nk) * gridDim.x) * TM;
      const int k0 = (s % nk) * KC;
      T* xs = stages + (s % STAGES) * S::STAGE;
      T* ws = xs + TM * LDX;
      // one element into shared memory: a 4-byte copy in f32; in bf16 a
      // plain load, visible to the other warps after the barrier that
      // precedes this stage's products
      auto copy1 = [&](T* dst, const T* src, bool in) {
        if constexpr (BF)
          *dst = in ? *src : __float2bfloat16_rn(0.0f);
        else
          cp_async4(dst, in ? src : x, in);
      };
      if (vec_x) {
        for (int i = threadIdx.x; i < TM * KC / SEG; i += THREADS) {
          const int r = i / (KC / SEG), c = (i % (KC / SEG)) * SEG;
          const bool in = r0 + r < m && k0 + c < d_in;
          cp_async16(xs + r * LDX + c,
                     in ? x + (size_t)(r0 + r) * d_in + k0 + c : x, in);
        }
      } else {
        for (int i = threadIdx.x; i < TM * KC; i += THREADS) {
          const int r = i / KC, c = i % KC;
          const bool in = r0 + r < m && k0 + c < d_in;
          copy1(xs + r * LDX + c, x + (size_t)(r0 + r) * d_in + k0 + c, in);
        }
      }
      if (vec_w) {
        for (int i = threadIdx.x; i < KC * N2 / SEG; i += THREADS) {
          const int r = i / (N2 / SEG), c = (i % (N2 / SEG)) * SEG;
          const bool in = k0 + r < d_in;
          cp_async16(ws + r * LDW + c, in ? w + (size_t)(k0 + r) * N2 + c : w,
                     in);
        }
      } else {
        for (int i = threadIdx.x; i < KC * N2; i += THREADS) {
          const int r = i / N2, c = i % N2;
          const bool in = k0 + r < d_in;
          copy1(ws + r * LDW + c, w + (size_t)(k0 + r) * N2 + c, in);
        }
      }
    }
    // one group per stage, empty past the end, so the wait counts hold
    cp_async_commit();
  };

  for (int s = 0; s < STAGES - 1; ++s) load_stage(s);
  // the epilogue's parameters (f32), visible after the first barrier below
  float* prm = reinterpret_cast<float*>(stages + STAGES * S::STAGE);
  for (int i = threadIdx.x; i < N2; i += THREADS) {
    prm[i] = to_f32(bias[i]);
    prm[N2 + i] = lns[i];
    prm[2 * N2 + i] = lnb[i];
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  float acc[RW][NT][4];

  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();
    // stage s is visible to every warp, and every warp is done with stage
    // s - 1, whose buffer the load below overwrites
    __syncthreads();
    load_stage(s + STAGES - 1);

    const int kc = s % nk;
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.0f;
    }
    const T* xs = stages + (s % STAGES) * S::STAGE;
    const int k_left = d_in - kc * KC;
    if constexpr (BF) {
      // one 16-wide step of K: the A fragments of the warp's m tiles
      // (ldmatrix), then the n tiles two at a time, their B fragments from
      // W's k-major rows (ldmatrix.trans), one bf16 product each
      const T* ws = xs + TM * LDX;
      auto k16_step = [&](int kk) {
        uint32_t af[RW][4];
#pragma unroll
        for (int r = 0; r < RW; ++r)
          ldmatrix_x4(af[r], xs + (warp * 16 * RW + 16 * r + (lane & 15)) *
                                      LDX + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(
              bfr, ws + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDW +
                       j2 * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            mma_bf16(acc[r][2 * j2], af[r], bfr[0], bfr[1]);
            mma_bf16(acc[r][2 * j2 + 1], af[r], bfr[2], bfr[3]);
          }
        }
      };
      if (k_left >= KC) {
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) k16_step(kk);
      } else {  // the last, partial chunk of d_in: past it are zeros
        for (int kk = 0; kk * 16 < k_left; ++kk) k16_step(kk);
      }
    } else {
      const float* xw = xs + (warp * 16 * RW + g) * LDX + 2 * tq;
      const float* ww = xs + TM * LDX + 2 * tq * LDW + g;
      // one 8-wide step of K: A fragments split, then the n tiles in groups
      // of up to 8: the group's B fragments split, then the three passes of
      // the split product over its 8 x RW accumulators
      auto k8_step = [&](int k8) {
        uint32_t ah[RW][4], al[RW][4];
  #pragma unroll
        for (int r = 0; r < RW; ++r) {
          // rows g and g + 8 of m tile r
          const float2 top =
              *reinterpret_cast<const float2*>(xw + 16 * r * LDX + k8 * 8);
          const float2 bot = *reinterpret_cast<const float2*>(
              xw + (16 * r + 8) * LDX + k8 * 8);
          const float xa[4] = {top.x, bot.x, top.y, bot.y};
          split_frag(xa, ah[r], al[r]);
        }
        constexpr int G = NT < 8 ? NT : 8;
  #pragma unroll
        for (int j0 = 0; j0 < NT; j0 += G) {
          uint32_t bh[G][2], bl[G][2];
  #pragma unroll
          for (int i = 0; i < G; ++i)
  #pragma unroll
            for (int e = 0; e < 2; ++e)
              split_tf32(ww[(k8 * 8 + e) * LDW + (j0 + i) * 8], bh[i][e],
                         bl[i][e]);
  #pragma unroll
          for (int i = 0; i < G; ++i)
  #pragma unroll
            for (int r = 0; r < RW; ++r)
              mma_tf32(acc[r][j0 + i], al[r], bh[i][0], bh[i][1]);
  #pragma unroll
          for (int i = 0; i < G; ++i)
  #pragma unroll
            for (int r = 0; r < RW; ++r)
              mma_tf32(acc[r][j0 + i], ah[r], bl[i][0], bl[i][1]);
  #pragma unroll
          for (int i = 0; i < G; ++i)
  #pragma unroll
            for (int r = 0; r < RW; ++r)
              mma_tf32(acc[r][j0 + i], ah[r], bh[i][0], bh[i][1]);
        }
      };
      if (k_left >= KC) {
  #pragma unroll
        for (int k8 = 0; k8 < KC / 8; ++k8) k8_step(k8);
      } else {  // the last, partial chunk of d_in: past it are zeros
        for (int k8 = 0; k8 * 8 < k_left; ++k8) k8_step(k8);
      }
    }
    if (kc != nk - 1) continue;

    // epilogue of the tile: bias, LayerNorm of each half, gate, store.
    // This thread holds columns 8 j + 2 tq + e of rows g (i = 0) and g + 8
    // (i = 1) of each m tile, in acc[r][j][2 i + e]; n tiles j < NT / 2
    // are the core half, the others the gate half.
    const int row0 = (blockIdx.x + (s / nk) * gridDim.x) * TM +
                     warp * 16 * RW + g;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            acc[r][j][2 * i + e] += prm[j * 8 + 2 * tq + e];
            sum[j / (NT / 2)] += acc[r][j][2 * i + e];
          }
        const float mu[2] = {quad_sum(sum[0]) / (float)D,
                             quad_sum(sum[1]) / (float)D};
        float sq[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dlt = acc[r][j][2 * i + e] - mu[j / (NT / 2)];
            sq[j / (NT / 2)] += dlt * dlt;
          }
        const float rstd[2] = {rsqrtf(quad_sum(sq[0]) / (float)D + LN_EPS),
                               rsqrtf(quad_sum(sq[1]) / (float)D + LN_EPS)};
        const int row = row0 + 16 * r + 8 * i;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          float res[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = j * 8 + 2 * tq + e;
            const float core =
                (acc[r][j][2 * i + e] - mu[0]) * rstd[0] * prm[N2 + c] +
                prm[2 * N2 + c];
            const float gate = (acc[r][j + NT / 2][2 * i + e] - mu[1]) *
                                   rstd[1] * prm[N2 + D + c] +
                               prm[2 * N2 + D + c];
            res[e] = gated(core, gate);
          }
          if (row < m) {
            T* o = out + (size_t)row * D + j * 8 + 2 * tq;
            if constexpr (BF)
              *reinterpret_cast<uint32_t*>(o) = pack_bf16(res[0], res[1]);
            else
              *reinterpret_cast<float2*>(o) = make_float2(res[0], res[1]);
          }
        }
      }
  }
  cp_async_wait<0>();
}

// one launch; the caller's plan (kernels/ops.py gated_mlp_plan: grid,
// tm, smem) must be this kernel's
template <int D, typename T>
int launch(const T* x, const T* w, const T* b, const float* ln_scale,
           const float* ln_bias, T* out, int m, int d_in, int grid, int tm,
           int smem, cudaStream_t stream) {
  using S = MlpShape<D, T>;
  if (tm != S::TM || smem != (int)S::SMEM || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gated_mlp_split_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return (int)err;
  constexpr int SEG = 16 / (int)sizeof(T);
  const bool vec_x =
      d_in % SEG == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  gated_mlp_split_kernel<D, T><<<grid, THREADS, S::SMEM, stream>>>(
      x, w, b, ln_scale, ln_bias, out, m, d_in, vec_x, vec_w);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const T* w, const T* b, const float* ln_scale,
             const float* ln_bias, T* out, int m, int d_in, int dim,
             int grid, int tm, int smem, void* stream) {
  if (m == 0) return 0;
  if (m < 0 || d_in < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define GATED_MLP_CASE(DIM)                                                \
  case DIM:                                                                \
    return launch<DIM>(x, w, b, ln_scale, ln_bias, out, m, d_in, grid, tm, \
                       smem, st);
  switch (dim) {
    GATED_MLP_CASE(8)
    GATED_MLP_CASE(16)
    GATED_MLP_CASE(32)
    GATED_MLP_CASE(64)
    GATED_MLP_CASE(128)
  }
#undef GATED_MLP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).  The caller
// checks shapes (x (m, d_in), w (d_in, 2D), b / ln_scale / ln_bias (2D,)),
// D in {8, 16, 32, 64, 128}, f32 dtypes, contiguity and an 8-byte aligned
// out, and gives the launch plan (grid, tm, smem) of kernels/ops.py
// gated_mlp_plan; any d_in >= 0.
int gated_mlp_fwd(const float* x, const float* w, const float* b,
                  const float* ln_scale, const float* ln_bias, float* out,
                  int m, int d_in, int dim, int grid, int tm, int smem,
                  void* stream) {
  return dispatch<float>(x, w, b, ln_scale, ln_bias, out, m, d_in, dim, grid,
                         tm, smem, stream);
}

// bf16 x, w, b and out; f32 ln_scale and ln_bias; a 4-byte aligned out;
// the plan of gated_mlp_plan at itemsize 2.
int gated_mlp_bf16_fwd(const bf16* x, const bf16* w, const bf16* b,
                       const float* ln_scale, const float* ln_bias, bf16* out,
                       int m, int d_in, int dim, int grid, int tm, int smem,
                       void* stream) {
  return dispatch<bf16>(x, w, b, ln_scale, ln_bias, out, m, d_in, dim, grid,
                        tm, smem, stream);
}

}  // extern "C"
