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
// where the TPU kernel rounds it; the down product accumulates in f32.
//
// The TPU kernel walks its grid (M/128, F/256) in order and carries the
// down product in its output block across the F steps.  Blocks on this
// card run in no order, so the carried sum becomes two passes: each block
// owns an (m-tile of 64 rows, group of F chunks of 128) pair, computes g
// and u for each chunk, keeps h for the whole group in shared memory (h
// never goes to device memory, as on the TPU), multiplies it by the
// group's rows of Wd and writes an f32 partial (groups, M, D); a second
// small kernel sums the partials in group order and stores in the operand
// type.  Deterministic, no atomics.  Accumulation differs from the TPU
// kernel on purpose: its bf16 output block sums the F/256 block partials
// in bf16 (56 roundings at F = 14336); here they stay f32 and round once,
// so in bf16 the two agree to bf16 rounding (the 3e-2 bound of DESIGN.md
// §4), not to 1e-5.  In f32 they agree to f32 rounding.
//
// Bound on this card: llama3-8b prefill (M = 2048, D = 4096, F = 14336,
// bf16) does 6 M D F = 721 GFLOP, 0.73 ms at 989 TFLOP/s: operations.  A
// decode step (M = 4) reads 3 D F bf16 weights, 352 MB, 0.105 ms at
// 3.35 TB/s: bytes.  The design serves both with one tiling: bf16 products
// on the tensor cores through nvcuda::wmma (16x16x16, f32 accumulators),
// f32 products as FMAs on the CUDA cores (no TF32: the f32 tier is held to
// 1e-4 of its plain version); tiles staged through a 3-stage cp.async ring
// so several loads are in flight per block; the wrapper picks the group
// size so that about two blocks per SM run (at M = 4, one chunk per group:
// 112 blocks stream the weights side by side).  wgmma, TMA and a persistent
// schedule are later work.
//
// Any M >= 1 and any D, F >= 1: rows, columns and chunks past the edge are
// zero-filled on load and masked on store.  16-byte copies need D and F to
// be multiples of 8 bf16 (4 f32) and 16-byte aligned bases; otherwise the
// tiles are staged element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;        // rows of x per block
constexpr int BF = 128;       // F columns per chunk (= down-product K tile)
constexpr int BN = 128;       // output columns per down-product tile
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;
constexpr int SMEM_LIMIT = 232448;  // a block's dynamic shared memory

template <typename T>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int BK = 64 / sizeof(T);   // K step: 32 bf16, 16 f32
  static constexpr int PAD = VEC;             // 16 bytes of row padding
  static constexpr int XS_LD = BK + PAD;      // x tile (BM, BK)
  static constexpr int WS_LD = BF + PAD;      // weight tile (BK, BF or BN)
  static constexpr int XS = BM * XS_LD;
  static constexpr int WS = BK * WS_LD;
  static constexpr int STAGE = XS + 2 * WS;   // elements of one ring slot
};

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same<T, bf16>::value) {
    return __float2bfloat16(v);
  } else {
    return v;
  }
}

template <int ACT>
__device__ __forceinline__ float activate(float g) {
  if (ACT == 0) return g * (1.0f / (1.0f + expf(-g)));  // silu
  // gelu, tanh form (jax.nn.gelu(approximate=True))
  const float inner = 0.7978845608028654f * (g + 0.044715f * (g * g * g));
  return g * (0.5f * (1.0f + tanhf(inner)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the (ROWS, COLS) tile at (r0, c0) of a row-major (nrows, ncols)
// matrix into shared memory with row stride ld; zeros outside the matrix.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int nrows, int ncols, int r0,
                                          int c0, bool vec) {
  constexpr int VEC = Tile<T>::VEC;
  if (vec) {  // ncols % VEC == 0: a vector is wholly inside or outside
    constexpr int VPR = COLS / VEC;
    for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
      const int r = i / VPR, c = (i - r * VPR) * VEC;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < nrows && gc < ncols;
      cp_async16(dst + r * ld + c,
                 in ? src + (size_t)gr * ncols + gc : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i - r * COLS;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * ld + c] = (gr < nrows && gc < ncols)
                            ? src[(size_t)gr * ncols + gc]
                            : from_float<T>(0.0f);
    }
  }
}

// Grid (ceil(M / BM), groups); block y owns F chunks [y * cpg, y * cpg +
// nc).  Shared memory: the cp.async ring (STAGES slots), then h (BM,
// hs_ld) in T, then (bf16 only) a 16x16 f32 scratch tile per warp.
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
    swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                  const T* __restrict__ wu, const T* __restrict__ wd,
                  float* __restrict__ partial, int M, int D, int F, int cpg,
                  int hs_ld, bool vec) {
  using TL = Tile<T>;
  constexpr bool kWmma = std::is_same<T, bf16>::value;
  constexpr int BK = TL::BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* hs = ring + STAGES * TL::STAGE;
  float* scratch = reinterpret_cast<float*>(hs + BM * hs_ld);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int n_chunks = (F + BF - 1) / BF;
  const int c0 = blockIdx.y * cpg;
  const int nc = min(cpg, n_chunks - c0);
  const int f_base = c0 * BF;

  // wmma: warp w owns rows [16 (w / 2), +16) and columns [64 (w % 2), +64)
  // of each 64x128 output tile, four 16x16 fragments; a row strip with no
  // real row skips its products.  FMA: thread (ty = warp, tx = lane) owns
  // rows [8 ty, +8) and columns [4 tx, +4).
  const int wr = warp >> 1, wc = warp & 1;
  const bool strip_live = m0 + wr * 16 < M;

  // ---- phase 1: h = act(x Wg) * (x Wu), chunk by chunk, into hs --------
  const int nk1 = (D + BK - 1) / BK;
  const int steps1 = nc * nk1;
  auto issue1 = [&](int s) {
    if (s < steps1) {
      const int c = s / nk1, kt = s - c * nk1;
      T* slot = ring + (s % STAGES) * TL::STAGE;
      const int f0 = f_base + c * BF;
      load_tile<T, BM, BK>(slot, TL::XS_LD, x, M, D, m0, kt * BK, vec);
      load_tile<T, BK, BF>(slot + TL::XS, TL::WS_LD, wg, D, F, kt * BK, f0,
                           vec);
      load_tile<T, BK, BF>(slot + TL::XS + TL::WS, TL::WS_LD, wu, D, F,
                           kt * BK, f0, vec);
    }
    cp_async_commit();
  };

  using namespace nvcuda;
  using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               wmma::row_major>;

  if constexpr (kWmma) {
    FragAcc acc_g[4], acc_u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fill_fragment(acc_g[j], 0.0f);
      wmma::fill_fragment(acc_u[j], 0.0f);
    }
    for (int s = 0; s < STAGES - 1; ++s) issue1(s);
    for (int s = 0; s < steps1; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      issue1(s + STAGES - 1);
      const T* slot = ring + (s % STAGES) * TL::STAGE;
      if (strip_live) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          FragA a;
          wmma::load_matrix_sync(a, slot + wr * 16 * TL::XS_LD + kk,
                                 TL::XS_LD);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragB b;
            const int col = wc * 64 + j * 16;
            wmma::load_matrix_sync(b, slot + TL::XS + kk * TL::WS_LD + col,
                                   TL::WS_LD);
            wmma::mma_sync(acc_g[j], a, b, acc_g[j]);
            wmma::load_matrix_sync(
                b, slot + TL::XS + TL::WS + kk * TL::WS_LD + col, TL::WS_LD);
            wmma::mma_sync(acc_u[j], a, b, acc_u[j]);
          }
        }
      }
      const int c = s / nk1;
      if (s - c * nk1 == nk1 - 1) {  // chunk done: h into hs, rounded to T
        float* scr = scratch + warp * 256;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < acc_g[j].num_elements; ++i)
            acc_g[j].x[i] = activate<ACT>(acc_g[j].x[i]) * acc_u[j].x[i];
          wmma::store_matrix_sync(scr, acc_g[j], 16, wmma::mem_row_major);
          __syncwarp();
          T* hrow = hs + (wr * 16) * hs_ld + c * BF + wc * 64 + j * 16;
          for (int e = lane; e < 256; e += 32)
            hrow[(e >> 4) * hs_ld + (e & 15)] = from_float<T>(scr[e]);
          __syncwarp();
          wmma::fill_fragment(acc_g[j], 0.0f);
          wmma::fill_fragment(acc_u[j], 0.0f);
        }
      }
    }
  } else {
    const int ty = warp, tx = lane;
    float g[8][4], u[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = u[i][j] = 0.0f;
    for (int s = 0; s < STAGES - 1; ++s) issue1(s);
    for (int s = 0; s < steps1; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      issue1(s + STAGES - 1);
      const float* slot =
          reinterpret_cast<const float*>(ring + (s % STAGES) * TL::STAGE);
      const float* xs = slot;
      const float* gs = slot + TL::XS;
      const float* us = slot + TL::XS + TL::WS;
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = xs[(ty * 8 + i) * TL::XS_LD + k];
        const float4 bg =
            *reinterpret_cast<const float4*>(gs + k * TL::WS_LD + tx * 4);
        const float4 bu =
            *reinterpret_cast<const float4*>(us + k * TL::WS_LD + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          g[i][0] = fmaf(a[i], bg.x, g[i][0]);
          g[i][1] = fmaf(a[i], bg.y, g[i][1]);
          g[i][2] = fmaf(a[i], bg.z, g[i][2]);
          g[i][3] = fmaf(a[i], bg.w, g[i][3]);
          u[i][0] = fmaf(a[i], bu.x, u[i][0]);
          u[i][1] = fmaf(a[i], bu.y, u[i][1]);
          u[i][2] = fmaf(a[i], bu.z, u[i][2]);
          u[i][3] = fmaf(a[i], bu.w, u[i][3]);
        }
      }
      const int c = s / nk1;
      if (s - c * nk1 == nk1 - 1) {
        float* hrow = reinterpret_cast<float*>(hs) + (ty * 8) * hs_ld +
                      c * BF + tx * 4;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hrow[i * hs_ld + j] = activate<ACT>(g[i][j]) * u[i][j];
            g[i][j] = u[i][j] = 0.0f;
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // hs complete; the ring is free

  // ---- phase 3: partial[group] = h @ Wd[group rows], tile by tile ------
  const int nk3 = nc * (BF / BK);
  const int ndt = (D + BN - 1) / BN;
  const int steps3 = ndt * nk3;
  auto issue3 = [&](int s) {
    if (s < steps3) {
      const int dt = s / nk3, kt = s - dt * nk3;
      load_tile<T, BK, BN>(ring + (s % STAGES) * TL::STAGE, TL::WS_LD, wd, F,
                           D, f_base + kt * BK, dt * BN, vec);
    }
    cp_async_commit();
  };
  float* out_g = partial + (size_t)blockIdx.y * M * D;

  if constexpr (kWmma) {
    FragAcc acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int s = 0; s < STAGES - 1; ++s) issue3(s);
    for (int s = 0; s < steps3; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      issue3(s + STAGES - 1);
      const T* slot = ring + (s % STAGES) * TL::STAGE;
      const int dt = s / nk3, kt = s - dt * nk3;
      if (strip_live) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          FragA a;
          wmma::load_matrix_sync(a, hs + wr * 16 * hs_ld + kt * BK + kk,
                                 hs_ld);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragB b;
            wmma::load_matrix_sync(b, slot + kk * TL::WS_LD + wc * 64 + j * 16,
                                   TL::WS_LD);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
        if (kt == nk3 - 1) {  // tile done: masked store of the partial
          float* scr = scratch + warp * 256;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
            __syncwarp();
            const int col0 = dt * BN + wc * 64 + j * 16;
            for (int e = lane; e < 256; e += 32) {
              const int r = m0 + wr * 16 + (e >> 4), col = col0 + (e & 15);
              if (r < M && col < D) out_g[(size_t)r * D + col] = scr[e];
            }
            __syncwarp();
            wmma::fill_fragment(acc[j], 0.0f);
          }
        }
      }
    }
  } else {
    const int ty = warp, tx = lane;
    const float* hsf = reinterpret_cast<const float*>(hs);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < STAGES - 1; ++s) issue3(s);
    for (int s = 0; s < steps3; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      issue3(s + STAGES - 1);
      const float* ws =
          reinterpret_cast<const float*>(ring + (s % STAGES) * TL::STAGE);
      const int dt = s / nk3, kt = s - dt * nk3;
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        const int kh = kt * BK + k;
        const float4 b =
            *reinterpret_cast<const float4*>(ws + k * TL::WS_LD + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = hsf[(ty * 8 + i) * hs_ld + kh];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
      if (kt == nk3 - 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = m0 + ty * 8 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = dt * BN + tx * 4 + j;
            if (r < M && col < D) out_g[(size_t)r * D + col] = acc[i][j];
            acc[i][j] = 0.0f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// out[i] = sum of partial[g][i] over the groups, in group order.
template <typename T>
__global__ void swiglu_reduce_kernel(const float* __restrict__ partial,
                                     T* __restrict__ out, size_t n,
                                     int groups) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += partial[(size_t)g * n + i];
    out[i] = from_float<T>(s);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename T, int ACT>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* out, float* partial, int m, int d, int f, int cpg,
           cudaStream_t stream) {
  using TL = Tile<T>;
  constexpr bool kWmma = std::is_same<T, bf16>::value;
  const int n_chunks = (f + BF - 1) / BF;
  const int groups = (n_chunks + cpg - 1) / cpg;
  const int hs_ld = cpg * BF + TL::PAD;
  const size_t smem = sizeof(T) * ((size_t)STAGES * TL::STAGE +
                                   (size_t)BM * hs_ld) +
                      (kWmma ? sizeof(float) * WARPS * 256 : 0);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_kernel<T, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = d % TL::VEC == 0 && f % TL::VEC == 0 && aligned16(x) &&
                   aligned16(wg) && aligned16(wu) && aligned16(wd);
  const dim3 grid((m + BM - 1) / BM, groups);
  swiglu_kernel<T, ACT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd), partial, m, d, f,
      cpg, hs_ld, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)m * d;
  const size_t blocks = (n + 255) / 256;
  swiglu_reduce_kernel<T><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                            stream>>>(partial, static_cast<T*>(out), n,
                                      groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).  dtype 0 =
// f32, 1 = bf16 (x, the weights and out alike); activation 0 = silu, 1 =
// gelu.  `partial` is f32 scratch of ceil(ceil(f / 128) / cpg) * m * d
// elements.  The caller checks shapes (x (m, d), w_gate / w_up (d, f),
// w_down (f, d)), dtypes, contiguity, m, d, f >= 1 and cpg >= 1; an h tile
// that does not fit a block's shared memory returns cudaErrorInvalidValue.
int swiglu_fwd(const void* x, const void* w_gate, const void* w_up,
               const void* w_down, void* out, float* partial, int m, int d,
               int f, int cpg, int dtype, int activation, void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || cpg <= 0 || dtype < 0 || dtype > 1 ||
      activation < 0 || activation > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return activation == 0
               ? launch<bf16, 0>(x, w_gate, w_up, w_down, out, partial, m, d,
                                 f, cpg, st)
               : launch<bf16, 1>(x, w_gate, w_up, w_down, out, partial, m, d,
                                 f, cpg, st);
  return activation == 0
             ? launch<float, 0>(x, w_gate, w_up, w_down, out, partial, m, d,
                                f, cpg, st)
             : launch<float, 1>(x, w_gate, w_up, w_down, out, partial, m, d,
                                f, cpg, st);
}

}  // extern "C"
