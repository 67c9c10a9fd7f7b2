// Fused GatedMLP for Hopper (sm_90a): the MLP of the unfused message path
// and of the angle update at mlp_impl="pallas".
//
//   gated_mlp_fwd  replaces fused_gated_mlp_pallas
//                  (src/repro/kernels/fused_gated_mlp.py:52; kernel body
//                  _kernel :33)
//
// out = silu(LN(y_c)) * sigmoid(LN(y_g)),  y = x @ W + b = [y_c | y_g],
// with W = [Wc | Wg] packed (d_in, 2D) and the LayerNorm parameters packed
// [core | gate] (2D,).  Every row of x is computed, the padded ones too, as
// the TPU kernel does.  LayerNorm: f32, two passes (mean, then the mean of
// squared deviations), rsqrt(var + 1e-5), over the D columns of each half.
//
// Bound on this card: at FAST_PALLAS (D = 64, d_in = 192 or 256, 381k-394k
// rows at batch 128) a call does 2 * M * d_in * 2D flops, 19-25 GFLOP, on
// M * (d_in + D) * 4 bytes, about 50 flops per byte: f32 without tensor
// cores (no TF32, to stay within the 1e-4 of the plain version), it is
// bound by operations at 67 TFLOP/s.  The design keeps the inner loop on
// FMAs: a block takes a tile of TM rows, stages the x tile in shared
// memory once, and each of its 2D threads owns one GEMM output column and
// keeps TM accumulators in registers, reading x as float4 broadcasts from
// shared memory and each weight once per tile through the read-only cache
// (W is at most 128 KB and shared by every block, so it stays in L2).  The
// LayerNorms run one warp per (row, half) with warp shuffles over the
// tile's y in shared memory, then the gate is applied and the D output
// columns are written coalesced.  Making it fast (wgmma on split f32,
// TMA, a W tile held in shared memory) is later work; this is the simple,
// right version.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;  // rows per block
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Threads: 2D rounded up to a warp.  Shared memory: the x tile (TM, kp)
// with its row stride kp = d_in rounded up to 4 (zeros beyond d_in), then
// y (TM, 2D).
__global__ void gated_mlp_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ lns,
                                 const float* __restrict__ lnb,
                                 float* __restrict__ out, int m, int d_in,
                                 int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kp = (d_in + 3) & ~3;
  const int n2 = 2 * D;
  float* xs = smem;            // (TM, kp)
  float* ys = smem + TM * kp;  // (TM, 2D)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int r0 = blockIdx.x * TM;
  const int n_r = min(TM, m - r0);

  // 1. stage the x tile; rows past m and columns past d_in are zeros
  for (int idx = tid; idx < TM * kp; idx += blockDim.x) {
    const int t = idx / kp;
    const int k = idx - t * kp;
    xs[idx] = (t < n_r && k < d_in) ? x[(size_t)(r0 + t) * d_in + k] : 0.0f;
  }
  __syncthreads();

  // 2. y = x @ W + b; thread c owns output column c, TM rows in registers
  const int c = tid;
  if (c < n2) {
    float yc[TM];
#pragma unroll
    for (int t = 0; t < TM; ++t) yc[t] = 0.0f;
    for (int k = 0; k < kp; k += 4) {
      float wk[4];  // rows k..k+3 of W; zeros past d_in, as in the x tile
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wk[j] = k + j < d_in ? __ldg(w + (size_t)(k + j) * n2 + c) : 0.0f;
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        const float4 x4 = *reinterpret_cast<const float4*>(xs + t * kp + k);
        yc[t] = fmaf(x4.x, wk[0], yc[t]);
        yc[t] = fmaf(x4.y, wk[1], yc[t]);
        yc[t] = fmaf(x4.z, wk[2], yc[t]);
        yc[t] = fmaf(x4.w, wk[3], yc[t]);
      }
    }
    const float bc = bias[c];
#pragma unroll
    for (int t = 0; t < TM; ++t) ys[t * n2 + c] = yc[t] + bc;
  }
  __syncthreads();

  // 3. LayerNorm of each (row, half), one warp per pair, two passes
  for (int p = warp; p < 2 * n_r; p += nwarps) {
    const int t = p >> 1, h = p & 1;
    float* yrow = ys + t * n2 + h * D;
    float s = 0.0f;
    for (int j = lane; j < D; j += 32) s += yrow[j];
    const float mu = warp_sum(s) / (float)D;
    float q = 0.0f;
    for (int j = lane; j < D; j += 32) {
      const float dlt = yrow[j] - mu;
      q += dlt * dlt;
    }
    const float rstd = rsqrtf(warp_sum(q) / (float)D + LN_EPS);
    for (int j = lane; j < D; j += 32)
      yrow[j] = (yrow[j] - mu) * rstd * lns[h * D + j] + lnb[h * D + j];
  }
  __syncthreads();

  // 4. gate and write: silu(core) * sigmoid(gate), silu(z) = z * sigmoid(z)
  for (int idx = tid; idx < n_r * D; idx += blockDim.x) {
    const int t = idx / D;
    const int j = idx - t * D;
    const float core = ys[t * n2 + j];
    const float gate = ys[t * n2 + D + j];
    out[(size_t)(r0 + t) * D + j] = (core * sigmoid_f(core)) * sigmoid_f(gate);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).  The caller
// checks shapes (x (m, d_in), w (d_in, 2D), b / ln_scale / ln_bias (2D,),
// 2D <= 1024), f32 dtypes, contiguity, and that the shared-memory tile,
// 4 * TM * (round_up(d_in, 4) + 2D) bytes, fits a block's 227 KB.
int gated_mlp_fwd(const float* x, const float* w, const float* b,
                  const float* ln_scale, const float* ln_bias, float* out,
                  int m, int d_in, int dim, void* stream) {
  if (m == 0) return 0;
  const int kp = (d_in + 3) & ~3;
  const size_t smem = sizeof(float) * TM * (kp + 2 * dim);
  cudaError_t err = cudaFuncSetAttribute(
      gated_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((2 * dim + 31) / 32) * 32;
  const int grid = (m + TM - 1) / TM;
  gated_mlp_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, w, b, ln_scale, ln_bias, out, m, d_in, dim);
  return (int)cudaGetLastError();
}

}  // extern "C"
