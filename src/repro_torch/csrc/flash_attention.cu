// Flash attention (online softmax) forward for Hopper (sm_90a):
//
//   flash_attention_fwd  replaces flash_attention_pallas
//                        (src/repro/kernels/flash_attention.py:74; kernel
//                        body _kernel :23, pallas_call :91)
//
// out[b] = softmax(q[b] k[b]^T * scale, masked) v[b] for each of the BH
// folded (batch, head) slices, q (BH, Sq, D), k / v (BH, Sk, D), f32 or
// bf16, D in {64, 128, 256}.  The (Sq, Sk) logits never reach device
// memory.  Semantics of the TPU kernel: scores s = (q . k) * scale in f32;
// the causal mask keeps rows >= cols counted from the top-left corner (the
// kernel's convention, not the bottom-right one of its jnp oracle; the two
// differ when Sq != Sk); a running max m and sum l in f32 per row; p =
// exp(s - m) enters l in f32 and is rounded to v's type before the p v
// product, which accumulates in f32; out = acc / max(l, 1e-30).  Masked
// scores contribute p = 0.
//
// The TPU kernel walks the KV blocks as its innermost grid axis and
// carries acc, m and l in scratch from one grid step to the next.  Here a
// block owns a (slice, q tile) pair and loops over the 64-row KV tiles
// itself, with acc, m and l in registers.  KV tiles wholly above the
// diagonal are skipped.  Any Sq, Sk >= 1: rows and columns past the edge
// load as zeros, are masked and are not stored.
//
// Bound on this card: at BH = 128, S = 512, D = 128 in bf16 the call moves
// 67 MB (q, k, v read once, out written once), 0.020 ms at 3.35 TB/s, and
// does 4 BH S^2 D = 17 GFLOP non-causal (half causal), 0.017 ms at 989
// TFLOP/s: bytes, barely.
//
// bf16 (flash_mma_kernel): both products on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, f32 accumulators).  A block owns 128 q rows:
// 4 warps of two 16-row tiles for D <= 128 (each K / V fragment feeds two
// products, halving the shared-memory reads per flop), 8 warps of one for
// D = 256.  q stays in shared memory; K and V tiles of 64
// rows are double-buffered with cp.async, so the next tile loads while
// this one computes.  s = q k^T takes its A fragments from q and its B
// fragments from K rows with ldmatrix; the online softmax runs on the
// accumulators in registers, each row reduced over the 4 threads of its
// quad with shuffles (ex2 of one FFMA, the scale folded into log2 e); p is
// rounded to bf16 in registers and is used directly as the A fragment of
// p v (the m16n8k16 accumulator layout is its A layout), with V's B
// fragments from ldmatrix.trans: p never goes through shared memory.
// Rows of 16 bytes of padding keep ldmatrix free of bank conflicts.  Only
// tiles on the diagonal or the ragged edge are masked; a warp skips the
// tiles above its own rows.  The sequences here are short (S 512), so
// mma.sync at two thirds of peak brings the operations to ~0.026 ms;
// wgmma is for longer sequences.
//
// f32 (flash_kernel): the products stay f32 FMAs on the CUDA cores (no
// TF32: the f32 tier is held to 1e-4): 256 threads, thread (ty = tid / 16,
// tx = tid % 16) owns rows ty + 16 i (i < 4), score columns tx + 16 j (j
// < 4) and output columns 64 jj + 4 tx + e; p goes through an f32 tile in
// shared memory.  17 GFLOP at 67 TFLOP/s is 0.26 ms.  It is on no model
// path (the JAX package's prefill runs jnp attention).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr float NEG = -1e30f;
constexpr int SMEM_LIMIT = 232448;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MQ = 128;  // q rows per block
constexpr int MKV = 64;  // kv rows per tile

// RW m16 row tiles per warp: 2 (4 warps of 32 rows) for D <= 128, so each
// K / V fragment read from shared memory feeds two products; 1 (8 warps of
// 16 rows) for D = 256, whose accumulators would not fit twice.
// 2^x (ex2.approx.ftz: 2 ulp, -inf -> +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct MmaShape {
  static constexpr int RW = D <= 128 ? 2 : 1;
  static constexpr int THREADS = 32 * MQ / (16 * RW);
};

// Grid (BH, ceil(Sq / 128)), the last q tile first (it has the most KV
// tiles under the causal mask).  Shared memory: q (128, D + 8), then K and
// V, two (64, D + 8) buffers each, bf16.
template <int D>
__global__ void __launch_bounds__(MmaShape<D>::THREADS, D <= 128 ? 2 : 1)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int sq, int sk, float scale_log2, bool causal) {
  constexpr int LD = D + 8;
  constexpr int RW = MmaShape<D>::RW, THREADS = MmaShape<D>::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + MQ * LD;
  bf16* vs = ks + 2 * MKV * LD;

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;
  const bf16* qb = q + bh * sq * D;
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;
  bf16* ob = out + bh * sq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // rows [r0, r0 + rows) of a row-major (n, D) matrix, zeros past row n
  auto stage_rows = [&](bf16* dst, const bf16* src, int n, int r0, int rows) {
    constexpr int VPR = D / 8;
    for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
      const int r = i / VPR, c = (i - r * VPR) * 8;
      const bool in = r0 + r < n;
      cp_async16(dst + r * LD + c, in ? src + (size_t)(r0 + r) * D + c : src,
                 in);
    }
  };

  int n_kv = (sk + MKV - 1) / MKV;
  if (causal) n_kv = min(n_kv, (q0 + MQ - 1) / MKV + 1);
  stage_rows(qs, qb, sq, q0, MQ);
  stage_rows(ks, kb, sk, 0, MKV);
  stage_rows(vs, vb, sk, 0, MKV);
  cp_async_commit();

  // the warp's rows [wrow, wrow + 16 RW); in m-tile r this thread holds
  // rows wrow + 16 r + g and + 8, g = lane / 4
  const int wrow = q0 + warp * 16 * RW;
  const int g = lane >> 2;
  float o[RW][D / 8][4], m_r[RW][2], l_r[RW][2];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m_r[r][0] = m_r[r][1] = NEG;
    l_r[r][0] = l_r[r][1] = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][j][e] = 0.0f;
  }

  for (int t = 0; t < n_kv; ++t) {
    cp_async_wait<0>();
    // tile t is visible to every warp, and every warp is done with tile t -
    // 1, whose buffers the next tile now overwrites while this one computes
    __syncthreads();
    if (t + 1 < n_kv) {
      stage_rows(ks + ((t + 1) & 1) * MKV * LD, kb, sk, (t + 1) * MKV, MKV);
      stage_rows(vs + ((t + 1) & 1) * MKV * LD, vb, sk, (t + 1) * MKV, MKV);
      cp_async_commit();
    }
    const int kv0 = t * MKV;
    const bf16* kt = ks + (t & 1) * MKV * LD;
    const bf16* vt = vs + (t & 1) * MKV * LD;
    // skip a tile wholly above this warp's rows
    if (!causal || kv0 <= wrow + 16 * RW - 1) {
      // s = q k^T: per m-tile 16 x 64, 8 blocks of 8 columns
      float s[RW][MKV / 8][4];
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[r][j][e] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[RW][4];
#pragma unroll
        for (int r = 0; r < RW; ++r)
          ldmatrix_x4(a[r], qs + (wrow - q0 + 16 * r + (lane & 15)) * LD +
                                kd * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j2 = 0; j2 < MKV / 16; ++j2) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + (j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                             kd * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            mma_bf16(s[r][2 * j2], a[r], b[0], b[1]);
            mma_bf16(s[r][2 * j2 + 1], a[r], b[2], b[3]);
          }
        }
      }

      // online softmax in the log2 domain: the row max of the raw scores
      // (masked ones -> -inf, so p = 0), then p = 2^(s scale log2e - m)
      const bool edge =
          kv0 + MKV > sk || (causal && kv0 + MKV - 1 > wrow);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (edge) {
              const int col = kv0 + j * 8 + 2 * (lane & 3) + (e & 1);
              const int row = wrow + 16 * r + g + 8 * (e >> 1);
              if (col >= sk || (causal && col > row)) s[r][j][e] = -INFINITY;
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[r][j][e]);
          }
        float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m_r[r][i], mx[i] * scale_log2);
          alpha[i] = ex2(m_r[r][i] - m_new);
          m_r[r][i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe =
                ex2(fmaf(s[r][j][e], scale_log2, -m_r[r][e >> 1]));
            rs[e >> 1] += pe;
            s[r][j][e] = pe;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
          rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
          l_r[r][i] = alpha[i] * l_r[r][i] + rs[i];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[r][j][0] *= alpha[0];
          o[r][j][1] *= alpha[0];
          o[r][j][2] *= alpha[1];
          o[r][j][3] *= alpha[1];
        }
      }

      // o += p v: p (bf16) as the A fragments, V's through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < MKV / 16; ++kk) {
        uint32_t pa[RW][4];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          pa[r][0] = pack_bf16(s[r][2 * kk][0], s[r][2 * kk][1]);
          pa[r][1] = pack_bf16(s[r][2 * kk][2], s[r][2 * kk][3]);
          pa[r][2] = pack_bf16(s[r][2 * kk + 1][0], s[r][2 * kk + 1][1]);
          pa[r][3] = pack_bf16(s[r][2 * kk + 1][2], s[r][2 * kk + 1][3]);
        }
#pragma unroll
        for (int d2 = 0; d2 < D / 16; ++d2) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                     d2 * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            mma_bf16(o[r][2 * d2], pa[r], b[0], b[1]);
            mma_bf16(o[r][2 * d2 + 1], pa[r], b[2], b[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + 16 * r + g + 8 * i;
      if (row >= sq) continue;
      const float inv = 1.0f / fmaxf(l_r[r][i], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + j * 8 +
                                           2 * (lane & 3)) =
            __floats2bfloat162_rn(o[r][j][2 * i] * inv,
                                  o[r][j][2 * i + 1] * inv);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int bh,
               int sq, int sk, float scale, bool causal,
               cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(MQ + 4 * MKV) * (D + 8);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + MQ - 1) / MQ);
  flash_mma_kernel<D><<<grid, MmaShape<D>::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, sk,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;    // q rows per block
constexpr int BKV = 64;   // kv rows per tile
constexpr int THREADS = 256;
constexpr int PLD = BKV + 4;  // row stride of the p tile (floats)

// rows [r0, r0 + 64) of a row-major (n, D) matrix into shared memory with
// row stride ld, zeros past row n
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int n, int r0) {
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = (i - r * VPR) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n)
      val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (BH, ceil(Sq / 64)).  Shared memory: q, k, v tiles (64, D + 4),
// then the p tile (64, PLD).
template <int NJ>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int sq,
                 int sk, float scale, bool causal) {
  constexpr int D = 64 * NJ;
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* ks = qs + BQ * LD;
  float* vs = ks + BKV * LD;
  float* ps = vs + BKV * LD;

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  float* ob = out + bh * sq * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_rows<D>(qs, LD, qb, sq, q0);

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.0f;
  }

  int n_kv = (sk + BKV - 1) / BKV;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BKV + 1);
  for (int t = 0; t < n_kv; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_rows<D>(ks, LD, kb, sk, kv0);
    load_rows<D>(vs, LD, vb, sk, kv0);
    __syncthreads();

    // s = q k^T over D, 16 bytes of each operand row per step
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax: each row's max and sum over its 16 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        ok[j] = col < sk && (!causal || col <= row);
        s[i][j] *= scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += p;
        ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p v
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float p4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PLD + c);
        p4[i][0] = pv.x;
        p4[i][1] = pv.y;
        p4[i][2] = pv.z;
        p4[i][3] = pv.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (c + cc) * LD + 64 * jj + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * jj + 0] = fmaf(p4[i][cc], vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p4[i][cc], vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p4[i][cc], vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p4[i][cc], vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[(size_t)row * D + 64 * jj + 4 * tx + e] = acc[i][4 * jj + e] / den;
  }
}

template <int NJ>
int launch_fma(const void* q, const void* k, const void* v, void* out, int bh,
               int sq, int sk, float scale, bool causal,
               cudaStream_t stream) {
  constexpr int LD = 64 * NJ + 4;
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BKV) * LD + (size_t)BQ * PLD);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_kernel<NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).  dtype 0 =
// f32, 1 = bf16 (q, k, v and out alike); causal 0 or 1.  The caller checks
// shapes (q / out (bh, sq, d), k / v (bh, sk, d)), d in {64, 128, 256},
// bh, sq, sk >= 1, dtypes, contiguity and 16-byte aligned bases.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int bh, int sq, int sk, int d, float scale,
                        int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool c = causal != 0;
  if (dtype == 1) {
    switch (d) {
      case 64:
        return launch_mma<64>(q, k, v, out, bh, sq, sk, scale, c, st);
      case 128:
        return launch_mma<128>(q, k, v, out, bh, sq, sk, scale, c, st);
      case 256:
        return launch_mma<256>(q, k, v, out, bh, sq, sk, scale, c, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (d) {
    case 64:
      return launch_fma<1>(q, k, v, out, bh, sq, sk, scale, c, st);
    case 128:
      return launch_fma<2>(q, k, v, out, bh, sq, sk, scale, c, st);
    case 256:
      return launch_fma<4>(q, k, v, out, bh, sq, sk, scale, c, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
