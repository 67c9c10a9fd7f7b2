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
// block owns a (slice, q tile) pair and loops over the KV tiles itself,
// with acc, m and l in registers.  KV tiles wholly above the diagonal
// are skipped.  Any Sq, Sk >= 1: rows and columns past the edge load as
// zeros, are masked and are not stored.
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
// f32 (flash_split_kernel): both products on the tensor cores in split
// f32 (3xTF32, hopper.cuh: each operand split into TF32 hi and lo parts,
// three m16n8k8 products accumulating in f32), as accurate as f32 FMAs
// (one TF32 product alone would miss the 1e-4 bound).  Same structure as
// the bf16 kernel, with one 16-row tile per warp (the hi / lo fragments
// double the operand registers): 128 q rows and 64-row KV tiles in 8 warps
// for D <= 128, 64 and 32 in 4 warps for D = 256, K and V double-buffered
// with cp.async.  The fragments are loaded from shared memory and split in
// registers.  In q k^T the k = t / t + 4 halves of each 8-wide step are
// columns 2t / 2t + 1 of q and K (one 8-byte load each); in p v they are
// kv rows 2t / 2t + 1, so the s accumulator, which holds columns 2t and
// 2t + 1, is the A fragment of p v as it stands: p stays in registers
// with no shuffle.  At (BH 128, S 512, D 128) the split issues 3 x 17
// GFLOP: 0.104 ms at 495 TFLOP/s (TF32), against 0.26 ms for f32 FMAs at
// 67.  It is on no model path (the JAX package's prefill runs jnp
// attention).

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
// f32: split f32 (3xTF32) on the tensor cores
// ---------------------------------------------------------------------------

// One 16-row m tile per warp.  MQ q rows and MKV kv rows per tile: 128 /
// 64 (8 warps) for D <= 128, 64 / 32 (4 warps) for D = 256, whose f32
// tiles would not fit otherwise.  Row strides: q and K D + 8 floats (the
// 8-byte fragment loads of 16 lanes hit 32 banks), V D + 4 (the 4-byte
// loads of rows 2t and 2t + 1 hit 32 banks).
template <int D>
struct SplitShape {
  static constexpr int MQ = D <= 128 ? 128 : 64;
  static constexpr int MKV = D <= 128 ? 64 : 32;
  static constexpr int THREADS = 32 * MQ / 16;
  static constexpr int LDQ = D + 8, LDV = D + 4;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)(MQ + 2 * MKV) * LDQ + 2 * MKV * LDV);
};

// Grid (BH, ceil(Sq / MQ)), the last q tile first.  Shared memory: q (MQ,
// LDQ), then K, two (MKV, LDQ) buffers, then V, two (MKV, LDV), f32.
template <int D>
__global__ void __launch_bounds__(SplitShape<D>::THREADS, D <= 64 ? 2 : 1)
    flash_split_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int sq, int sk, float scale_log2, bool causal) {
  using S = SplitShape<D>;
  constexpr int MQ = S::MQ, MKV = S::MKV, THREADS = S::THREADS;
  constexpr int LDQ = S::LDQ, LDV = S::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + MQ * LDQ;
  float* vs = ks + 2 * MKV * LDQ;

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;
  float* ob = out + bh * sq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // rows [r0, r0 + rows) of a row-major (n, D) matrix, zeros past row n
  auto stage_rows = [&](float* dst, int ld, const float* src, int n, int r0,
                        int rows) {
    constexpr int VPR = D / 4;
    for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
      const int r = i / VPR, c = (i - r * VPR) * 4;
      const bool in = r0 + r < n;
      cp_async16(dst + r * ld + c, in ? src + (size_t)(r0 + r) * D + c : src,
                 in);
    }
  };

  int n_kv = (sk + MKV - 1) / MKV;
  if (causal) n_kv = min(n_kv, (q0 + MQ - 1) / MKV + 1);
  stage_rows(qs, LDQ, qb, sq, q0, MQ);
  stage_rows(ks, LDQ, kb, sk, 0, MKV);
  stage_rows(vs, LDV, vb, sk, 0, MKV);
  cp_async_commit();

  // the warp's rows [wrow, wrow + 16): this thread holds rows wrow + g and
  // wrow + g + 8
  const int wrow = q0 + warp * 16;
  const int g = lane >> 2, tq = lane & 3;
  float o[D / 8][4], m_r[2] = {NEG, NEG}, l_r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;

  for (int t = 0; t < n_kv; ++t) {
    cp_async_wait<0>();
    // tile t is visible to every warp, and every warp is done with tile t -
    // 1, whose buffers the next tile now overwrites while this one computes
    __syncthreads();
    if (t + 1 < n_kv) {
      stage_rows(ks + ((t + 1) & 1) * MKV * LDQ, LDQ, kb, sk, (t + 1) * MKV,
                 MKV);
      stage_rows(vs + ((t + 1) & 1) * MKV * LDV, LDV, vb, sk, (t + 1) * MKV,
                 MKV);
      cp_async_commit();
    }
    const int kv0 = t * MKV;
    const float* kt = ks + (t & 1) * MKV * LDQ;
    const float* vt = vs + (t & 1) * MKV * LDV;
    // skip a tile wholly above this warp's rows
    if (causal && kv0 > wrow + 15) continue;

    // s = q k^T, 16 x MKV: over D in steps of 8, k = t and t + 4 of each
    // step taken as columns 2t and 2t + 1 of q and K, one 8-byte load each
    float s[MKV / 8][4];
#pragma unroll
    for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    const float* qw = qs + (wrow - q0 + g) * LDQ + 2 * tq;
    const float* kw = kt + g * LDQ + 2 * tq;
#pragma unroll 2
    for (int kd = 0; kd < D / 8; ++kd) {
      // rows g and g + 8
      const float2 top = *reinterpret_cast<const float2*>(qw + kd * 8);
      const float2 bot =
          *reinterpret_cast<const float2*>(qw + 8 * LDQ + kd * 8);
      const float qa[4] = {top.x, bot.x, top.y, bot.y};
      uint32_t ah[4], al[4];
      split_frag(qa, ah, al);
      uint32_t bh[MKV / 8][2], bl[MKV / 8][2];
#pragma unroll
      for (int j = 0; j < MKV / 8; ++j) {
        const float2 kv =
            *reinterpret_cast<const float2*>(kw + j * 8 * LDQ + kd * 8);
        split_tf32(kv.x, bh[j][0], bl[j][0]);
        split_tf32(kv.y, bh[j][1], bl[j][1]);
      }
      mma_split_rows(s, 0, ah, al, bh, bl);
    }

    // online softmax in the log2 domain, as in the bf16 kernel
    const bool edge = kv0 + MKV > sk || (causal && kv0 + MKV - 1 > wrow);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int col = kv0 + j * 8 + 2 * tq + (e & 1);
          const int row = wrow + g + 8 * (e >> 1);
          if (col >= sk || (causal && col > row)) s[j][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i] * scale_log2);
      alpha[i] = ex2(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(s[j][e], scale_log2, -m_r[e >> 1]));
        rs[e >> 1] += pe;
        s[j][e] = pe;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_r[i] = alpha[i] * l_r[i] + rs[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // o += p v over the tile's kv rows in steps of 8.  The accumulator of
    // s holds columns 2t and 2t + 1 where the A fragment wants t and t +
    // 4; taking k = t as kv row 2t and k = t + 4 as row 2t + 1 makes the
    // accumulator the A fragment, with no shuffle: the B fragment reads V
    // rows 2t and 2t + 1.
    const float* vw = vt + 2 * tq * LDV + g;
#pragma unroll
    for (int kk = 0; kk < MKV / 8; ++kk) {
      const float pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      uint32_t ah[4], al[4];
      split_frag(pa, ah, al);
      // output columns in groups of 8 n tiles
#pragma unroll
      for (int d0 = 0; d0 < D / 8; d0 += 8) {
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          split_tf32(vw[kk * 8 * LDV + (d0 + i) * 8], bh[i][0], bl[i][0]);
          split_tf32(vw[(kk * 8 + 1) * LDV + (d0 + i) * 8], bh[i][1],
                     bl[i][1]);
        }
        mma_split_rows(o, d0, ah, al, bh, bl);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wrow + g + 8 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(ob + (size_t)row * D + j * 8 + 2 * tq) =
          make_float2(o[j][2 * i] / den, o[j][2 * i + 1] / den);
  }
}

template <int D>
int launch_split(const void* q, const void* k, const void* v, void* out,
                 int bh, int sq, int sk, float scale, bool causal,
                 cudaStream_t stream) {
  using S = SplitShape<D>;
  if (S::SMEM > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + S::MQ - 1) / S::MQ);
  flash_split_kernel<D><<<grid, S::THREADS, S::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk,
      scale * 1.4426950408889634f, causal);
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
      return launch_split<64>(q, k, v, out, bh, sq, sk, scale, c, st);
    case 128:
      return launch_split<128>(q, k, v, out, bh, sq, sk, scale, c, st);
    case 256:
      return launch_split<256>(q, k, v, out, bh, sq, sk, scale, c, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
