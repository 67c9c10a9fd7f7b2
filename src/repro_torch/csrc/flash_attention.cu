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
// carries acc, m and l in scratch from one grid step to the next.  Here
// one block owns a (slice, 64-row q tile) pair and loops over the 64-row
// KV tiles itself, with acc, m and l in registers: 256 threads, thread
// (ty = tid / 16, tx = tid % 16) owns rows ty + 16 i (i < 4), score
// columns tx + 16 j (j < 4) and output columns 64 jj + 4 tx + e.  A row's
// max and sum reduce over its 16 threads with warp shuffles.  KV tiles
// wholly above the diagonal are skipped.  Any Sq, Sk >= 1: rows and
// columns past the edge load as zeros, are masked and are not stored.
//
// Bound on this card: at BH = 128, S = 512, D = 128 in bf16 the call moves
// 67 MB (q, k, v read once, out written once), 0.020 ms at 3.35 TB/s, and
// does 4 BH S^2 D = 17 GFLOP non-causal (half causal), 0.017 ms at 989
// TFLOP/s: bytes, barely.  This first kernel runs the products as f32 FMAs
// on the CUDA cores (17 GFLOP at 67 TFLOP/s is 0.26 ms), with 16-byte
// shared-memory reads laid out free of bank conflicts; tensor cores, a
// cp.async / TMA pipeline over the KV tiles and warp specialisation are
// later work.  It is on no model path yet (the JAX package's prefill runs
// jnp attention).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // q rows per block
constexpr int BKV = 64;   // kv rows per tile
constexpr int THREADS = 256;
constexpr int PLD = BKV + 4;  // row stride of the p tile (floats)
constexpr float NEG = -1e30f;
constexpr int SMEM_LIMIT = 232448;

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same<T, bf16>::value) {
    return __float2bfloat16(v);
  } else {
    return v;
  }
}

// p rounded to T, kept as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, bf16>::value) {
    return __bfloat162float(__float2bfloat16(v));
  } else {
    return v;
  }
}

// 16 bytes of T at p -> floats
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<T, bf16>::value) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = f[e];
  }
}

// 4 consecutive T at p -> floats
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* out) {
  if constexpr (std::is_same<T, bf16>::value) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
}

// rows [r0, r0 + 64) of a row-major (n, D) matrix into shared memory with
// row stride ld, zeros past row n
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int n,
                                          int r0) {
  constexpr int VPR = D * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = (i - r * VPR) * (16 / (int)sizeof(T));
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
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

// Grid (BH, ceil(Sq / 64)).  Shared memory: q, k, v tiles (64, D + VEC) in
// T, then the p tile (64, PLD) in f32.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int sk, float scale, bool causal) {
  constexpr int D = 64 * NJ;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = D + VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + BQ * LD;
  T* vs = ks + BKV * LD;
  float* ps = reinterpret_cast<float*>(vs + BKV * LD);

  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  T* ob = out + bh * sq * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_rows<T, D>(qs, LD, qb, sq, q0);

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
    load_rows<T, D>(ks, LD, kb, sk, kv0);
    load_rows<T, D>(vs, LD, vb, sk, kv0);
    __syncthreads();

    // s = q k^T over D, 16 bytes of each operand row per step
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += VEC) {
      float qv[4][VEC], kv[4][VEC];
#pragma unroll
      for (int i = 0; i < 4; ++i) load16<T>(qs + (ty + 16 * i) * LD + d0, qv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load16<T>(ks + (tx + 16 * j) * LD + d0, kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
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
        ps[(ty + 16 * i) * PLD + tx + 16 * j] = round_to<T>(p);
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
          float vv[4];
          load4<T>(vs + (c + cc) * LD + 64 * jj + 4 * tx, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][4 * jj + e] = fmaf(p4[i][cc], vv[e], acc[i][4 * jj + e]);
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
        ob[(size_t)row * D + 64 * jj + 4 * tx + e] =
            from_float<T>(acc[i][4 * jj + e] / den);
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, float scale, bool causal, cudaStream_t stream) {
  constexpr int D = 64 * NJ;
  constexpr int LD = D + 16 / (int)sizeof(T);
  const size_t smem =
      sizeof(T) * (size_t)(BQ + 2 * BKV) * LD + sizeof(float) * BQ * PLD;
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int sk, int d, float scale, bool causal,
             cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 1>(q, k, v, out, bh, sq, sk, scale, causal, stream);
    case 128:
      return launch<T, 2>(q, k, v, out, bh, sq, sk, scale, causal, stream);
    case 256:
      return launch<T, 4>(q, k, v, out, bh, sq, sk, scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  if (dtype == 1)
    return dispatch<bf16>(q, k, v, out, bh, sq, sk, d, scale, causal != 0,
                          st);
  return dispatch<float>(q, k, v, out, bh, sq, sk, d, scale, causal != 0,
                         st);
}

}  // extern "C"
