// Radial and angular basis kernels for Hopper (sm_90a): the bases of the
// feature embedding at mlp_impl="pallas".
//
//   rbf_fwd      replaces fused_rbf_pallas
//                (src/repro/kernels/fused_rbf.py:36; kernel body _kernel :27)
//   fourier_fwd  replaces fused_fourier_pallas
//                (src/repro/kernels/fused_fourier.py:39; kernel body
//                _kernel :20)
//
// rbf_fwd, per bond n and basis index k (Eq. 2 with the factored envelope
// of Eq. 13, C5):
//   xi = r / rc,  u = 1 - 0.5 * xi^p * ((p+1)(p+2) + xi (-2p(p+2) + xi p(p+1)))
//   out[n, k] = sqrt(2/rc) * sin(f_k * xi) / r_safe * u,
//   r_safe = r if r > 1e-8 else 1,
// with xi^p by repeated squaring in the order of JAX's integer_pow, so a
// padded bond (r = 0) gives exactly 0.
//
// fourier_fwd, per angle n and basis index j (K = 2L + 1):
//   out[n, 0] = (1/sqrt 2) / sqrt(pi),  out[n, j] = cos(j t) / sqrt(pi)
//   for 1 <= j <= L,  out[n, L + j] = sin(j t) / sqrt(pi).
//
// Bound on this card: one pass over (N, K) outputs from N inputs, about 40
// flops an element (one sine or cosine with full range reduction), so both
// are bound by the bytes they write: (394,496, 31) and (380,928, 31) f32
// at batch 128, about 49 MB each.  One thread per output element over the
// flat (N * K) index, so a warp's stores are consecutive; the rows are 31
// floats (124 bytes) apart, which rules out 16-byte vector stores.  The
// input value of a row is read once per element from L1.  Accurate sinf /
// cosf and IEEE division (no fast-math intrinsics): the phases reach
// f_31 * xi ~ 97 rad at the cutoff.
//
// TPU mechanics that are not carried over: the basis axis is not padded to
// 128 lanes, and the lane-index select of the Fourier kernel becomes a
// branch on the output column.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float integer_pow(float x, int n) {
  // repeated squaring, multiplying in the order of JAX's integer_pow
  float acc = 1.0f;
  bool first = true;
  while (n > 0) {
    if (n & 1) {
      acc = first ? x : acc * x;
      first = false;
    }
    n >>= 1;
    if (n > 0) x = x * x;
  }
  return acc;
}

__global__ void rbf_kernel(const float* __restrict__ dist,
                           const float* __restrict__ freqs,
                           float* __restrict__ out, long long total, int k,
                           float r_cut, float norm, int p) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long n = idx / k;
  const int j = (int)(idx - n * k);
  const float r = __ldg(dist + n);
  const float xi = r / r_cut;
  const float fp = (float)p;
  const float inner = (fp + 1.0f) * (fp + 2.0f)
      + xi * (-2.0f * fp * (fp + 2.0f) + xi * (fp * (fp + 1.0f)));
  const float u = 1.0f - 0.5f * integer_pow(xi, p) * inner;
  const float r_safe = r > 1e-8f ? r : 1.0f;
  const float val = norm * sinf(xi * __ldg(freqs + j));
  out[idx] = val / r_safe * u;
}

__global__ void fourier_kernel(const float* __restrict__ theta,
                               float* __restrict__ out, long long total,
                               int k, int harmonics) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long n = idx / k;
  const int j = (int)(idx - n * k);
  const float t = __ldg(theta + n);
  float val;
  if (j == 0) {
    val = 0.70710678118654752f;  // 1/sqrt(2)
  } else if (j <= harmonics) {
    val = cosf(t * (float)j);
  } else {
    val = sinf(t * (float)(j - harmonics));
  }
  out[idx] = val / 1.77245385090551603f;  // sqrt(pi)
}

int grid_for(long long total) {
  return (int)((total + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The caller checks shapes, f32 dtypes and contiguity; `norm` is
// sqrt(2 / r_cut) and `num_basis` of fourier_fwd is odd.

int rbf_fwd(const float* dist, const float* freqs, float* out, int n,
            int k, float r_cut, float norm, int p, void* stream) {
  const long long total = (long long)n * k;
  if (total == 0) return 0;
  rbf_kernel<<<grid_for(total), THREADS, 0, (cudaStream_t)stream>>>(
      dist, freqs, out, total, k, r_cut, norm, p);
  return (int)cudaGetLastError();
}

int fourier_fwd(const float* theta, float* out, int n, int num_basis,
                void* stream) {
  const long long total = (long long)n * num_basis;
  if (total == 0) return 0;
  fourier_kernel<<<grid_for(total), THREADS, 0, (cudaStream_t)stream>>>(
      theta, out, total, num_basis, (num_basis - 1) / 2);
  return (int)cudaGetLastError();
}

}  // extern "C"
