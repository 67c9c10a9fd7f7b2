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
// with xi^p by repeated squaring in the order of JAX's integer_pow.
//
// fourier_fwd, per angle n and basis index j (K = 2L + 1):
//   out[n, 0] = (1/sqrt 2) / sqrt(pi),  out[n, j] = cos(j t) / sqrt(pi)
//   for 1 <= j <= L,  out[n, L + j] = sin(j t) / sqrt(pi).
//
// Bound on this card: one pass over (N, K) f32 outputs from N inputs, a
// sine or a sine-cosine pair (one range reduction, ~40 instructions) per
// output or per two, so both are bound by the bytes they write: (394,496,
// 31) and (380,928, 31) at batch 128, ~49 MB each, 0.015 ms at 3.35 TB/s.
// The design keeps the arithmetic under that:
//   - a persistent grid (kernels/ops.py basis_plan: at most 8 blocks of
//     256 threads an SM) strides over tiles of T rows, T a multiple of 4, so
//     every tile's flat start (row0 * K floats, K odd) is 16-byte aligned
//     and all its output but a ragged last tile's tail is written with
//     16-byte stores; indices are 32-bit, rows are found by a multiply-high
//     by the reciprocal of K (div_magic), never by a division;
//   - per-row work is done once a row, by thread t < T at the start of a
//     tile, into shared memory: for the RBF xi, the envelope u and u /
//     r_safe (one IEEE division a row, in place of one an element); for
//     the Fourier basis t.  The RBF's K frequencies are loaded into shared
//     memory once a block;
//   - the RBF: each thread makes 4 consecutive flat outputs (rows and
//     columns stepped from the first) and stores them as one float4.  A
//     phase below 2^-12 takes sin(x) = x, its correctly rounded sine: the
//     padded bonds (297k of the 394k rows at batch 128, at r = 1e-8 from
//     compute_geometry's sqrt(|v|^2 + 1e-16), or at r = 0) skip the sine,
//     and r = 0 gives exactly 0 as in the plain version;
//   - the Fourier basis: one sincosf(t * (float)j) for each (row, harmonic
//     j) puts cos in column j and sin in column L + j of a shared tile with
//     the output's row stride K (consecutive threads write consecutive
//     words: no bank conflicts), column 0 the plain version's constant;
//     the tile is then copied out with 16-byte stores.  T x K floats fit
//     8,192 (T = 256 at K <= 31, 64 at K = 127).  An angle of exactly 0
//     takes cos = 1, sin = 0, which sincosf gives there; any other value
//     (padded angles carry arccos(1 - 1e-7) ~ 4.9e-4, not 0) the full
//     path.
// Accuracy: accurate sinf / sincosf (no fast-math intrinsics): the phases
// reach f_31 * xi ~ 97 rad at the cutoff, 63 pi at K = 127.  The phase is
// formed as the plain version forms it (xi * f, t * (float)j, one
// rounding).  Divisions become multiplications where they were per
// element: the RBF's (norm * sin) / r_safe * u becomes (norm * sin) * (u /
// r_safe), the Fourier basis' v / sqrt(pi) becomes v * (1 / sqrt(pi)),
// each within ~2 ulp of the plain order (it multiplies by the reciprocal
// on the card too).
//
// TPU mechanics that are not carried over: the basis axis is not padded to
// 128 lanes, and the lane-index select of the Fourier kernel becomes the
// (row, harmonic) pairs above.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// the RBF: rows a tile, and the most basis functions (shared memory)
constexpr int RBF_TILE = 128;
constexpr int RBF_MAX_BASIS = 1024;
// the Fourier basis: floats of the shared output tile, most rows a tile
constexpr int FOURIER_TILE_FLOATS = 8192;
constexpr int FOURIER_MAX_TILE = 256;

// rows of a Fourier tile at K basis functions (as kernels/ops.py
// basis_plan): the most, a multiple of 4 and at most 256, whose T x K
// floats fit the shared tile
__host__ __device__ constexpr int fourier_tile(int k) {
  return (FOURIER_TILE_FLOATS / k) / 4 * 4 < FOURIER_MAX_TILE
             ? (FOURIER_TILE_FLOATS / k) / 4 * 4
             : FOURIER_MAX_TILE;
}

// m = ceil(2^32 / d) for d >= 2: __umulhi(x, m) == x / d exactly while x
// (m d - 2^32) < 2^32, i.e. x < 2^32 / d; every index here is below 2^17
// and d at most 1024
__device__ __forceinline__ unsigned div_magic(unsigned d) {
  return 0xffffffffu / d + 1u;
}

__device__ __forceinline__ int div_by(unsigned x, unsigned d,
                                      unsigned magic) {
  return d == 1u ? (int)x : (int)__umulhi(x, magic);
}

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

// below 2^-12 in magnitude sin(x) rounds to x (x^2 / 6 < 2^-25 of x), so
// the phases of a padded bond (r = 0, or the 1e-8 that compute_geometry's
// sqrt(0 + 1e-16) gives it) skip the sine; r = 0 gives exactly 0
__device__ __forceinline__ float rbf_value(float xi, float scale, float f,
                                           float norm) {
  const float x = xi * f;
  return (norm * (fabsf(x) < 0x1p-12f ? x : sinf(x))) * scale;
}

__global__ void __launch_bounds__(THREADS)
    rbf_kernel(const float* __restrict__ dist,
               const float* __restrict__ freqs, float* __restrict__ out,
               int n, int k, float r_cut, float norm, int p) {
  __shared__ float s_freq[RBF_MAX_BASIS];
  __shared__ float s_xi[RBF_TILE];
  __shared__ float s_scale[RBF_TILE];
  for (int j = threadIdx.x; j < k; j += THREADS) s_freq[j] = __ldg(freqs + j);
  const unsigned uk = (unsigned)k;
  const unsigned magic = k > 1 ? div_magic(uk) : 0u;
  const float fp = (float)p;
  const int n_tiles = (n + RBF_TILE - 1) / RBF_TILE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * RBF_TILE;
    const int rows = min(RBF_TILE, n - row0);
    __syncthreads();  // the last tile's reads of s_xi / s_scale are done
    if (threadIdx.x < rows) {
      const float r = __ldg(dist + row0 + threadIdx.x);
      const float xi = r / r_cut;
      const float inner = (fp + 1.0f) * (fp + 2.0f)
          + xi * (-2.0f * fp * (fp + 2.0f) + xi * (fp * (fp + 1.0f)));
      const float u = 1.0f - 0.5f * integer_pow(xi, p) * inner;
      const float r_safe = r > 1e-8f ? r : 1.0f;
      s_xi[threadIdx.x] = xi;
      s_scale[threadIdx.x] = u / r_safe;
    }
    __syncthreads();
    float* tile_out = out + (size_t)row0 * k;
    const int count = rows * k;
    const int groups = count >> 2;
    for (int q = threadIdx.x; q < groups; q += THREADS) {
      const unsigned f = 4u * (unsigned)q;
      int r = div_by(f, uk, magic);
      int j = (int)f - r * k;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = rbf_value(s_xi[r], s_scale[r], s_freq[j], norm);
        if (++j == k) {
          j = 0;
          ++r;
        }
      }
      reinterpret_cast<float4*>(tile_out)[q] =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    // a ragged last tile's tail: count % 4 scalars
    if (threadIdx.x < (count & 3)) {
      const unsigned f = 4u * (unsigned)groups + threadIdx.x;
      const int r = div_by(f, uk, magic);
      const int j = (int)f - r * k;
      tile_out[f] = rbf_value(s_xi[r], s_scale[r], s_freq[j], norm);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    fourier_kernel(const float* __restrict__ theta, float* __restrict__ out,
                   int n, int k) {
  __shared__ __align__(16) float s_tile[FOURIER_TILE_FLOATS];
  __shared__ float s_t[FOURIER_MAX_TILE];
  const int l = (k - 1) >> 1;
  const int tile_rows = fourier_tile(k);
  const unsigned ul = (unsigned)l;
  const unsigned magic = l > 1 ? div_magic(ul) : 0u;
  // 1 / sqrt(pi), and column 0: (1 / sqrt 2) / sqrt(pi) in the same order
  const float inv_sqrt_pi = 1.0f / 1.77245385090551603f;
  const float dc = 0.70710678118654752f * inv_sqrt_pi;
  const int n_tiles = (n + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * tile_rows;
    const int rows = min(tile_rows, n - row0);
    __syncthreads();  // the last tile's copy out of s_tile is done
    if (threadIdx.x < rows) {
      s_t[threadIdx.x] = __ldg(theta + row0 + threadIdx.x);
      s_tile[threadIdx.x * k] = dc;
    }
    __syncthreads();
    const int pairs = rows * l;
    for (int q = threadIdx.x; q < pairs; q += THREADS) {
      const int r = div_by((unsigned)q, ul, magic);
      const int j = q - r * l + 1;
      const float t = s_t[r];
      float s = 0.0f, c = 1.0f;
      if (t != 0.0f) sincosf(t * (float)j, &s, &c);
      s_tile[r * k + j] = c * inv_sqrt_pi;
      s_tile[r * k + l + j] = s * inv_sqrt_pi;
    }
    __syncthreads();
    float* tile_out = out + (size_t)row0 * k;
    const int count = rows * k;
    const int groups = count >> 2;
    const float4* src = reinterpret_cast<const float4*>(s_tile);
    float4* dst = reinterpret_cast<float4*>(tile_out);
    for (int q = threadIdx.x; q < groups; q += THREADS) dst[q] = src[q];
    if (threadIdx.x < (count & 3))
      tile_out[4 * groups + threadIdx.x] = s_tile[4 * groups + threadIdx.x];
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The caller checks shapes, f32 dtypes and contiguity, allocates `out`
// 16-byte aligned, and gives the launch plan (tile, grid) of kernels/ops.py
// basis_plan; a tile other than this file's rule is refused.  `norm` is
// sqrt(2 / r_cut), `k` of rbf_fwd at most 1024 and `num_basis` of
// fourier_fwd odd and at most 127.

int rbf_fwd(const float* dist, const float* freqs, float* out, int n,
            int k, float r_cut, float norm, int p, int tile, int grid,
            void* stream) {
  if (tile != RBF_TILE || k < 0 || k > RBF_MAX_BASIS || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || k == 0) return 0;
  rbf_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      dist, freqs, out, n, k, r_cut, norm, p);
  return (int)cudaGetLastError();
}

int fourier_fwd(const float* theta, float* out, int n, int num_basis,
                int tile, int grid, void* stream) {
  if (num_basis < 1 || num_basis > 127 || num_basis % 2 != 1 ||
      tile != fourier_tile(num_basis) || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  fourier_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(theta, out, n,
                                                             num_basis);
  return (int)cudaGetLastError();
}

}  // extern "C"
