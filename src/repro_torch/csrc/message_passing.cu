// The f32 entries of the message-passing kernels (kernels 2-5 in split
// f32, message_passing.cuh) and kernel 4b's per-crystal sum.

#include "message_passing.cuh"

namespace {

// crystal_row_sum_kernel (entry virial_crystal_sum): raw[c] = sum of
// vir[r] over the atom rows r of crystal c.  A row with bonds (offs[r] <
// offs[r + 1]) belongs to cry[offs[r]], the crystal of its first bond; a
// row without bonds holds zeros and is skipped.  So any order of crystal
// ids over the rows gives the JAX kernel's sums (_force_virial_kernel adds
// each bond into its crystal's row through a one-hot of bond_crystal):
// slots permuted, crystals whose rows interleave, empty slots and bondless
// crystals (zeros).  The one precondition the JAX kernel does not have:
// every real bond of a row carries the crystal of the row's first bond,
// as a bond lies in its center atom's crystal and every producer lays
// batches out (batching/pack.py validate_layout checks it).  One block of
// CRYSTAL_THREADS a crystal walks every row: thread t takes rows t, t +
// 256, ... in row order, then a butterfly sum in each warp and the warp
// sums in warp order, so the order is the same from run to run and there
// are no atomics.  Bound: it reads C x A offsets (coalesced) and the
// crystal id at each row's first bond (a gather), from L2 after the first
// block: ~0.8 M reads at the train batch (128 crystals x 6,400 rows), and
// each crystal's own rows of vir once.  The padded tail past offs[-1] is
// never read.  It takes the place of the TPU kernel's (Bp, 3*128)
// accumulator carried across its sequential grid.
constexpr int CRYSTAL_THREADS = 256;

__global__ void __launch_bounds__(CRYSTAL_THREADS) crystal_row_sum_kernel(
    const float* __restrict__ vir, const int* __restrict__ cry,
    const int* __restrict__ offs, float* __restrict__ raw, int n_rows) {
  __shared__ float warp_part[CRYSTAL_THREADS / 32][9];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.0f;
  for (int r = threadIdx.x; r < n_rows; r += CRYSTAL_THREADS) {
    const int first = __ldg(offs + r);
    if (first < __ldg(offs + r + 1) && __ldg(cry + first) == c) {
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k] += vir[(size_t)r * 9 + k];
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) warp_part[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < 9) {
    float s = warp_part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < CRYSTAL_THREADS / 32; ++w)
      s += warp_part[w][threadIdx.x];
    raw[(size_t)c * 9 + threadIdx.x] = s;
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The caller checks shapes, dtypes (f32 features, int32 ids), contiguity,
// 16-byte aligned tables, D in {8, 16, 32, 64, 128}, and gives the
// launch plan (grid, t_min, tm, smem) of kernels/ops.py conv_plan.

// pair == nullptr: the directed store; else e_a is an (Eu, D) table read
// through pair, and with und != 0 e is one too.
int atom_conv_fwd(const float* v, const float* e, const float* e_a,
                  const float* w, const float* b, const float* ln_scale,
                  const float* ln_bias, const int* center, const int* nbr,
                  const int* pair, const int* offs, float* out, int n_rows,
                  int dim, int und, int grid, int t_min, int tm, int smem,
                  void* stream) {
  return atom_conv<float>(v, e, e_a, w, b, ln_scale, ln_bias, center, nbr,
                          pair, offs, out, n_rows, dim, und, grid, t_min, tm,
                          smem, stream);
}

// env_ij / env_ik: the rows of e_b for each angle, angle_ij / angle_ik on
// the directed store, pair[angle_ij] / pair[angle_ik] on the undirected one.
int bond_conv_fwd(const float* v, const float* e, const float* a_feat,
                  const float* e_b, const float* w, const float* b,
                  const float* ln_scale, const float* ln_bias,
                  const int* angle_ij, const int* angle_ik,
                  const int* center_ids, const int* env_ij,
                  const int* env_ik, const int* offs, float* out, int n_rows,
                  int dim, int grid, int t_min, int tm, int smem,
                  void* stream) {
  return bond_conv<float>(v, e, a_feat, e_b, w, b, ln_scale, ln_bias,
                          angle_ij, angle_ik, center_ids, env_ij, env_ik,
                          offs, out, n_rows, dim, grid, t_min, tm, smem,
                          stream);
}

// Phase A of the symmetric bond conv: messages (n_au, D) of the real dedup
// rows [0, offs[n_eu] / 2); w23 is (3D, 2D) = [W1 | W2 + W3 | W4].
int sym_msg_fwd(const float* v, const float* e, const float* a_u,
                const float* e_b, const float* w23, const float* b,
                const float* ln_scale, const float* ln_bias, const int* ctr,
                const int* du1, const int* du2, const int* offs, float* out,
                int n_eu, int n_au, int dim, int grid, int tm, int smem,
                void* stream) {
  if (n_au == 0) return 0;
  ConvArgs<float> a{};
  a.tab0 = v;
  a.id0 = ctr;
  a.tab1 = e;
  a.id1 = du1;
  a.tab2 = e;
  a.id2 = du2;
  a.tab3 = a_u;
  a.env = e_b;
  a.env0 = du1;
  a.env1 = du2;
  a.w = w23;
  a.bias = b;
  a.lns = ln_scale;
  a.lnb = ln_bias;
  a.offs = offs;
  a.out = out;
  a.n_rows = n_eu;
  a.n_out = n_au;
  return dispatch_conv<SYM>(a, dim, grid, tm, smem, stream);
}

int force_readout_fwd(const float* e, const float* x_hat, const float* w1,
                      const float* b1, const float* w2, const float* b2,
                      const int* offs, float* out, int n_rows, int dim,
                      int grid, int t_min, int tm, int smem, void* stream) {
  if (n_rows == 0) return 0;
  const ForceArgs<float> a{e,   x_hat, nullptr, w1,  b1,     w2,
                           b2,  offs,  out,     nullptr, n_rows, t_min};
  return dispatch_force<false>(a, dim, grid, tm, smem, stream);
}

// Forces (A, 3) and the per-row virial partials vir (A, 9); the caller
// then sums vir per crystal with virial_crystal_sum.
int force_virial_fwd(const float* e, const float* x_hat, const float* dist,
                     const float* w1, const float* b1, const float* w2,
                     const float* b2, const int* offs, float* out,
                     float* vir, int n_rows, int dim, int grid, int t_min,
                     int tm, int smem, void* stream) {
  if (n_rows == 0) return 0;
  const ForceArgs<float> a{e, x_hat, dist, w1, b1, w2, b2, offs, out, vir,
                           n_rows, t_min};
  return dispatch_force<true>(a, dim, grid, tm, smem, stream);
}

// raw (B, 9) from the per-row partials of force_virial_fwd.
int virial_crystal_sum(const float* vir, const int* cry, const int* offs,
                       float* raw, int n_rows, int n_crystals, void* stream) {
  if (n_crystals == 0) return 0;
  crystal_row_sum_kernel<<<n_crystals, CRYSTAL_THREADS, 0,
                           (cudaStream_t)stream>>>(vir, cry, offs, raw,
                                                   n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
