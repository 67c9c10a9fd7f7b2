// The bf16 entries of the message-passing kernels (DESIGN.md §4, the
// mixed tiers): kernels 2, 3 and 4a with bf16 operands, the templates of
// message_passing.cuh instantiated at T = bf16, in a library of their own
// so that they compile beside the f32 ones.

#include "message_passing.cuh"

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The caller checks shapes, dtypes (bf16 features, int32 ids; x_hat f32),
// contiguity, 16-byte aligned tables, D in {8, 16, 32, 64, 128}, and
// gives the launch plan (grid, t_min, tm, smem) of kernels/ops.py
// conv_plan with itemsize 2.  Arguments as the f32 entries'.

int atom_conv_bf16_fwd(const bf16* v, const bf16* e, const bf16* e_a,
                       const bf16* w, const bf16* b, const bf16* ln_scale,
                       const bf16* ln_bias, const int* center,
                       const int* nbr, const int* pair, const int* offs,
                       bf16* out, int n_rows, int dim, int und, int grid,
                       int t_min, int tm, int smem, void* stream) {
  return atom_conv<bf16>(v, e, e_a, w, b, ln_scale, ln_bias, center, nbr,
                         pair, offs, out, n_rows, dim, und, grid, t_min, tm,
                         smem, stream);
}

int bond_conv_bf16_fwd(const bf16* v, const bf16* e, const bf16* a_feat,
                       const bf16* e_b, const bf16* w, const bf16* b,
                       const bf16* ln_scale, const bf16* ln_bias,
                       const int* angle_ij, const int* angle_ik,
                       const int* center_ids, const int* env_ij,
                       const int* env_ik, const int* offs, bf16* out,
                       int n_rows, int dim, int grid, int t_min, int tm,
                       int smem, void* stream) {
  return bond_conv<bf16>(v, e, a_feat, e_b, w, b, ln_scale, ln_bias,
                         angle_ij, angle_ik, center_ids, env_ij, env_ik, offs,
                         out, n_rows, dim, grid, t_min, tm, smem, stream);
}

// x_hat (E, 3) f32; the other operands and the forces bf16
int force_readout_bf16_fwd(const bf16* e, const float* x_hat, const bf16* w1,
                           const bf16* b1, const bf16* w2, const bf16* b2,
                           const int* offs, bf16* out, int n_rows, int dim,
                           int grid, int t_min, int tm, int smem,
                           void* stream) {
  if (n_rows == 0) return 0;
  const ForceArgs<bf16> a{e,   x_hat, nullptr, w1,  b1,     w2,
                          b2,  offs,  out,     nullptr, n_rows, t_min};
  return dispatch_force<false>(a, dim, grid, tm, smem, stream);
}

}  // extern "C"
