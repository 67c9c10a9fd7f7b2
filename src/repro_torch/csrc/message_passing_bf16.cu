// The bf16 entries of the message-passing kernels (DESIGN.md §4, the
// mixed tiers): kernels 2, 3, 5, 4a and 4b with bf16 operands, the
// templates of message_passing.cuh instantiated at T = bf16, in a library
// of their own so that they compile beside the f32 ones.  Kernel 4b's
// crystal sum (virial_crystal_sum) reads f32 row partials in either tier
// and is the f32 library's.

#include "message_passing.cuh"

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The caller checks shapes, dtypes (bf16 features, int32 ids; x_hat and
// dist f32),
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

// Phase A of the symmetric bond conv on bf16 operands: f32 messages out
// (n_au, D); w23 (3D, 2D) = [W1 | W2 + W3 | W4], the e blocks added in
// bf16 by the caller.
int sym_msg_bf16_fwd(const bf16* v, const bf16* e, const bf16* a_u,
                     const bf16* e_b, const bf16* w23, const bf16* b,
                     const bf16* ln_scale, const bf16* ln_bias,
                     const int* ctr, const int* du1, const int* du2,
                     const int* offs, float* out, int n_eu, int n_au,
                     int dim, int grid, int tm, int smem, void* stream) {
  return sym_msg<bf16>(v, e, a_u, e_b, w23, b, ln_scale, ln_bias, ctr, du1,
                       du2, offs, out, n_eu, n_au, dim, grid, tm, smem,
                       stream);
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

// Forces (A, 3) bf16 and the per-row virial partials vir (A, 9) f32, from
// f32 x_hat and dist; virial_crystal_sum (the f32 library) then sums vir
// per crystal.
int force_virial_bf16_fwd(const bf16* e, const float* x_hat,
                          const float* dist, const bf16* w1, const bf16* b1,
                          const bf16* w2, const bf16* b2, const int* offs,
                          bf16* out, float* vir, int n_rows, int dim,
                          int grid, int t_min, int tm, int smem,
                          void* stream) {
  if (n_rows == 0) return 0;
  const ForceArgs<bf16> a{e, x_hat, dist, w1, b1, w2, b2, offs, out, vir,
                          n_rows, t_min};
  return dispatch_force<true>(a, dim, grid, tm, smem, stream);
}

}  // extern "C"
