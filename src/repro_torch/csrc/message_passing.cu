// Message-passing kernels of the FastCHGNet forward, for Hopper (sm_90a).
//
// One kernel per TPU megakernel of the serving and training paths:
//
//   atom_conv_fwd      replaces _atom_conv_kernel
//                      (src/repro/kernels/fused_message_passing.py:252),
//                      with its mirror operands (pair, und)
//   bond_conv_fwd      replaces _bond_conv_kernel (same file, :488), with
//                      its mirror operands (pij, pik)
//   sym_msg_fwd        replaces _sym_msg_kernel (same file, :1002), phase A
//                      of the symmetric bond conv; phase B, _sym_accum_kernel
//                      (:1112), is sym_accum_fwd in segment_sum.cu
//   force_readout_fwd  replaces _force_kernel (same file, :737), virial=False
//   force_virial_fwd + virial_crystal_sum
//                      replace _force_virial_kernel (same file, :758),
//                      virial=True: two launches, the second a small
//                      ordered per-crystal sum of the first's row partials
//
// Their backward passes are not kernels: kernels/ops.py recomputes the
// messages chunk by chunk in PyTorch, as the JAX package's custom VJPs do.
//
// What each computes is in the comment above its kernel.  Shared rules,
// the semantics the TPU kernels define (DESIGN.md §1-§3):
//   - rows are destination-sorted CSR segments; every destination row is
//     owned by exactly one block, which walks the edge range
//     [offs[r0], offs[r1]) of its rows.  Every walk is bounded by the CSR
//     offsets, never by a segment id, so the padded tail past offs[-1]
//     (whose ids alias row 0) is never read;
//   - no atomics: one thread per output column adds the edges of a row in
//     CSR order, so the result is the same from run to run;
//   - f32 throughout: products are f32 FMAs on the CUDA cores (no TF32),
//     LayerNorm statistics are f32, population variance over the real D
//     lanes of each half, eps 1e-5.
//
// TPU mechanics that are not carried over: the one-hot MXU gathers
// (_window_onehot, _gather_rows) become plain indexed loads; lanes are not
// padded to 128 (the kernels work at the real width D and x_hat is (E, 3));
// the chunk-aligned walk and the VMEM/HBM residency tiers collapse into
// one lowering with every table in device memory (reused rows hit L2).
//
// Bound on this card: at FAST_FUSED (D = 64, about 65 bonds and 56 angles
// per atom) the two convs do 2*E*d_in*2D flops on E*(d_in + D)*4 bytes of
// gathered rows, about 21 flops per byte, so they sit on the f32 CUDA-core
// side of the H100's roofline (67 TFLOP/s f32 against 3.35 TB/s): they are
// bound by operations.  The design therefore keeps the inner loop on FMAs:
// a tile of TE edges is gathered once into shared memory, each thread owns
// one of the 2D GEMM output columns and keeps TE accumulators in registers,
// reads the x rows as float4 broadcasts from shared memory and each weight
// once per tile from L2 (W is 96-128 KB and shared by every block, so it
// stays L2-resident).  The force readout does 2*E*D*D flops on E*(D+3)*4
// bytes, about 31 flops per byte, and is operation-bound the same way; its
// virial epilogue adds ~20 flops and 4 bytes (dist) per bond, and the
// crystal sum reads the (A, 9) row partials once.
// sym_msg_fwd is the same GEMM with K = 3D (the two e slots of the bond
// MLP read the same swap-symmetric row, so the wrapper adds their weight
// blocks once per call) over the real dedup-angle rows only: at batch 128
// about 2 GFLOP, also bound by operations.
// Making them fast (wgmma on TF32-free f32 splits, TMA) is later work; this
// is the simple, right version.

#include <cuda_runtime.h>

namespace {

constexpr int TE = 32;          // edges per tile
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Ordered CSR accumulation of one tile: thread `col` (< D) adds the tile's
// messages msg[t * D + col] to the row that owns edge base + t, flushing a
// finished row before moving on.  `row`, `row_end` and `acc` carry over
// between tiles.
__device__ __forceinline__ void accumulate_tile(
    const float* msg, int n_e, int base, int col, int D,
    const int* __restrict__ offs, float* __restrict__ out, int& row,
    int& row_end, float& acc) {
  for (int t = 0; t < n_e; ++t) {
    const int g = base + t;
    while (g >= row_end) {
      out[(size_t)row * D + col] = acc;
      acc = 0.0f;
      ++row;
      row_end = offs[row + 1];
    }
    acc += msg[t * D + col];
  }
}

enum ConvMode { ATOM = 0, BOND = 1, SYM = 2 };

// MODE = ATOM: atom_conv_fwd, Eq. 4 message path.  Per atom row i, over
// the bonds b in [offs[i], offs[i+1]) in order:
//   out[i] = sum_b e_a[b'] * silu(LN(y_c)) * sigmoid(LN(y_g)),
//   y = [v[center[b]] | v[nbr[b]] | e[b"]] @ W + bias,  y = [y_c | y_g],
// with W (3D, 2D) packed [Wc | Wg], applied as x @ W.  The directed store
// reads b' = b" = b.  The undirected store (MIRROR, DESIGN.md §5) keeps
// e_a as an (Eu, D) table read at b' = pair[b]; the symmetric trunk (UND,
// §10) keeps e as one too, read at b" = pair[b].
//
// MODE = BOND: bond_conv_fwd, Eq. 5 message path.  Per bond row j, over
// the angles n in [offs[j], offs[j+1]) in order:
//   out[j] = sum_n phi([v[ctr[n]] | e[ij[n]] | e[ik[n]] | a[n]])
//                  * e_b[p1[n]] * e_b[p2[n]],
// with ctr = bond_center[angle_ij] from the caller and W (4D, 2D).  The
// envelope rows p1/p2 are ij/ik on the directed store and pair[ij] /
// pair[ik] of the (Eu, D) table on the undirected one (composed by the
// caller).
//
// MODE = SYM: sym_msg_fwd, phase A of the symmetric bond conv (§10).  No
// reduction: per real dedup-angle row g,
//   out[g] = phi([v[ctr[g]] | e[du1[g]] + e[du2[g]] | a_u[g]])
//            * e_b[du1[g]] * e_b[du2[g]],
// with W (3D, 2D) = [W1 | W2 + W3 | W4] from the caller.  The real rows
// are the prefix [0, offs[n_rows] / 2) (each owns two incidences of the
// (Eu + 1,) offsets); a block past it exits, so the count is read on the
// device and rows past it are left unwritten.
//
// Arguments: id0/id1/id2 are (center, nbr, -) for the atom conv, (ctr, ij,
// ik) for the bond conv and (ctr, du1, du2) for phase A; env is e_a, e_b or
// e_b; p1 is pair (atom conv) or the first envelope row (bond conv), p2 the
// second envelope row.
template <int MODE, bool MIRROR, bool UND>
__global__ void conv_fwd_kernel(
    const float* __restrict__ v, const float* __restrict__ e,
    const float* __restrict__ a, const float* __restrict__ env,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ lns, const float* __restrict__ lnb,
    const int* __restrict__ id0, const int* __restrict__ id1,
    const int* __restrict__ id2, const int* __restrict__ p1,
    const int* __restrict__ p2, const int* __restrict__ offs,
    float* __restrict__ out, int n_rows, int D, int rows_per_block) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d_in = (MODE == BOND ? 4 : 3) * D;
  const int n2 = 2 * D;
  float* xs = smem;              // (TE, d_in) gathered rows; then (TE, D) msgs
  float* ys = smem + TE * d_in;  // (TE, 2D) GEMM rows, normalized in place

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  int r0 = 0, r1 = 0, start, end;
  if (MODE == SYM) {
    start = blockIdx.x * rows_per_block;
    end = min(start + rows_per_block, offs[n_rows] >> 1);
  } else {
    r0 = blockIdx.x * rows_per_block;
    r1 = min(r0 + rows_per_block, n_rows);
    start = offs[r0];
    end = offs[r1];
  }

  int row = r0;
  int row_end = MODE == SYM ? 0 : offs[r0 + 1];
  float acc = 0.0f;

  for (int base = start; base < end; base += TE) {
    const int n_e = min(TE, end - base);

    // 1. gather the x rows of this tile (zeros past the range)
    for (int idx = tid; idx < TE * d_in; idx += blockDim.x) {
      const int t = idx / d_in;
      const int k = idx - t * d_in;
      float val = 0.0f;
      if (t < n_e) {
        const int g = base + t;
        const int part = k / D;
        const int kk = k - part * D;
        if (MODE == BOND) {
          const float* src = part == 0 ? v + (size_t)id0[g] * D
                           : part == 1 ? e + (size_t)id1[g] * D
                           : part == 2 ? e + (size_t)id2[g] * D
                                       : a + (size_t)g * D;
          val = src[kk];
        } else if (MODE == SYM) {
          val = part == 0 ? v[(size_t)id0[g] * D + kk]
              : part == 1 ? e[(size_t)id1[g] * D + kk]
                                + e[(size_t)id2[g] * D + kk]
                          : a[(size_t)g * D + kk];
        } else {
          const float* src = part == 0 ? v + (size_t)id0[g] * D
                           : part == 1 ? v + (size_t)id1[g] * D
                                       : e + (size_t)(UND ? p1[g] : g) * D;
          val = src[kk];
        }
      }
      xs[idx] = val;
    }
    __syncthreads();

    // 2. y = x @ W + bias; thread c owns output column c
    const int c = tid;
    if (c < n2) {
      float yc[TE];
#pragma unroll
      for (int t = 0; t < TE; ++t) yc[t] = 0.0f;
      for (int k = 0; k < d_in; k += 4) {
        const float w0 = __ldg(w + (size_t)(k + 0) * n2 + c);
        const float w1 = __ldg(w + (size_t)(k + 1) * n2 + c);
        const float w2 = __ldg(w + (size_t)(k + 2) * n2 + c);
        const float w3 = __ldg(w + (size_t)(k + 3) * n2 + c);
#pragma unroll
        for (int t = 0; t < TE; ++t) {
          const float4 x4 = *reinterpret_cast<const float4*>(xs + t * d_in + k);
          yc[t] = fmaf(x4.x, w0, yc[t]);
          yc[t] = fmaf(x4.y, w1, yc[t]);
          yc[t] = fmaf(x4.z, w2, yc[t]);
          yc[t] = fmaf(x4.w, w3, yc[t]);
        }
      }
      const float bc = bias[c];
#pragma unroll
      for (int t = 0; t < TE; ++t) ys[t * n2 + c] = yc[t] + bc;
    }
    __syncthreads();

    // 3. LayerNorm of each (edge, half), one warp per pair
    for (int p = warp; p < 2 * n_e; p += nwarps) {
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

    // 4. gating and envelope: msg = silu(core) * sigmoid(gate) * env; phase
    // A stores each row, the convs keep the tile for step 5
    float* msg = xs;
    for (int idx = tid; idx < n_e * D; idx += blockDim.x) {
      const int t = idx / D;
      const int j = idx - t * D;
      const int g = base + t;
      const float core = ys[t * n2 + j];
      const float gate = ys[t * n2 + D + j];
      float m = (core * sigmoid_f(core)) * sigmoid_f(gate);
      if (MODE == BOND) {
        m = m * env[(size_t)p1[g] * D + j] * env[(size_t)p2[g] * D + j];
      } else if (MODE == SYM) {
        m = m * env[(size_t)id1[g] * D + j] * env[(size_t)id2[g] * D + j];
        out[(size_t)g * D + j] = m;
      } else {
        m = m * env[(size_t)(MIRROR ? p1[g] : g) * D + j];
      }
      msg[idx] = m;
    }
    __syncthreads();

    // 5. ordered reduction into the destination rows
    if (MODE != SYM && tid < D)
      accumulate_tile(msg, n_e, base, tid, D, offs, out, row, row_end, acc);
    __syncthreads();
  }
  if (MODE != SYM && tid < D) {
    for (; row < r1; ++row) {
      out[(size_t)row * D + tid] = acc;
      acc = 0.0f;
    }
  }
}

// force_readout_fwd (VIRIAL = false), Eq. 7.  Per atom row i, over the
// bonds b in [offs[i], offs[i+1]) in order:
//   out[i] = sum_b n_b * x_hat[b],   n_b = w2 . silu(e[b] @ W1 + b1) + b2.
// W1 is (D, D), w2 (D, 1), x_hat (E, 3), out (A, 3).
//
// force_virial_fwd (VIRIAL = true) adds the §7 virial epilogue: while n_b
// and x_hat[b] are in shared memory, the same ordered walk also sums
//   vir[i] = sum_b (n_b * dist[b]) * (x_hat[b] ⊗ x_hat[b])     (A, 9),
// the row's share of the per-crystal partials that virial_crystal_sum
// adds up.  Threads 0-2 reduce the force columns and threads 32-40 the
// nine virial columns, each in CSR order.
template <bool VIRIAL>
__global__ void force_readout_kernel(
    const float* __restrict__ e, const float* __restrict__ xhat,
    const float* __restrict__ dist,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const int* __restrict__ offs, float* __restrict__ out,
    float* __restrict__ vir, int n_rows, int D, int rows_per_block) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* es = smem;              // (TE, D) bond features of the tile
  float* hs = smem + TE * D;     // (TE, D) hidden layer
  float* ns = hs + TE * D;       // (TE * 3) contributions n_b * x_hat[b]
  float* vs = ns + TE * 3;       // (TE * 9) virial contributions (VIRIAL)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, n_rows);
  const int start = offs[r0], end = offs[r1];
  const bool f_col = tid < 3;
  const bool v_col = VIRIAL && tid >= 32 && tid < 41;

  int row = r0;
  int row_end = offs[r0 + 1];
  float acc = 0.0f;

  for (int base = start; base < end; base += TE) {
    const int n_e = min(TE, end - base);
    for (int idx = tid; idx < TE * D; idx += blockDim.x) {
      const int t = idx / D;
      es[idx] = t < n_e ? e[(size_t)base * D + idx] : 0.0f;
    }
    __syncthreads();

    const int c = tid;
    if (c < D) {
      float hc[TE];
#pragma unroll
      for (int t = 0; t < TE; ++t) hc[t] = 0.0f;
      for (int k = 0; k < D; ++k) {
        const float wk = __ldg(w1 + (size_t)k * D + c);
#pragma unroll
        for (int t = 0; t < TE; ++t) hc[t] = fmaf(es[t * D + k], wk, hc[t]);
      }
      const float bc = b1[c];
#pragma unroll
      for (int t = 0; t < TE; ++t) {
        const float x = hc[t] + bc;
        hs[t * D + c] = x * sigmoid_f(x);
      }
    }
    __syncthreads();

    // n_b = w2 . h_b + b2, one warp per bond
    for (int t = warp; t < n_e; t += nwarps) {
      float s = 0.0f;
      for (int j = lane; j < D; j += 32) s += hs[t * D + j] * w2[j];
      s = warp_sum(s) + b2[0];
      const size_t g = (size_t)(base + t) * 3;
      if (lane < 3) ns[t * 3 + lane] = s * xhat[g + lane];
      if (VIRIAL && lane < 9) {
        const int m = lane / 3, n = lane - 3 * m;
        const float wv = s * dist[base + t];
        vs[t * 9 + lane] = wv * (xhat[g + m] * xhat[g + n]);
      }
    }
    __syncthreads();

    if (f_col) accumulate_tile(ns, n_e, base, tid, 3, offs, out, row,
                               row_end, acc);
    if (v_col) accumulate_tile(vs, n_e, base, tid - 32, 9, offs, vir, row,
                               row_end, acc);
    __syncthreads();
  }
  if (f_col || v_col) {
    float* dst = f_col ? out : vir;
    const int width = f_col ? 3 : 9;
    const int col = f_col ? tid : tid - 32;
    for (; row < r1; ++row) {
      dst[(size_t)row * width + col] = acc;
      acc = 0.0f;
    }
  }
}

// virial_crystal_sum: raw[c] = sum of vir[r] over the atom rows r of
// crystal c.  A row belongs to the crystal of its first bond,
// cry[offs[r]] (every bond of a row lies in its center atom's crystal, as
// the packer lays batches out); a row without bonds, every padded row
// among them, adds nothing, so the padded tail past offs[-1] is never
// read.  One warp per crystal: lane l takes rows l, l + 32, ... in order,
// then a butterfly sum, so the order is the same from run to run; a
// crystal slot with no rows gets zeros.  It takes the place of the TPU
// kernel's (Bp, 3*128) accumulator carried across its sequential grid.
__global__ void virial_crystal_sum_kernel(
    const float* __restrict__ vir, const int* __restrict__ cry,
    const int* __restrict__ offs, float* __restrict__ raw, int n_rows) {
  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.0f;
  for (int r = lane; r < n_rows; r += 32) {
    const int s = offs[r];
    if (s < offs[r + 1] && cry[s] == c) {
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k] += vir[(size_t)r * 9 + k];
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) raw[(size_t)c * 9 + k] = acc[k];
  }
}

int round_up_warp(int n) { return ((n + 31) / 32) * 32; }

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int MODE, bool MIRROR, bool UND>
int launch_conv(const float* v, const float* e, const float* a,
                const float* env, const float* w, const float* b,
                const float* lns, const float* lnb, const int* id0,
                const int* id1, const int* id2, const int* p1, const int* p2,
                const int* offs, float* out, int n_rows, int dim,
                int rows_per_block, int grid, void* stream) {
  const int d_in = (MODE == BOND ? 4 : 3) * dim;
  const size_t smem = sizeof(float) * TE * (d_in + 2 * dim);
  cudaError_t err = set_smem(conv_fwd_kernel<MODE, MIRROR, UND>, smem);
  if (err != cudaSuccess) return (int)err;
  conv_fwd_kernel<MODE, MIRROR, UND><<<grid, round_up_warp(2 * dim), smem,
                                       (cudaStream_t)stream>>>(
      v, e, a, env, w, b, lns, lnb, id0, id1, id2, p1, p2, offs, out, n_rows,
      dim, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The caller checks shapes, dtypes (f32 / int32), contiguity and D % 4 == 0.

// pair == nullptr: the directed store; else e_a is an (Eu, D) table read
// through pair, and with und != 0 e is one too.
int atom_conv_fwd(const float* v, const float* e, const float* e_a,
                  const float* w, const float* b, const float* ln_scale,
                  const float* ln_bias, const int* center, const int* nbr,
                  const int* pair, const int* offs, float* out, int n_rows,
                  int dim, int rows_per_block, int und, void* stream) {
  if (n_rows == 0) return 0;
  const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
  if (pair == nullptr)
    return launch_conv<ATOM, false, false>(
        v, e, nullptr, e_a, w, b, ln_scale, ln_bias, center, nbr, nullptr,
        nullptr, nullptr, offs, out, n_rows, dim, rows_per_block, grid,
        stream);
  if (!und)
    return launch_conv<ATOM, true, false>(
        v, e, nullptr, e_a, w, b, ln_scale, ln_bias, center, nbr, nullptr,
        pair, nullptr, offs, out, n_rows, dim, rows_per_block, grid, stream);
  return launch_conv<ATOM, true, true>(
      v, e, nullptr, e_a, w, b, ln_scale, ln_bias, center, nbr, nullptr,
      pair, nullptr, offs, out, n_rows, dim, rows_per_block, grid, stream);
}

// env_ij / env_ik: the rows of e_b for each angle, angle_ij / angle_ik on
// the directed store, pair[angle_ij] / pair[angle_ik] on the undirected one.
int bond_conv_fwd(const float* v, const float* e, const float* a,
                  const float* e_b, const float* w, const float* b,
                  const float* ln_scale, const float* ln_bias,
                  const int* angle_ij, const int* angle_ik,
                  const int* center_ids, const int* env_ij,
                  const int* env_ik, const int* offs, float* out, int n_rows,
                  int dim, int rows_per_block, void* stream) {
  if (n_rows == 0) return 0;
  const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
  return launch_conv<BOND, false, false>(
      v, e, a, e_b, w, b, ln_scale, ln_bias, center_ids, angle_ij, angle_ik,
      env_ij, env_ik, offs, out, n_rows, dim, rows_per_block, grid, stream);
}

// Phase A of the symmetric bond conv: messages (n_au, D) of the real dedup
// rows [0, offs[n_eu] / 2); w23 is (3D, 2D) = [W1 | W2 + W3 | W4].
int sym_msg_fwd(const float* v, const float* e, const float* a_u,
                const float* e_b, const float* w23, const float* b,
                const float* ln_scale, const float* ln_bias, const int* ctr,
                const int* du1, const int* du2, const int* offs, float* out,
                int n_eu, int n_au, int dim, int rows_per_block,
                void* stream) {
  if (n_au == 0) return 0;
  const int grid = (n_au + rows_per_block - 1) / rows_per_block;
  return launch_conv<SYM, false, false>(
      v, e, a_u, e_b, w23, b, ln_scale, ln_bias, ctr, du1, du2, nullptr,
      nullptr, offs, out, n_eu, dim, rows_per_block, grid, stream);
}

int force_readout_fwd(const float* e, const float* x_hat, const float* w1,
                      const float* b1, const float* w2, const float* b2,
                      const int* offs, float* out, int n_rows, int dim,
                      int rows_per_block, void* stream) {
  if (n_rows == 0) return 0;
  const size_t smem = sizeof(float) * TE * (2 * dim + 3);
  cudaError_t err = set_smem(force_readout_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
  force_readout_kernel<false><<<grid, round_up_warp(dim), smem,
                                (cudaStream_t)stream>>>(
      e, x_hat, nullptr, w1, b1, w2, b2, offs, out, nullptr, n_rows, dim,
      rows_per_block);
  return (int)cudaGetLastError();
}

// Forces (A, 3) and the per-row virial partials vir (A, 9); the caller
// then sums vir per crystal with virial_crystal_sum.
int force_virial_fwd(const float* e, const float* x_hat, const float* dist,
                     const float* w1, const float* b1, const float* w2,
                     const float* b2, const int* offs, float* out,
                     float* vir, int n_rows, int dim, int rows_per_block,
                     void* stream) {
  if (n_rows == 0) return 0;
  const size_t smem = sizeof(float) * TE * (2 * dim + 3 + 9);
  cudaError_t err = set_smem(force_readout_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + rows_per_block - 1) / rows_per_block;
  // at least two warps: threads 32-40 reduce the virial columns
  const int threads = round_up_warp(dim) < 64 ? 64 : round_up_warp(dim);
  force_readout_kernel<true><<<grid, threads, smem, (cudaStream_t)stream>>>(
      e, x_hat, dist, w1, b1, w2, b2, offs, out, vir, n_rows, dim,
      rows_per_block);
  return (int)cudaGetLastError();
}

// raw (B, 9) from the per-row partials of force_virial_fwd.
int virial_crystal_sum(const float* vir, const int* cry, const int* offs,
                       float* raw, int n_rows, int n_crystals, void* stream) {
  if (n_crystals == 0) return 0;
  virial_crystal_sum_kernel<<<n_crystals, 32, 0, (cudaStream_t)stream>>>(
      vir, cry, offs, raw, n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
