// Message-passing kernels of the FastCHGNet forward, for Hopper (sm_90a):
// the templates and their launchers.  message_passing.cu instantiates the
// f32 (split-f32) kernels and defines their entries and the crystal sum;
// message_passing_bf16.cu the bf16 kernels of 2, 3 and 4a and theirs.
// The two compile apart, in parallel (kernels/build.py).
//
// One kernel per TPU megakernel of the serving and training paths:
//
//   atom_conv_fwd      replaces _atom_conv_kernel
//                      (src/repro/kernels/fused_message_passing.py:252),
//                      with its mirror operands (pair, und)
//   bond_conv_fwd      replaces _bond_conv_kernel (same file, :488), with
//                      its mirror operands (pij, pik)
//   sym_msg_fwd        replaces the body of fused_sym_msg_pallas (same
//                      file, :1002), phase A of the symmetric bond conv;
//                      phase B, _sym_accum_kernel (:1112), is sym_accum_fwd
//                      in segment_sum.cu
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
//     owned by exactly one block, which walks the edge range of its rows.
//     Every walk is bounded by the CSR offsets, never by a segment id, so
//     the padded tail past offs[-1] (whose ids alias row 0) is never read;
//   - no atomics: each output element is a sum in CSR edge order, so the
//     result is the same from run to run;
//   - f32 results: LayerNorm statistics are f32, population variance over
//     the real D lanes of each half, eps 1e-5.
//
// TPU mechanics that are not carried over: the one-hot MXU gathers
// (_window_onehot, _gather_rows) become indexed loads; lanes are not
// padded to 128 (the kernels work at the real width D and x_hat is (E, 3));
// the chunk-aligned walk and the VMEM/HBM residency tiers collapse into
// one lowering with every table in device memory (reused rows hit L2).
//
// One design for every kernel here: the GEMM runs on the tensor cores in
// split f32 (3xTF32 mma.sync m16n8k8, hopper.cuh), rows gathered with
// 16-byte cp.async a stage ahead of the products, the epilogue on the
// accumulators.  At FAST_FUSED (D = 64, batch 128) the bond conv does
// 2 E d_in 2D = 5.3 GFLOP over 81k angles and writes a 101 MB (E_cap, D)
// output; as f32 FMAs that is 0.080 ms at 67 TFLOP/s, as three TF32
// products 0.032 ms at 495 TFLOP/s, below the 0.052 ms its bytes take at
// 3.35 TB/s.  The atom conv does 4.8 GFLOP on ~53 MB: 0.029 ms split,
// bound by operations.  The symmetric trunk's phase A does 2.0 GFLOP over
// 40.6k dedup rows on 46.6 MB (0.012 ms split, 0.014 ms in bytes); the
// force readout 0.81 GFLOP on 26.1 MB (0.005 ms split, 0.008 ms in
// bytes).  The three reducing kernels (the convs, the force readouts):
//  - work is balanced by edges: block c of a persistent grid owns the
//    non-empty rows r with offs[r] in [c T, (c+1) T), T = max(t_min,
//    ceil(offs[n_rows] / grid)) read on the device, found with two
//    warp-wide 32-ary searches on offs.  A row stays whole in the block
//    where it starts, however long; the empty rows (bonds with no angle,
//    the padded capacity tail: 297k of the bond conv's 394k rows at batch
//    128) are zeroed by a grid-stride pass that all blocks share;
//  - a block walks its edge range in tiles of TM edges (the convs 128, 64
//    at D = 128; the force readouts 64), staged with cp.async and
//    double-buffered against the products of the previous stage;
//  - a warp owns 32 or 16 rows by all output columns in registers; the
//    epilogue runs on the accumulators, and the tile's per-edge results go
//    to shared memory for the reduction only;
//  - the reduction is ordered and parallel across rows (tile_run_sums):
//    the tile's row starts are marked from offs, compacted into runs, and
//    each run is summed in edge order by W / 4 threads (a float4 of
//    columns each); a row that continues past the tile carries its partial
//    sum, through shared memory, into the next tile's first run.
// Phase A of the symmetric conv (MODE SYM of the conv template) has no
// reduction: its persistent blocks stride over 64-row tiles of the real
// prefix and store each message row from the accumulators.
// Fragment order as in gated_mlp.cu: k = t / t + 4 of each 8-wide step are
// input columns 2t / 2t + 1; row strides of 8 mod 32 floats (x), 4 mod 32
// (W) and 8 mod 32 (messages) keep the fragment loads and stores free of
// bank conflicts.
//
// bf16 operands (DESIGN.md §4, precision "mixed" / "bf16"): the convs
// (kernels 2 and 3, with their mirror operands) and the force readout
// without the virial (kernel 4a) take a second operand type, T = bf16,
// in the same templates (entries atom_conv_bf16_fwd, bond_conv_bf16_fwd,
// force_readout_bf16_fwd).  What the JAX kernels do with bf16 operands
// (fused_message_passing.py _mm, _masked_ln, the wrappers' final cast):
// every product accumulates in f32, the LayerNorm statistics, the gate,
// the envelope product and the row sums are f32, and the result is
// rounded to bf16 once, when it is stored.  So the bf16 path stages bf16
// rows with the same 16-byte cp.async copies (8 columns each) and runs
// ONE mma.sync m16n8k16 bf16 product with f32 accumulators per 16 input
// columns in place of the three TF32 products per 8 (A fragments with
// ldmatrix, the convs' B fragments with ldmatrix.trans from W's k-major
// rows, the force readout's B fragments packed once a block); the
// partition, the epilogue on the accumulators, the f32 message tile and
// the ordered run sums are the f32 path's, and each output element is
// stored rounded to nearest.  Row strides of 16 mod 128 bytes keep
// ldmatrix free of bank conflicts.  At FAST_FUSED_MIXED (D = 64, batch
// 128) the bond conv's 5.3 GFLOP take 0.005 ms at 989 TFLOP/s, below the
// ~0.03 ms its bf16 bytes take (its (E_cap, D) bf16 output alone is 50
// MB): the bf16 convs and readout are bound by bytes.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float LN_EPS = 1e-5f;

template <typename T>
constexpr bool IS_BF16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// two consecutive operands as f32 (a bf16 pair widened exactly)
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// an f32 result stored in the operand type, rounded to nearest
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store4(float* p, float4 s) {
  *reinterpret_cast<float4*>(p) = s;
}
__device__ __forceinline__ void store4(bf16* p, float4 s) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// silu(c) sigmoid(g) = c / ((1 + e^-c) (1 + e^-g)), as in gated_mlp.cu: two
// fast exponentials and one fast reciprocal; a denominator that overflows
// gives 0, the limit
__device__ __forceinline__ float gated(float c, float g) {
  return __fdividef(c, (1.0f + __expf(-c)) * (1.0f + __expf(-g)));
}

__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

constexpr int CONV_WARPS = 4;
constexpr int CONV_THREADS = 32 * CONV_WARPS;
constexpr int KC = 32;          // input columns per stage
constexpr int STAGES = 2;

// The first index i in [0, hi] with offs[i] >= x, for nondecreasing offs
// (offs[hi] is never read: hi when no earlier entry is >= x).  A warp's 32
// lanes probe the last entry of 32 equal buckets a round, so ~400k rows
// take 3 rounds and a final probe.
__device__ int lower_bound_warp(const int* __restrict__ offs, int hi, int x,
                                int lane) {
  int lo = 0;  // the answer lies in [lo, hi]
  while (hi - lo >= 32) {
    const int step = (hi - lo + 31) / 32;
    const int q = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned ge = __ballot_sync(0xffffffffu, __ldg(offs + q) >= x);
    if (ge == 0) return hi;
    const int l = __ffs(ge) - 1;
    hi = min(lo + (l + 1) * step - 1, hi - 1);
    lo += l * step;
  }
  const int p = lo + lane;
  const unsigned ge =
      __ballot_sync(0xffffffffu, p >= hi || __ldg(offs + p) >= x);
  return min(lo + __ffs(ge) - 1, hi);
}

// The rows of an edge-balanced block, [scal[4], scal[5]): those whose
// first edge lies in [c0, c0 + T), found by warps 0 and 1.  The caller
// syncs before reading them.
__device__ __forceinline__ void block_rows(const int* __restrict__ offs,
                                           int n_rows, int c0, int T,
                                           int n_real, int* scal) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int x = warp == 0 ? c0 : min(c0 + T, n_real);
    const int r = lower_bound_warp(offs, n_rows, x, lane);
    if (lane == 0) scal[4 + warp] = r;
  }
}

// Marks the tile position where each of the tile's non-empty rows starts
// (starts[offs[r] - base] = r); rows are scanned from the one after the
// last tile's last row.  Every thread of the block calls it.
__device__ __forceinline__ void mark_starts(const int* __restrict__ offs,
                                            int scan_from, int r_hi,
                                            int base, int tile_end,
                                            int* starts) {
  const int tid = threadIdx.x;
  for (int r0 = scan_from;; r0 += CONV_THREADS) {
    const int r = r0 + tid;
    bool more = false;
    if (r < r_hi) {
      const int o = __ldg(offs + r);
      if (o < tile_end) {
        if (__ldg(offs + r + 1) > o) starts[o - base] = r;
        more = tid == CONV_THREADS - 1;
      }
    }
    if (!__syncthreads_or(more)) break;
  }
}

// The ordered row sums of one tile of TM edge positions: msg holds the
// tile's n_e per-edge rows of W floats (row stride ldm, W % 4 == 0),
// starts[] the marks of mark_starts.  The tile's runs are position 0 (the
// row carried from the last tile, or one that starts there) and every
// marked start, in order; each run is summed in edge order by W / 4
// threads and handed to store(row, column, float4).  The carry rows (2 W
// floats) alternate by tile, so the first run reads the last tile's while
// the last run writes this one's.  Every thread of the block calls it;
// it resets starts[] for the next tile.
template <int TM, int W, typename Store>
__device__ __forceinline__ void tile_run_sums(
    const float* msg, int ldm, int n_e, int tile_end, int tile, int* starts,
    int* run_pos, int* run_row, int* scal, float* carry, int& carry_row,
    int& scan_from, const int* __restrict__ offs, Store store) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int srow = -1;
  if (tid < TM) {
    srow = starts[tid];
    starts[tid] = -1;  // for the next tile's scan
  }
  const bool first = tid < n_e && (tid == 0 || srow >= 0);
  const unsigned ball = __ballot_sync(0xffffffffu, first);
  if (lane == 0) scal[warp] = __popc(ball);
  if (tid == 0) scal[6] = srow < 0;
  __syncthreads();  // the message tile and the warp counts
  int before = 0, n_runs = 0;
#pragma unroll
  for (int w2 = 0; w2 < CONV_WARPS; ++w2) {
    before += w2 < warp ? scal[w2] : 0;
    n_runs += scal[w2];
  }
  if (first) {
    const int k = before + __popc(ball & ((1u << lane) - 1u));
    run_pos[k] = tid;
    run_row[k] = tid == 0 && srow < 0 ? carry_row : srow;
  }
  __syncthreads();

  const bool carry_in = scal[6];
  const int last_row = run_row[n_runs - 1];
  const bool carry_out = __ldg(offs + last_row + 1) > tile_end;
  const float* carry_rd = carry + ((tile + 1) & 1) * W;
  float* carry_wr = carry + (tile & 1) * W;
  constexpr int G4 = W / 4, NGRP = CONV_THREADS / G4;
  const int c4 = (tid % G4) * 4;
  for (int k = tid / G4; k < n_runs && tid < NGRP * G4; k += NGRP) {
    const int t1 = k + 1 < n_runs ? run_pos[k + 1] : n_e;
    float4 s4 = k == 0 && carry_in
                    ? *reinterpret_cast<const float4*>(carry_rd + c4)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int t = run_pos[k]; t < t1; ++t) {
      const float4 m = *reinterpret_cast<const float4*>(msg + t * ldm + c4);
      s4.x += m.x;
      s4.y += m.y;
      s4.z += m.z;
      s4.w += m.w;
    }
    if (k == n_runs - 1 && carry_out)
      *reinterpret_cast<float4*>(carry_wr + c4) = s4;
    else
      store(run_row[k], c4, s4);
  }
  carry_row = carry_out ? last_row : -1;
  scan_from = last_row + 1;
}

// ---------------------------------------------------------------------------
// Kernels 2, 3 and 5: the split-f32 convs and the symmetric conv's phase A
// ---------------------------------------------------------------------------

enum ConvMode { ATOM = 0, BOND = 1, SYM = 2 };

// The launch geometry; kernels/ops.py conv_plan computes the same numbers
// and the launcher refuses a plan that differs.  T is the operand type:
// float (split f32) or bf16 (the convs only).
template <int MODE, int D, typename T = float>
struct ConvShape {
  static constexpr bool REDUCE = MODE != SYM;   // a CSR row sum follows
  static constexpr int NT = 2 * D / 8;          // n8 tiles of [core | gate]
  // m16 tiles per warp: two for the convs up to D = 64, one at D = 128
  // and for SYM (64-row tiles spread the real rows of a serving or
  // training batch over more SMs: see kernels/ops.py conv_plan; two
  // blocks a SM, as for the convs: three spill registers)
  static constexpr int RW = REDUCE && D <= 64 ? 2 : 1;
  static constexpr int TM = CONV_WARPS * 16 * RW;  // edges per tile
  // row strides in elements: x rows padded by 8 (32 bytes in f32, 16 in
  // bf16), W rows by 16 bytes
  static constexpr int LDX = KC + 8, LDW = 2 * D + 16 / (int)sizeof(T);
  static constexpr int LDM = D + 8;  // the f32 message tile
  static constexpr int STAGE = TM * LDX + KC * LDW;  // elements
  static constexpr int STAGE_BYTES = (int)sizeof(T) * STAGE;
  static constexpr int D_IN = (MODE == BOND ? 4 : 3) * D;  // rows of W
  // SYM's K chunks: the v and a parts KV columns a chunk, the e part KE
  // columns of e[du1] beside the same KE columns of e[du2] (added as the
  // A fragment is formed, so every chunk lies in one part)
  static constexpr int KV = D < KC ? D : KC, KE = D < 16 ? D : 16;
  static constexpr int CV = D / KV, CE = D / KE;
  static constexpr int NK = REDUCE ? (D_IN + KC - 1) / KC : 2 * CV + CE;
  // bytes: the stages; floats: for the convs the message tile and two
  // carry rows (D each); bias / ln_scale / ln_bias (2D each, widened to
  // f32); ints (the convs): row starts, run starts and run rows (TM
  // each), 8 scalars
  static constexpr int FLOATS = (REDUCE ? TM * LDM + 2 * D : 0) + 6 * D;
  static constexpr int INTS = REDUCE ? 3 * TM + 8 : 0;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES +
                                 sizeof(float) * FLOATS + sizeof(int) * INTS;
};

// The GEMM input of an edge is D-wide parts, each a row of a table: part
// p of edge g is tab_p[id_p[g]] (id_p == nullptr: row g).  The envelope
// factors are env[env0[g]] and, for the bond conv and SYM, env[env1[g]].
// Every float operand and the output are of type T.
template <typename T>
struct ConvArgs {
  const T* tab0;
  const T* tab1;
  const T* tab2;
  const T* tab3;
  const int* id0;
  const int* id1;
  const int* id2;
  const T* env;
  const int* env0;
  const int* env1;
  const T* w;
  const T* bias;
  const T* lns;
  const T* lnb;
  const int* offs;
  T* out;
  int n_rows;
  int n_out;  // SYM: rows of out
  int t_min;
};

__device__ __forceinline__ int row_of(const int* ids, int g) {
  return ids ? __ldg(ids + g) : g;
}

template <int D, typename T>
__device__ __forceinline__ const T* part_row(const ConvArgs<T>& a, int p,
                                             int g) {
  switch (p) {
    case 0:
      return a.tab0 + (size_t)row_of(a.id0, g) * D;
    case 1:
      return a.tab1 + (size_t)row_of(a.id1, g) * D;
    case 2:
      return a.tab2 + (size_t)row_of(a.id2, g) * D;
    default:
      return a.tab3 + (size_t)g * D;
  }
}

// MODE = ATOM: atom_conv_fwd, Eq. 4 message path.  Per atom row i, over
// the bonds b in [offs[i], offs[i+1]) in order:
//   out[i] = sum_b e_a[b'] * silu(LN(y_c)) * sigmoid(LN(y_g)),
//   y = [v[center[b]] | v[nbr[b]] | e[b"]] @ W + bias,  y = [y_c | y_g],
// with W (3D, 2D) packed [Wc | Wg], applied as x @ W.  The directed store
// reads b' = b" = b.  The undirected store (DESIGN.md §5) keeps e_a as an
// (Eu, D) table read at b' = pair[b]; the symmetric trunk (§10) keeps e as
// one too, read at b" = pair[b].
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
// A row with no edges, the padded ones among them, is 0.
//
// MODE = SYM: sym_msg_fwd, phase A of the symmetric bond conv (§10).  No
// reduction: per real dedup-angle row g,
//   out[g] = phi([v[ctr[g]] | e[du1[g]] + e[du2[g]] | a_u[g]])
//            * e_b[du1[g]] * e_b[du2[g]],
// with W (3D, 2D) = [W1 | W2 + W3 | W4] from the caller.  The real rows
// are the prefix [0, offs[n_eu] / 2) (each owns two incidences of the
// (Eu + 1,) offsets), counted on the device; rows past it are left
// unwritten.  e[du1] + e[du2] is added in f32 and then split, the plain
// version's order (sum, then product).
//
// T = bf16 (ATOM and BOND; atom_conv_bf16_fwd, bond_conv_bf16_fwd): the
// same sums with each 16 input columns one bf16 product into the f32
// accumulators, the bias and LayerNorm parameters widened to f32, the
// envelopes widened as they are read, and out rounded to bf16 as stored.
template <int MODE, int D, typename T>
__global__ void __launch_bounds__(CONV_THREADS, 2)
    conv_split_kernel(const __grid_constant__ ConvArgs<T> a) {
  using S = ConvShape<MODE, D, T>;
  constexpr bool BF = IS_BF16<T>;
  static_assert(!BF || S::REDUCE, "bf16 operands: the convs only");
  constexpr int NT = S::NT, RW = S::RW, TM = S::TM, NK = S::NK;
  constexpr int LDX = S::LDX, LDW = S::LDW, LDM = S::LDM, N2 = 2 * D;
  constexpr int D_IN = S::D_IN;
  constexpr int K_LAST = D_IN - (NK - 1) * KC;  // columns of the last chunk
  constexpr int KV = S::KV, KE = S::KE, CV = S::CV, CE = S::CE;
  // a 16-byte copy is SEG columns; SPR of them make a row of a chunk; a
  // pass of the block copies RPI tile rows, RPW of them a warp's
  constexpr int SEG = 16 / (int)sizeof(T), SPR = KC / SEG;
  constexpr int RPI = CONV_THREADS / SPR, RPW = 32 / SPR;
  extern __shared__ __align__(16) float smem[];
  T* const stages = reinterpret_cast<T*>(smem);
  // (TM, LDM) f32 message tile
  float* msg = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(
                   smem) + STAGES * S::STAGE_BYTES);
  float* prm = msg + (S::REDUCE ? TM * LDM : 0);  // bias, ln_scale, ln_bias
  float* carry = prm + 3 * N2;            // two rows, by tile parity
  int* starts = reinterpret_cast<int*>(carry + 2 * D);
  int* run_pos = starts + TM;
  int* run_row = run_pos + TM;
  int* scal = run_row + TM;  // warp counts [0, 4), r_lo, r_hi, carry-in

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n_rows = a.n_rows;
  // the convs: the real edges; SYM: the real rows
  const int n_real = S::REDUCE ? __ldg(a.offs + n_rows)
                               : min(__ldg(a.offs + n_rows) >> 1, a.n_out);
  const int T_ = max(a.t_min, (n_real + (int)gridDim.x - 1) / (int)gridDim.x);
  const int c0 = (int)blockIdx.x * T_;

  // the rows with no edges are zeros: a warp takes 32 rows at a time,
  // finds the empty ones with a ballot and stores them, 16 bytes a lane,
  // C16 lanes a row; a group's emptiness is read one group ahead.  SYM
  // has none.
  const int zstride = (int)gridDim.x * CONV_WARPS * 32;
  int zr = S::REDUCE ? ((int)blockIdx.x * CONV_WARPS + warp) * 32 : n_rows;
  bool zempty = zr + lane < n_rows &&
                __ldg(a.offs + zr + lane) == __ldg(a.offs + zr + lane + 1);
  auto zero_group = [&]() {
    if (zr >= n_rows) return;
    // lanes a row, rows a store
    constexpr int C16 = D * (int)sizeof(T) / 16, RPS = 32 / C16;
    uint4* out16 = reinterpret_cast<uint4*>(a.out);
    unsigned m = __ballot_sync(0xffffffffu, zempty);
    const int r0 = zr;
    zr += zstride;
    zempty = zr + lane < n_rows &&
             __ldg(a.offs + zr + lane) == __ldg(a.offs + zr + lane + 1);
    while (m) {
      unsigned mine = m;  // this lane's row: the (lane / C16)-th left
      for (int k = 0; k < lane / C16; ++k) mine &= mine - 1;
      if (mine)
        out16[(size_t)(r0 + __ffs(mine) - 1) * C16 + lane % C16] =
            make_uint4(0u, 0u, 0u, 0u);
      for (int k = 0; k < RPS; ++k) m &= m - 1;
    }
  };

  // the convs: this block's rows [r_lo, r_hi), those with offs in [c0, c0
  // + T), walked in consecutive tiles; SYM: tiles blockIdx.x, blockIdx.x +
  // gridDim.x, ... of the real rows
  const bool active =
      S::REDUCE ? c0 < n_real : (int)blockIdx.x * TM < n_real;
  if (active) {
    if (S::REDUCE) {
      block_rows(a.offs, n_rows, c0, T_, n_real, scal);
      for (int i = tid; i < TM; i += CONV_THREADS) starts[i] = -1;
    }
    for (int i = tid; i < N2; i += CONV_THREADS) {
      prm[i] = to_f32(a.bias[i]);
      prm[N2 + i] = to_f32(a.lns[i]);
      prm[2 * N2 + i] = to_f32(a.lnb[i]);
    }
    __syncthreads();
    const int r_hi = S::REDUCE ? scal[5] : 0;
    const int start = S::REDUCE ? __ldg(a.offs + scal[4]) : 0;
    const int end = S::REDUCE ? __ldg(a.offs + r_hi) : n_real;
    const int n_tiles = S::REDUCE
        ? (end - start + TM - 1) / TM
        : ((n_real + TM - 1) / TM - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
    const int total = n_tiles * NK;
    auto tile_base = [&](int k) {
      return S::REDUCE ? start + k * TM
                       : ((int)blockIdx.x + k * (int)gridDim.x) * TM;
    };
    int scan_from = S::REDUCE ? scal[4] : 0;  // the first row not yet seen
    int carry_row = -1;  // the row that continues into the next tile

    // A stage's x chunk: thread tid copies 16-byte segment tid % SPR of
    // tile rows tid / SPR + RPI it.  For D >= KC (and always for SYM) the
    // chunk lies in one part, and each lane holds the table row of one of
    // its warp's 32 rows (SYM's e chunks: both rows), fetched a stage
    // ahead (stage_rows) and handed round with shuffles: lane l holds row
    // RPW warp + l % RPW + RPI (l / RPW).  Narrower convs read each
    // segment's row id as they copy.
    auto stage_rows = [&](int s) {
      if ((S::REDUCE && D < KC) || s >= total) return make_int2(0, 0);
      const int base = tile_base(s / NK);
      const int rr = RPW * warp + lane % RPW + RPI * (lane / RPW);
      if (rr >= min(TM, end - base)) return make_int2(0, 0);
      const int kc = s % NK;
      if (S::REDUCE) {
        const int p = kc * KC / D;
        return make_int2(
            row_of(p == 0 ? a.id0 : p == 1 ? a.id1 : p == 2 ? a.id2
                                                          : nullptr,
                   base + rr),
            0);
      }
      if (kc < CV) return make_int2(__ldg(a.id0 + base + rr), 0);
      if (kc < CV + CE)
        return make_int2(__ldg(a.id1 + base + rr), __ldg(a.id2 + base + rr));
      return make_int2(base + rr, 0);
    };

    // stage s: chunk s % NK of tile s / NK.  Rows past the tile's edges
    // and columns past d_in are zeros (in x and in W, so no 0 x NaN)
    auto load_stage = [&](int s, int2 rows) {
      if (s < total) {
        const int base = tile_base(s / NK);
        const int n_e = min(TM, end - base);
        const int kc = s % NK;
        T* xs = stages + (s % STAGES) * S::STAGE;
        T* ws = xs + TM * LDX;
        if constexpr (S::REDUCE) {
          const int k0 = kc * KC;
#pragma unroll
          for (int it = 0; it < TM * SPR / CONV_THREADS; ++it) {
            const int i = tid + it * CONV_THREADS;
            const int r = i / SPR, c = (i % SPR) * SEG;
            const int k = k0 + c;
            const bool in = r < n_e && k < D_IN;
            const T* src = a.w;
            if (D >= KC) {
              const int row =
                  __shfl_sync(0xffffffffu, rows.x, lane / SPR + RPW * it);
              const int p = k0 / D;
              const T* tab = p == 0 ? a.tab0 : p == 1 ? a.tab1
                           : p == 2 ? a.tab2 : a.tab3;
              if (in) src = tab + (size_t)row * D + k % D;
            } else if (in) {
              src = part_row<D>(a, k / D, base + r) + k % D;
            }
            cp_async16(xs + r * LDX + c, src, in);
          }
          for (int i = tid; i < KC * N2 / SEG; i += CONV_THREADS) {
            const int r = i / (N2 / SEG), c = (i % (N2 / SEG)) * SEG;
            const bool in = k0 + r < D_IN;
            cp_async16(ws + r * LDW + c,
                       in ? a.w + (size_t)(k0 + r) * N2 + c : a.w, in);
          }
        } else {
          // v, e (pair) or a chunk: its table, first column, first W row
          // and width in effective (W) columns
          const bool pair = kc >= CV && kc < CV + CE;
          const float* tab = kc < CV ? a.tab0 : pair ? a.tab1 : a.tab3;
          const int col = kc < CV ? kc * KV : pair ? (kc - CV) * KE
                                                   : (kc - CV - CE) * KV;
          const int k0 = kc < CV ? col : pair ? D + col : 2 * D + col;
          const int kw = pair ? KE : KV;
          const int width = pair ? 2 * KE : KV;  // staged columns
#pragma unroll
          for (int it = 0; it < TM * SPR / CONV_THREADS; ++it) {
            const int i = tid + it * CONV_THREADS;
            const int r = i / SPR, c = (i % SPR) * SEG;
            const int l = lane / SPR + RPW * it;
            const int row1 = __shfl_sync(0xffffffffu, rows.x, l);
            const int row2 = __shfl_sync(0xffffffffu, rows.y, l);
            if (c < width) {
              const bool in = r < n_e;
              const bool second = c >= kw;  // pair: the e[du2] half
              const float* src =
                  in ? tab + (size_t)(second ? row2 : row1) * D + col +
                           (second ? c - kw : c)
                     : a.w;
              cp_async16(xs + r * LDX + c, src, in);
            }
          }
          for (int i = tid; i < kw * N2 / 4; i += CONV_THREADS) {
            const int r = i / (N2 / 4), c = (i % (N2 / 4)) * 4;
            cp_async16(ws + r * LDW + c, a.w + (size_t)(k0 + r) * N2 + c,
                       true);
          }
        }
      }
      // one group per stage, empty past the end, so the wait counts hold
      cp_async_commit();
    };

    load_stage(0, stage_rows(0));
    int2 next_rows = stage_rows(1);
    float acc[RW][NT][4];

    for (int s = 0; s < total; ++s) {
      cp_async_wait<0>();
      // stage s is visible to every warp, and every warp is done with
      // stage s - 1 and with the last tile's reduction
      __syncthreads();
      load_stage(s + 1, next_rows);
      next_rows = stage_rows(s + 2);  // in flight during the products
      if (S::REDUCE) zero_group();

      const int kc = s % NK, tile = s / NK;
      const int base = tile_base(tile);
      const int n_e = min(TM, end - base);
      const int tile_end = base + n_e;
      if (kc == 0) {
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.0f;
        if (S::REDUCE)
          mark_starts(a.offs, scan_from, r_hi, base, tile_end, starts);
      }

      const T* xs = stages + (s % STAGES) * S::STAGE;
      if constexpr (BF) {
        // one 16-wide step of K: the A fragments of the warp's m tiles
        // (ldmatrix), then the n tiles two at a time, their B fragments
        // from W's k-major rows (ldmatrix.trans), one bf16 product each
        const T* ws = xs + TM * LDX;
        auto k16_step = [&](int kk) {
          uint32_t af[RW][4];
#pragma unroll
          for (int r = 0; r < RW; ++r)
            ldmatrix_x4(af[r], xs + (warp * 16 * RW + 16 * r + (lane & 15)) *
                                        LDX + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int j2 = 0; j2 < NT / 2; ++j2) {
            uint32_t bf[4];
            ldmatrix_x4_trans(
                bf, ws + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDW +
                        j2 * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int r = 0; r < RW; ++r) {
              mma_bf16(acc[r][2 * j2], af[r], bf[0], bf[1]);
              mma_bf16(acc[r][2 * j2 + 1], af[r], bf[2], bf[3]);
            }
          }
        };
        if (kc < NK - 1 || K_LAST == KC) {
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk) k16_step(kk);
        } else {  // the last, partial chunk of d_in (zeros past it)
#pragma unroll
          for (int kk = 0; kk < (K_LAST + 15) / 16; ++kk) k16_step(kk);
        }
      } else {
        const float* xw = xs + (warp * 16 * RW + g) * LDX + 2 * tq;
        const float* ww = xs + TM * LDX + 2 * tq * LDW + g;
        // one 8-wide step of K, as in gated_mlp.cu: A fragments split
        // (SYM's e chunks: the two e rows added first), then the n tiles
        // in groups of up to 8, their B fragments split, then the three
        // passes of the split product
        auto k8_step = [&](int k8, bool pair) {
          uint32_t ah[RW][4], al[RW][4];
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const float* x0 = xw + 16 * r * LDX + k8 * 8;
            float2 top = *reinterpret_cast<const float2*>(x0);
            float2 bot = *reinterpret_cast<const float2*>(x0 + 8 * LDX);
            if (pair) {
              const float2 top2 = *reinterpret_cast<const float2*>(x0 + KE);
              const float2 bot2 =
                  *reinterpret_cast<const float2*>(x0 + 8 * LDX + KE);
              top.x += top2.x;
              top.y += top2.y;
              bot.x += bot2.x;
              bot.y += bot2.y;
            }
            const float xa[4] = {top.x, bot.x, top.y, bot.y};
            split_frag(xa, ah[r], al[r]);
          }
          constexpr int G = NT < 8 ? NT : 8;
#pragma unroll
          for (int j0 = 0; j0 < NT; j0 += G) {
            uint32_t bh[G][2], bl[G][2];
#pragma unroll
            for (int i = 0; i < G; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                split_tf32(ww[(k8 * 8 + e) * LDW + (j0 + i) * 8], bh[i][e],
                           bl[i][e]);
#pragma unroll
            for (int i = 0; i < G; ++i)
#pragma unroll
              for (int r = 0; r < RW; ++r)
                mma_tf32(acc[r][j0 + i], al[r], bh[i][0], bh[i][1]);
#pragma unroll
            for (int i = 0; i < G; ++i)
#pragma unroll
              for (int r = 0; r < RW; ++r)
                mma_tf32(acc[r][j0 + i], ah[r], bl[i][0], bl[i][1]);
#pragma unroll
            for (int i = 0; i < G; ++i)
#pragma unroll
              for (int r = 0; r < RW; ++r)
                mma_tf32(acc[r][j0 + i], ah[r], bh[i][0], bh[i][1]);
          }
        };
        if (S::REDUCE) {
          if (kc < NK - 1 || K_LAST == KC) {
#pragma unroll
            for (int k8 = 0; k8 < KC / 8; ++k8) k8_step(k8, false);
          } else {  // the last, partial chunk of d_in
#pragma unroll
            for (int k8 = 0; k8 < K_LAST / 8; ++k8) k8_step(k8, false);
          }
        } else if (kc >= CV && kc < CV + CE) {
#pragma unroll
          for (int k8 = 0; k8 < KE / 8; ++k8) k8_step(k8, true);
        } else {
#pragma unroll
          for (int k8 = 0; k8 < KV / 8; ++k8) k8_step(k8, false);
        }
      }
      if (kc != NK - 1) continue;

      // epilogue: bias, LayerNorm of each half, gate, envelope.  This thread
      // holds columns 8 j + 2 tq + e of tile rows g (i = 0) and g + 8 (i =
      // 1) of each m tile, in acc[r][j][2 i + e]; n tiles j < NT / 2 are the
      // core half, the others the gate half
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = warp * 16 * RW + 16 * r + 8 * i + g;
          const bool valid = t < n_e;
          const int ge = base + t;
          const T* env0 =
              a.env + (size_t)(valid ? row_of(a.env0, ge) : 0) * D + 2 * tq;
          const T* env1 =
              a.env + (size_t)(MODE != ATOM && valid ? __ldg(a.env1 + ge) : 0)
                          * D + 2 * tq;
          float sum[2] = {0.0f, 0.0f};
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc[r][j][2 * i + e] += prm[j * 8 + 2 * tq + e];
              sum[j / (NT / 2)] += acc[r][j][2 * i + e];
            }
          const float mu[2] = {quad_sum(sum[0]) / (float)D,
                               quad_sum(sum[1]) / (float)D};
          float sq[2] = {0.0f, 0.0f};
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dlt = acc[r][j][2 * i + e] - mu[j / (NT / 2)];
              sq[j / (NT / 2)] += dlt * dlt;
            }
          const float rstd[2] = {rsqrtf(quad_sum(sq[0]) / (float)D + LN_EPS),
                                 rsqrtf(quad_sum(sq[1]) / (float)D + LN_EPS)};
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) {
            float res[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = j * 8 + 2 * tq + e;
              const float core =
                  (acc[r][j][2 * i + e] - mu[0]) * rstd[0] * prm[N2 + c] +
                  prm[2 * N2 + c];
              const float gate = (acc[r][j + NT / 2][2 * i + e] - mu[1]) *
                                     rstd[1] * prm[N2 + D + c] +
                                 prm[2 * N2 + D + c];
              res[e] = gated(core, gate);
            }
            if (valid) {
              const float2 f = load2(env0 + j * 8);
              res[0] *= f.x;
              res[1] *= f.y;
              if (MODE != ATOM) {
                const float2 f2 = load2(env1 + j * 8);
                res[0] *= f2.x;
                res[1] *= f2.y;
              }
            }
            if constexpr (!S::REDUCE) {  // SYM: row ge of out, from registers
              if (valid)
                *reinterpret_cast<float2*>(a.out + (size_t)ge * D + j * 8 +
                                           2 * tq) =
                    make_float2(res[0], res[1]);
            } else {
              *reinterpret_cast<float2*>(msg + t * LDM + j * 8 + 2 * tq) =
                  make_float2(res[0], res[1]);
            }
          }
        }
      if constexpr (S::REDUCE) {
        tile_run_sums<TM, D>(
            msg, LDM, n_e, tile_end, tile, starts, run_pos, run_row, scal,
            carry, carry_row, scan_from, a.offs,
            [&](int row, int c4, float4 s4) {
              store4(a.out + (size_t)row * D + c4, s4);
            });
      }
    }
    cp_async_wait<0>();
  }
  if (S::REDUCE)
    while (zr < n_rows) zero_group();
}

// ---------------------------------------------------------------------------
// Kernel 4: the split-f32 force readout, with and without the virial
// ---------------------------------------------------------------------------

// force_readout_fwd (VIRIAL = false), Eq. 7.  Per atom row i, over the
// bonds b in [offs[i], offs[i+1]) in order:
//   out[i] = sum_b n_b * x_hat[b],   n_b = w2 . silu(e[b] @ W1 + b1) + b2.
// W1 is (D, D), w2 (D, 1), x_hat (E, 3), out (A, 3).
//
// force_virial_fwd (VIRIAL = true) adds the §7 virial epilogue: from the
// same n_b and x_hat[b] the same ordered run sums also give
//   vir[i] = sum_b (n_b * dist[b]) * (x_hat[b] ⊗ x_hat[b])     (A, 9),
// the row's share of the per-crystal partials that virial_crystal_sum
// adds up.  A row with no bonds gets zeros in both.
//
// Bound (D = 64, batch 128): 2 E D D = 0.81 GFLOP on 26.1 MB, 0.008 ms in
// bytes, 0.005 ms as three TF32 products.  The design: the convs' edge
// partition, tiles and ordered run sums (the bonds of a row are
// contiguous, so a tile's e rows are one contiguous block, copied with
// cp.async with x_hat and dist beside them); W1 is split into its TF32
// (hi, lo) parts once per block and kept in shared memory, a (hi, lo)
// pair of both k rows of a B fragment in one uint4, so a B fragment is
// one 16-byte load and no split; h and n_b come from the accumulators
// (silu, the product with w2 summed across the thread's n8 tiles, then a
// quad sum), and each bond's contributions [n x_hat | n d x_hat ⊗ x_hat]
// (W = 4 or 12 floats) overwrite its own row of the staged e tile for the
// run sums.
//
// T = bf16 (force_readout_bf16_fwd, VIRIAL = false): e, W1, b1, w2, b2
// and out are bf16, x_hat f32 (the wrapper widens it, exactly).  W1 is
// packed once a block as the bf16 B fragments of m16n8k16, both k pairs
// of a fragment in one uint2; the e rows (zero past D = 8 up to 16
// columns) give the A fragments through ldmatrix; one bf16 product per 16
// columns into the f32 accumulators; the forces are rounded to bf16 as
// they are stored.
template <int D, typename T = float>
struct ForceShape {
  // blocks a SM the registers are budgeted for (shared memory allows
  // three up to D = 64)
  static constexpr int BLOCKS = D <= 64 ? 3 : 2;
  static constexpr int NT = D / 8;
  static constexpr int TM = CONV_WARPS * 16;  // bonds per tile, m16 a warp
  // e row stride in elements: f32 8 mod 32 floats, bf16 16 mod 128 bytes
  static constexpr int LDX = (D < KC ? KC : D) + 8;
  static constexpr int KB = (D + 15) / 16;  // bf16: k16 steps
  // f32: uint4 stride of W1's k pairs; bf16: uint2 stride of the packed
  // fragments (8 mod 32, so a warp's 32 fragments are 256 distinct bytes)
  static constexpr int LDP = IS_BF16<T> ? (D + 31) / 32 * 32 + 8 : D + 2;
  static constexpr size_t W_BYTES = IS_BF16<T>
                                        ? 8 * (size_t)(4 * KB) * LDP
                                        : 16 * (size_t)(D / 2) * LDP;
  // e rows, then x_hat and dist (f32)
  static constexpr int STAGE_BYTES =
      (int)sizeof(T) * TM * LDX + (int)sizeof(float) * 4 * TM;
  // bytes: W1 (split or packed); the stages; b1, w2 (D each), b2 (padded
  // to 4); two carry rows of 12; ints: row starts, run starts and run
  // rows (TM each), 8 scalars
  static constexpr size_t SMEM =
      W_BYTES + (size_t)STAGES * STAGE_BYTES +
      sizeof(float) * (2 * D + 4 + 2 * 12) + sizeof(int) * (3 * TM + 8);
};

template <typename T>
struct ForceArgs {
  const T* e;
  const float* xhat;
  const float* dist;
  const T* w1;
  const T* b1;
  const T* w2;
  const T* b2;
  const int* offs;
  T* out;
  float* vir;
  int n_rows;
  int t_min;
};

template <bool VIRIAL, int D, typename T>
__global__ void __launch_bounds__(CONV_THREADS, ForceShape<D, T>::BLOCKS)
    force_split_kernel(const __grid_constant__ ForceArgs<T> a) {
  using S = ForceShape<D, T>;
  constexpr bool BF = IS_BF16<T>;
  static_assert(!BF || !VIRIAL, "bf16 operands: the force readout only");
  constexpr int NT = S::NT, TM = S::TM, LDX = S::LDX, LDP = S::LDP;
  constexpr int W = VIRIAL ? 12 : 4;  // floats of a bond's contribution
  // staged columns of an e row: D, and bf16 at D = 8 zeros up to 16
  constexpr int SEG = 16 / (int)sizeof(T), KW = BF && D < 16 ? 16 : D;
  extern __shared__ __align__(16) float smem[];
  unsigned char* const base_b = reinterpret_cast<unsigned char*>(smem);
  uint4* wsp = reinterpret_cast<uint4*>(smem);   // f32: (D / 2, LDP)
  uint2* wsb = reinterpret_cast<uint2*>(smem);   // bf16: (4 KB, LDP)
  unsigned char* const stages = base_b + S::W_BYTES;
  float* prm = reinterpret_cast<float*>(stages + STAGES * S::STAGE_BYTES);
  float* carry = prm + 2 * D + 4;
  int* starts = reinterpret_cast<int*>(carry + 2 * 12);
  int* run_pos = starts + TM;
  int* run_row = run_pos + TM;
  int* scal = run_row + TM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n_rows = a.n_rows;
  const int n_real = __ldg(a.offs + n_rows);
  const int T_ = max(a.t_min, (n_real + (int)gridDim.x - 1) / (int)gridDim.x);
  const int c0 = (int)blockIdx.x * T_;

  // the rows with no bonds, the padded tail among them, are zeros: a
  // grid-stride pass, one row a thread, while the first tile is in flight
  auto zero_rows = [&]() {
    for (int r = (int)blockIdx.x * CONV_THREADS + tid; r < n_rows;
         r += (int)gridDim.x * CONV_THREADS) {
      if (__ldg(a.offs + r) == __ldg(a.offs + r + 1)) {
#pragma unroll
        for (int k = 0; k < 3; ++k) store1(a.out + (size_t)r * 3 + k, 0.0f);
        if (VIRIAL) {
#pragma unroll
          for (int k = 0; k < 9; ++k) a.vir[(size_t)r * 9 + k] = 0.0f;
        }
      }
    }
  };
  if (c0 >= n_real) {
    zero_rows();
    return;
  }

  block_rows(a.offs, n_rows, c0, T_, n_real, scal);
  for (int i = tid; i < TM; i += CONV_THREADS) starts[i] = -1;
  for (int i = tid; i < D; i += CONV_THREADS) {
    prm[i] = to_f32(a.b1[i]);
    prm[D + i] = to_f32(a.w2[i]);
  }
  if (tid == 0) prm[2 * D] = to_f32(a.b2[0]);
  __syncthreads();
  const int r_lo = scal[4], r_hi = scal[5];
  const int start = __ldg(a.offs + r_lo), end = __ldg(a.offs + r_hi);
  const int n_tiles = (end - start + TM - 1) / TM;
  int scan_from = r_lo;  // the first row not yet seen by a scan
  int carry_row = -1;    // the row that continues into the next tile

  auto stage_e = [&](int t) {
    return reinterpret_cast<T*>(stages + (t % STAGES) * S::STAGE_BYTES);
  };
  auto stage_xh = [&](int t) {
    return reinterpret_cast<float*>(stages + (t % STAGES) * S::STAGE_BYTES +
                                    sizeof(T) * TM * LDX);
  };
  // tile t: its e rows (contiguous), x_hat rows and distances; rows past
  // the range are zeros
  auto load_stage = [&](int t) {
    if (t < n_tiles) {
      const int base = start + t * TM;
      const int n_e = min(TM, end - base);
      T* xs = stage_e(t);
      float* xh = stage_xh(t);
      for (int i = tid; i < TM * KW / SEG; i += CONV_THREADS) {
        const int r = i / (KW / SEG), c = (i % (KW / SEG)) * SEG;
        const bool in = r < n_e && c < D;
        cp_async16(xs + r * LDX + c,
                   in ? a.e + (size_t)(base + r) * D + c : a.e, in);
      }
      for (int i = tid; i < 3 * TM; i += CONV_THREADS) {
        const bool in = i < 3 * n_e;
        cp_async4(xh + i, in ? a.xhat + (size_t)base * 3 + i : a.xhat, in);
      }
      if (VIRIAL) {
        for (int i = tid; i < TM; i += CONV_THREADS) {
          const bool in = i < n_e;
          cp_async4(xh + 3 * TM + i, in ? a.dist + base + i : a.dist, in);
        }
      }
    }
    cp_async_commit();
  };

  // the first tile in flight while W1 is split (packed) and the empty
  // rows are zeroed
  load_stage(0);
  if constexpr (BF) {
    // fragment q = 4 kk + tq of column n: (W1[k][n], W1[k + 1][n]) and
    // (W1[k + 8][n], W1[k + 9][n]), k = 16 kk + 2 tq; rows past D are 0
    for (int i = tid; i < 4 * S::KB * D; i += CONV_THREADS) {
      const int q = i / D, n = i % D;
      const int k = 16 * (q / 4) + 2 * (q % 4);
      auto w = [&](int kr) {
        return kr < D ? to_f32(a.w1[(size_t)kr * D + n]) : 0.0f;
      };
      wsb[q * LDP + n] =
          make_uint2(pack_bf16(w(k), w(k + 1)), pack_bf16(w(k + 8), w(k + 9)));
    }
  } else {
    // W1 row pairs (2 kp, 2 kp + 1) of column n, split: (hi, hi, lo, lo)
    for (int i = tid; i < (D / 2) * D; i += CONV_THREADS) {
      const int kp = i / D, n = i % D;
      uint4 q;
      split_tf32(__ldg(a.w1 + (size_t)(2 * kp) * D + n), q.x, q.z);
      split_tf32(__ldg(a.w1 + (size_t)(2 * kp + 1) * D + n), q.y, q.w);
      wsp[kp * LDP + n] = q;
    }
  }
  zero_rows();

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    // tile t is visible to every warp, and every warp is done with tile
    // t - 1 and its reduction
    __syncthreads();
    load_stage(t + 1);
    const int base = start + t * TM;
    const int n_e = min(TM, end - base);
    const int tile_end = base + n_e;
    mark_starts(a.offs, scan_from, r_hi, base, tile_end, starts);

    T* xs = stage_e(t);
    const float* xh = stage_xh(t);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    // warp w's rows are 16 w + g and 16 w + g + 8
    if constexpr (BF) {
#pragma unroll
      for (int kk = 0; kk < S::KB; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, xs + (warp * 16 + (lane & 15)) * LDX + kk * 16 +
                            (lane >> 4) * 8);
        const uint2* wk = wsb + (kk * 4 + tq) * LDP + g;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 b = wk[j * 8];
          mma_bf16(acc[j], af, b.x, b.y);
        }
      }
    } else {
      const float* xw = xs + (warp * 16 + g) * LDX + 2 * tq;
#pragma unroll
      for (int k8 = 0; k8 < D / 8; ++k8) {
        const float2 top = *reinterpret_cast<const float2*>(xw + k8 * 8);
        const float2 bot =
            *reinterpret_cast<const float2*>(xw + 8 * LDX + k8 * 8);
        const float xa[4] = {top.x, bot.x, top.y, bot.y};
        uint32_t ah[4], al[4];
        split_frag(xa, ah, al);
        const uint4* wk = wsp + (k8 * 4 + tq) * LDP + g;
        constexpr int G = NT < 8 ? NT : 8;
#pragma unroll
        for (int j0 = 0; j0 < NT; j0 += G) {
          uint4 b[G];
#pragma unroll
          for (int i = 0; i < G; ++i) b[i] = wk[(j0 + i) * 8];
#pragma unroll
          for (int i = 0; i < G; ++i)
            mma_tf32(acc[j0 + i], al, b[i].x, b[i].y);
#pragma unroll
          for (int i = 0; i < G; ++i)
            mma_tf32(acc[j0 + i], ah, b[i].z, b[i].w);
#pragma unroll
          for (int i = 0; i < G; ++i)
            mma_tf32(acc[j0 + i], ah, b[i].x, b[i].y);
        }
      }
    }

    // epilogue: n_b of tile rows g (i = 0) and g + 8 (i = 1), this
    // thread's columns 8 j + 2 tq + e summed, then the quad's; the quad's
    // lanes write the row's contributions (f32) over its e row (only this
    // warp read that row)
    constexpr int LDF = LDX * (int)sizeof(T) / 4;  // e row stride in floats
    float* xf = reinterpret_cast<float*>(xs);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tt = warp * 16 + 8 * i + g;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + 2 * tq + e;
          s += silu(acc[j][2 * i + e] + prm[c]) * prm[D + c];
        }
      const float n = quad_sum(s) + prm[2 * D];
      if (tt < n_e) {
        const float x0 = xh[3 * tt], x1 = xh[3 * tt + 1], x2 = xh[3 * tt + 2];
        float4* row = reinterpret_cast<float4*>(xf + tt * LDF);
        if (!VIRIAL) {
          if (tq == 0) row[0] = make_float4(n * x0, n * x1, n * x2, 0.0f);
        } else {
          const float nd = n * xh[3 * TM + tt];
          if (tq == 0)
            row[0] = make_float4(n * x0, n * x1, n * x2, nd * (x0 * x0));
          else if (tq == 1)
            row[1] = make_float4(nd * (x0 * x1), nd * (x0 * x2),
                                 nd * (x1 * x0), nd * (x1 * x1));
          else if (tq == 2)
            row[2] = make_float4(nd * (x1 * x2), nd * (x2 * x0),
                                 nd * (x2 * x1), nd * (x2 * x2));
        }
      }
    }

    // [fx fy fz v00 | v01 v02 v10 v11 | v12 v20 v21 v22] per row
    tile_run_sums<TM, W>(
        xf, LDF, n_e, tile_end, t, starts, run_pos, run_row, scal, carry,
        carry_row, scan_from, a.offs, [&](int row, int c4, float4 s4) {
          if (c4 == 0) {
            store1(a.out + (size_t)row * 3, s4.x);
            store1(a.out + (size_t)row * 3 + 1, s4.y);
            store1(a.out + (size_t)row * 3 + 2, s4.z);
            if (VIRIAL) a.vir[(size_t)row * 9] = s4.w;
          } else {
            float* v = a.vir + (size_t)row * 9 + c4 - 3;
            v[0] = s4.x;
            v[1] = s4.y;
            v[2] = s4.z;
            v[3] = s4.w;
          }
        });
  }
  cp_async_wait<0>();
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory: several blocks fit
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// one conv launch; the caller's plan (tm, smem) must be this kernel's
template <int MODE, int D, typename T>
int launch_conv(const ConvArgs<T>& a, int grid, int tm, int smem,
                cudaStream_t stream) {
  using S = ConvShape<MODE, D, T>;
  if (tm != S::TM || smem != (int)S::SMEM || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(conv_split_kernel<MODE, D, T>, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  conv_split_kernel<MODE, D, T><<<grid, CONV_THREADS, S::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE, typename T>
int dispatch_conv(const ConvArgs<T>& a, int dim, int grid, int tm, int smem,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 8:
      return launch_conv<MODE, 8>(a, grid, tm, smem, st);
    case 16:
      return launch_conv<MODE, 16>(a, grid, tm, smem, st);
    case 32:
      return launch_conv<MODE, 32>(a, grid, tm, smem, st);
    case 64:
      return launch_conv<MODE, 64>(a, grid, tm, smem, st);
    case 128:
      return launch_conv<MODE, 128>(a, grid, tm, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

// one force readout launch; the caller's plan (tm, smem) must be this
// kernel's
template <bool VIRIAL, int D, typename T>
int launch_force(const ForceArgs<T>& a, int grid, int tm, int smem,
                 cudaStream_t stream) {
  using S = ForceShape<D, T>;
  if (tm != S::TM || smem != (int)S::SMEM || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(force_split_kernel<VIRIAL, D, T>, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  force_split_kernel<VIRIAL, D, T>
      <<<grid, CONV_THREADS, S::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool VIRIAL, typename T>
int dispatch_force(const ForceArgs<T>& a, int dim, int grid, int tm,
                   int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 8:
      return launch_force<VIRIAL, 8>(a, grid, tm, smem, st);
    case 16:
      return launch_force<VIRIAL, 16>(a, grid, tm, smem, st);
    case 32:
      return launch_force<VIRIAL, 32>(a, grid, tm, smem, st);
    case 64:
      return launch_force<VIRIAL, 64>(a, grid, tm, smem, st);
    case 128:
      return launch_force<VIRIAL, 128>(a, grid, tm, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int atom_conv(const T* v, const T* e, const T* e_a, const T* w, const T* b,
              const T* ln_scale, const T* ln_bias, const int* center,
              const int* nbr, const int* pair, const int* offs, T* out,
              int n_rows, int dim, int und, int grid, int t_min, int tm,
              int smem, void* stream) {
  if (n_rows == 0) return 0;
  ConvArgs<T> a{};
  a.tab0 = v;
  a.id0 = center;
  a.tab1 = v;
  a.id1 = nbr;
  a.tab2 = e;
  a.id2 = und ? pair : nullptr;
  a.env = e_a;
  a.env0 = pair;
  a.w = w;
  a.bias = b;
  a.lns = ln_scale;
  a.lnb = ln_bias;
  a.offs = offs;
  a.out = out;
  a.n_rows = n_rows;
  a.t_min = t_min;
  return dispatch_conv<ATOM>(a, dim, grid, tm, smem, stream);
}

template <typename T>
int bond_conv(const T* v, const T* e, const T* a_feat, const T* e_b,
              const T* w, const T* b, const T* ln_scale, const T* ln_bias,
              const int* angle_ij, const int* angle_ik, const int* center_ids,
              const int* env_ij, const int* env_ik, const int* offs, T* out,
              int n_rows, int dim, int grid, int t_min, int tm, int smem,
              void* stream) {
  if (n_rows == 0) return 0;
  ConvArgs<T> a{};
  a.tab0 = v;
  a.id0 = center_ids;
  a.tab1 = e;
  a.id1 = angle_ij;
  a.tab2 = e;
  a.id2 = angle_ik;
  a.tab3 = a_feat;
  a.env = e_b;
  a.env0 = env_ij;
  a.env1 = env_ik;
  a.w = w;
  a.bias = b;
  a.lns = ln_scale;
  a.lnb = ln_bias;
  a.offs = offs;
  a.out = out;
  a.n_rows = n_rows;
  a.t_min = t_min;
  return dispatch_conv<BOND>(a, dim, grid, tm, smem, stream);
}

}  // namespace
