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
// The two convs (conv_split_kernel) run their GEMM on the tensor cores in
// split f32 (3xTF32 mma.sync, hopper.cuh).  At FAST_FUSED (D = 64, batch
// 128) the bond conv does 2 E d_in 2D = 5.3 GFLOP over 81k angles and
// writes a 101 MB (E_cap, D) output; as f32 FMAs that is 0.080 ms at 67
// TFLOP/s, as three TF32 products 0.032 ms at 495 TFLOP/s, below the 0.052
// ms its bytes take at 3.35 TB/s.  The atom conv does 4.8 GFLOP on ~53 MB:
// 0.029 ms split, bound by operations.  The design:
//  - work is balanced by edges: block c of a persistent grid (two blocks
//    of 4 warps per SM for D <= 64) owns the non-empty rows r with
//    offs[r] in [c T, (c+1) T), T = max(t_min, ceil(offs[n_rows] / grid))
//    read on the device, found with two warp-wide 32-ary searches on
//    offs.  A row stays whole in the block where it starts, however long;
//    the empty rows (bonds with no angle, the padded capacity tail: 297k
//    of the bond conv's 394k rows at batch 128) are zeroed by a
//    grid-stride pass that all blocks share, a 32-row group per warp
//    between stages, so the 76 MB of zeros drain while products run;
//  - a block walks its edge range in tiles of TM = 128 edges (64 at D =
//    128) and each tile in K chunks of 32 columns: a stage gathers the
//    tile's 32 input columns with 16-byte cp.async through the chunk's
//    part's row ids ([v[c] | v[n] | e[b]] for the atom conv, [v[ctr] |
//    e[ij] | e[ik] | a[n]] for the bond conv; a chunk lies in one part
//    for D >= 32, and its row ids are read a stage ahead) and the
//    matching W rows (32, 2D), double-buffered against the products of
//    the previous stage.  W is read again from L2 for every tile, so it
//    need not fit in shared memory;
//  - a warp owns 32 rows (two m16 tiles; 16 at D = 128) by all 2D
//    columns in registers, as in gated_mlp.cu.  The epilogue runs on the
//    accumulators: bias, both LayerNorms (quad shuffles), the gate, then
//    the envelope rows (read per row from L2); the TM x D message tile
//    goes to shared memory for the reduction only;
//  - the reduction is ordered and parallel across rows: the tile's row
//    starts are marked from offs, compacted into runs, and each run is
//    summed in edge order by D / 4 threads (a float4 of columns each);
//    a row that continues past the tile carries its partial sum, through
//    shared memory, into the next tile's first run.
// Fragment order as in gated_mlp.cu: k = t / t + 4 of each 8-wide step are
// input columns 2t / 2t + 1, row strides 40 floats (x), 2D + 4 (W) and
// D + 8 (messages) keep the fragment loads and stores free of bank
// conflicts.
//
// The force readout does 2 E D D flops on E (D + 3) 4 bytes, about 31
// flops per byte, and sym_msg_fwd is the bond conv's GEMM at K = 3D (the
// two e slots of the bond MLP read the same swap-symmetric row, so the
// wrapper adds their weight blocks once per call) over the real
// dedup-angle rows only.  Both still run as f32 FMAs on the CUDA cores: a
// tile of TE edges gathered once into shared memory, each thread owning
// one output column with TE accumulators in registers, each weight read
// once per tile from L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TE = 32;          // edges per tile of the FMA kernels
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
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

// ---------------------------------------------------------------------------
// Kernels 2 and 3: the split-f32 convs
// ---------------------------------------------------------------------------

enum ConvMode { ATOM = 0, BOND = 1 };

constexpr int CONV_WARPS = 4;
constexpr int CONV_THREADS = 32 * CONV_WARPS;
constexpr int KC = 32;          // input columns per stage
constexpr int STAGES = 2;

// The launch geometry; kernels/ops.py conv_plan computes the same numbers
// and the launcher refuses a plan that differs.
template <int D>
struct ConvShape {
  static constexpr int NT = 2 * D / 8;          // n8 tiles of [core | gate]
  static constexpr int RW = D <= 64 ? 2 : 1;    // m16 tiles per warp
  static constexpr int TM = CONV_WARPS * 16 * RW;  // edges per tile
  static constexpr int LDX = KC + 8, LDW = 2 * D + 4, LDM = D + 8;
  static constexpr int STAGE = TM * LDX + KC * LDW;  // floats
  // floats: the stages, the message tile, bias / ln_scale / ln_bias (2D
  // each), two carry rows (D each); ints: row starts, run starts and run
  // rows (TM each), 8 scalars
  static constexpr int FLOATS = STAGES * STAGE + TM * LDM + 6 * D + 2 * D;
  static constexpr int INTS = 3 * TM + 8;
  static constexpr size_t SMEM = sizeof(float) * FLOATS + sizeof(int) * INTS;
};

// The GEMM input of an edge is D-wide parts, each a row of a table: part
// p of edge g is tab_p[id_p[g]] (id_p == nullptr: row g).  The envelope
// factors are env[env0[g]] and, for the bond conv, env[env1[g]].
struct ConvArgs {
  const float* tab0;
  const float* tab1;
  const float* tab2;
  const float* tab3;
  const int* id0;
  const int* id1;
  const int* id2;
  const float* env;
  const int* env0;
  const int* env1;
  const float* w;
  const float* bias;
  const float* lns;
  const float* lnb;
  const int* offs;
  float* out;
  int n_rows;
  int t_min;
};

__device__ __forceinline__ int row_of(const int* ids, int g) {
  return ids ? __ldg(ids + g) : g;
}

template <int D>
__device__ __forceinline__ const float* part_row(const ConvArgs& a, int p,
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

// The first index i in [0, hi] with offs[i] >= x, for nondecreasing offs
// with offs[hi] >= x.  A warp's 32 lanes probe the last entry of 32 equal
// buckets a round, so ~400k rows take 3 rounds and a final probe.
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
template <int MODE, int D>
__global__ void __launch_bounds__(CONV_THREADS, 2)
    conv_split_kernel(const __grid_constant__ ConvArgs a) {
  using S = ConvShape<D>;
  constexpr int NT = S::NT, RW = S::RW, TM = S::TM;
  constexpr int LDX = S::LDX, LDW = S::LDW, LDM = S::LDM, N2 = 2 * D;
  constexpr int D_IN = (MODE == BOND ? 4 : 3) * D;
  constexpr int NK = (D_IN + KC - 1) / KC;
  constexpr int K_LAST = D_IN - (NK - 1) * KC;  // columns of the last chunk
  extern __shared__ __align__(16) float smem[];
  float* msg = smem + STAGES * S::STAGE;  // (TM, LDM) message tile
  float* prm = msg + TM * LDM;            // bias, ln_scale, ln_bias
  float* carry = prm + 3 * N2;            // two rows, by tile parity
  int* starts = reinterpret_cast<int*>(carry + 2 * D);
  int* run_pos = starts + TM;
  int* run_row = run_pos + TM;
  int* scal = run_row + TM;  // warp counts [0, 4), r_lo, r_hi, carry-in

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n_rows = a.n_rows;
  const int n_real = __ldg(a.offs + n_rows);
  const int T = max(a.t_min, (n_real + (int)gridDim.x - 1) / (int)gridDim.x);
  const int c0 = (int)blockIdx.x * T;

  // the rows with no edges are zeros: a warp takes 32 rows at a time,
  // finds the empty ones with a ballot and stores them, D / 4 lanes a row;
  // a group's emptiness is read one group ahead
  const int zstride = (int)gridDim.x * CONV_WARPS * 32;
  int zr = ((int)blockIdx.x * CONV_WARPS + warp) * 32;
  bool zempty = zr + lane < n_rows &&
                __ldg(a.offs + zr + lane) == __ldg(a.offs + zr + lane + 1);
  auto zero_group = [&]() {
    if (zr >= n_rows) return;
    constexpr int C4 = D / 4, RPS = 32 / C4;  // lanes a row, rows a store
    float4* out4 = reinterpret_cast<float4*>(a.out);
    unsigned m = __ballot_sync(0xffffffffu, zempty);
    const int r0 = zr;
    zr += zstride;
    zempty = zr + lane < n_rows &&
             __ldg(a.offs + zr + lane) == __ldg(a.offs + zr + lane + 1);
    while (m) {
      unsigned mine = m;  // this lane's row: the (lane / C4)-th left
      for (int k = 0; k < lane / C4; ++k) mine &= mine - 1;
      if (mine)
        out4[(size_t)(r0 + __ffs(mine) - 1) * C4 + lane % C4] =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = 0; k < RPS; ++k) m &= m - 1;
    }
  };

  if (c0 < n_real) {
    // this block's rows [r_lo, r_hi): those with offs in [c0, c0 + T)
    if (warp < 2) {
      const int x = warp == 0 ? c0 : min(c0 + T, n_real);
      const int r = lower_bound_warp(a.offs, n_rows, x, lane);
      if (lane == 0) scal[4 + warp] = r;
    }
    for (int i = tid; i < TM; i += CONV_THREADS) starts[i] = -1;
    for (int i = tid; i < N2; i += CONV_THREADS) {
      prm[i] = a.bias[i];
      prm[N2 + i] = a.lns[i];
      prm[2 * N2 + i] = a.lnb[i];
    }
    __syncthreads();
    const int r_hi = scal[5];
    const int start = __ldg(a.offs + scal[4]), end = __ldg(a.offs + r_hi);
    const int total = (end - start + TM - 1) / TM * NK;
    int scan_from = scal[4];  // the first row not yet seen by a scan
    int carry_row = -1;       // the row that continues into the next tile

    // A stage's x chunk: thread tid copies 16-byte segment tid % 8 of tile
    // rows tid / 8 + 16 it.  For D >= KC the chunk lies in one part, and
    // each lane holds the table row of one of its warp's 32 rows, fetched
    // a stage ahead (stage_rows) and handed round with shuffles: lane l
    // holds row 4 warp + l % 4 + 16 (l / 4).  Narrower D reads each
    // segment's row id as it copies.
    auto stage_rows = [&](int s) {
      if (D < KC || s >= total) return 0;
      const int base = start + (s / NK) * TM;
      const int rr = 4 * warp + (lane & 3) + 16 * (lane >> 2);
      if (rr >= min(TM, end - base)) return 0;
      const int p = (s % NK) * KC / D;
      return row_of(p == 0 ? a.id0 : p == 1 ? a.id1 : p == 2 ? a.id2
                                                               : nullptr,
                    base + rr);
    };

    // stage s: chunk s % NK of tile s / NK.  Rows past the tile's edges
    // and columns past d_in are zeros (in x and in W, so no 0 x NaN)
    auto load_stage = [&](int s, int rows) {
      if (s < total) {
        const int base = start + (s / NK) * TM;
        const int n_e = min(TM, end - base);
        const int k0 = (s % NK) * KC;
        float* xs = smem + (s % STAGES) * S::STAGE;
        float* ws = xs + TM * LDX;
#pragma unroll
        for (int it = 0; it < TM * KC / 4 / CONV_THREADS; ++it) {
          const int i = tid + it * CONV_THREADS;
          const int r = i / (KC / 4), c = (i % (KC / 4)) * 4;
          const int k = k0 + c;
          const bool in = r < n_e && k < D_IN;
          const float* src = a.w;
          if (D >= KC) {
            const int row =
                __shfl_sync(0xffffffffu, rows, (lane >> 3) + 4 * it);
            const int p = k0 / D;
            const float* tab = p == 0 ? a.tab0 : p == 1 ? a.tab1
                             : p == 2 ? a.tab2 : a.tab3;
            if (in) src = tab + (size_t)row * D + k % D;
          } else if (in) {
            src = part_row<D>(a, k / D, base + r) + k % D;
          }
          cp_async16(xs + r * LDX + c, src, in);
        }
        for (int i = tid; i < KC * N2 / 4; i += CONV_THREADS) {
          const int r = i / (N2 / 4), c = (i % (N2 / 4)) * 4;
          const bool in = k0 + r < D_IN;
          cp_async16(ws + r * LDW + c,
                     in ? a.w + (size_t)(k0 + r) * N2 + c : a.w, in);
        }
      }
      // one group per stage, empty past the end, so the wait counts hold
      cp_async_commit();
    };

    load_stage(0, stage_rows(0));
    int next_rows = stage_rows(1);
    float acc[RW][NT][4];

    for (int s = 0; s < total; ++s) {
      cp_async_wait<0>();
      // stage s is visible to every warp, and every warp is done with
      // stage s - 1 and with the last tile's reduction
      __syncthreads();
      load_stage(s + 1, next_rows);
      next_rows = stage_rows(s + 2);  // in flight during the products
      zero_group();

      const int kc = s % NK, tile = s / NK;
      const int base = start + tile * TM;
      const int n_e = min(TM, end - base);
      const int tile_end = base + n_e;
      if (kc == 0) {
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.0f;
        // mark the tile position where each of its non-empty rows starts;
        // rows are scanned from the one after the last tile's last row
        for (int r0 = scan_from;; r0 += CONV_THREADS) {
          const int r = r0 + tid;
          bool more = false;
          if (r < r_hi) {
            const int o = __ldg(a.offs + r);
            if (o < tile_end) {
              if (__ldg(a.offs + r + 1) > o) starts[o - base] = r;
              more = tid == CONV_THREADS - 1;
            }
          }
          if (!__syncthreads_or(more)) break;
        }
      }

      const float* xs = smem + (s % STAGES) * S::STAGE;
      const float* xw = xs + (warp * 16 * RW + g) * LDX + 2 * tq;
      const float* ww = xs + TM * LDX + 2 * tq * LDW + g;
      // one 8-wide step of K, as in gated_mlp.cu: A fragments split, then
      // the n tiles in groups of up to 8, their B fragments split, then the
      // three passes of the split product
      auto k8_step = [&](int k8) {
        uint32_t ah[RW][4], al[RW][4];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float2 top =
              *reinterpret_cast<const float2*>(xw + 16 * r * LDX + k8 * 8);
          const float2 bot = *reinterpret_cast<const float2*>(
              xw + (16 * r + 8) * LDX + k8 * 8);
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
      if (kc < NK - 1 || K_LAST == KC) {
#pragma unroll
        for (int k8 = 0; k8 < KC / 8; ++k8) k8_step(k8);
      } else {  // the last, partial chunk of d_in
#pragma unroll
        for (int k8 = 0; k8 < K_LAST / 8; ++k8) k8_step(k8);
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
          const float* env0 =
              a.env + (size_t)(valid ? row_of(a.env0, ge) : 0) * D + 2 * tq;
          const float* env1 =
              a.env + (size_t)(MODE == BOND && valid ? __ldg(a.env1 + ge) : 0)
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
              const float2 f = __ldg(reinterpret_cast<const float2*>(
                  env0 + j * 8));
              res[0] *= f.x;
              res[1] *= f.y;
              if (MODE == BOND) {
                const float2 f2 = __ldg(reinterpret_cast<const float2*>(
                    env1 + j * 8));
                res[0] *= f2.x;
                res[1] *= f2.y;
              }
            }
            *reinterpret_cast<float2*>(msg + t * LDM + j * 8 + 2 * tq) =
                make_float2(res[0], res[1]);
          }
        }

      // the tile's runs: position 0 (the row carried from the last tile, or
      // one that starts there) and every marked start, in order
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

      // each run summed in edge order by D / 4 threads; the carry rows
      // alternate by tile, so the first run reads the last tile's while
      // the last run writes this one's
      const bool carry_in = scal[6];
      const int last_row = run_row[n_runs - 1];
      const bool carry_out = __ldg(a.offs + last_row + 1) > tile_end;
      const float* carry_rd = carry + ((tile + 1) & 1) * D;
      float* carry_wr = carry + (tile & 1) * D;
      constexpr int G4 = D / 4, NGRP = CONV_THREADS / G4;
      const int c4 = (tid % G4) * 4;
      for (int k = tid / G4; k < n_runs; k += NGRP) {
        const int t1 = k + 1 < n_runs ? run_pos[k + 1] : n_e;
        float4 s4 = k == 0 && carry_in
                        ? *reinterpret_cast<const float4*>(carry_rd + c4)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int t = run_pos[k]; t < t1; ++t) {
          const float4 m = *reinterpret_cast<const float4*>(msg + t * LDM + c4);
          s4.x += m.x;
          s4.y += m.y;
          s4.z += m.z;
          s4.w += m.w;
        }
        if (k == n_runs - 1 && carry_out)
          *reinterpret_cast<float4*>(carry_wr + c4) = s4;
        else
          *reinterpret_cast<float4*>(a.out + (size_t)run_row[k] * D + c4) = s4;
      }
      carry_row = carry_out ? last_row : -1;
      scan_from = last_row + 1;
    }
    cp_async_wait<0>();
  }
  while (zr < n_rows) zero_group();
}

// ---------------------------------------------------------------------------
// Kernel 5, phase A of the symmetric bond conv (f32 FMAs)
// ---------------------------------------------------------------------------

// sym_msg_fwd, phase A of the symmetric bond conv (§10).  No reduction:
// per real dedup-angle row g,
//   out[g] = phi([v[ctr[g]] | e[du1[g]] + e[du2[g]] | a_u[g]])
//            * e_b[du1[g]] * e_b[du2[g]],
// with W (3D, 2D) = [W1 | W2 + W3 | W4] from the caller.  The real rows
// are the prefix [0, offs[n_eu] / 2) (each owns two incidences of the
// (Eu + 1,) offsets); a block past it exits, so the count is read on the
// device and rows past it are left unwritten.
__global__ void sym_msg_kernel(
    const float* __restrict__ v, const float* __restrict__ e,
    const float* __restrict__ a, const float* __restrict__ env,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ lns, const float* __restrict__ lnb,
    const int* __restrict__ ctr, const int* __restrict__ du1,
    const int* __restrict__ du2, const int* __restrict__ offs,
    float* __restrict__ out, int n_eu, int D, int rows_per_block) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d_in = 3 * D;
  const int n2 = 2 * D;
  float* xs = smem;              // (TE, d_in) gathered rows
  float* ys = smem + TE * d_in;  // (TE, 2D) GEMM rows, normalized in place

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int start = blockIdx.x * rows_per_block;
  const int end = min(start + rows_per_block, offs[n_eu] >> 1);

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
        val = part == 0   ? v[(size_t)ctr[g] * D + kk]
              : part == 1 ? e[(size_t)du1[g] * D + kk] +
                                e[(size_t)du2[g] * D + kk]
                          : a[(size_t)g * D + kk];
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

    // 4. gating and envelope: each row's message is stored
    for (int idx = tid; idx < n_e * D; idx += blockDim.x) {
      const int t = idx / D;
      const int j = idx - t * D;
      const int g = base + t;
      const float core = ys[t * n2 + j];
      const float gate = ys[t * n2 + D + j];
      const float m = (core * sigmoid_f(core)) * sigmoid_f(gate);
      out[(size_t)g * D + j] =
          m * env[(size_t)du1[g] * D + j] * env[(size_t)du2[g] * D + j];
    }
    __syncthreads();
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

// one conv launch; the caller's plan (tm, smem) must be this kernel's
template <int MODE, int D>
int launch_conv(const ConvArgs& a, int grid, int tm, int smem,
                cudaStream_t stream) {
  using S = ConvShape<D>;
  if (tm != S::TM || smem != (int)S::SMEM || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(conv_split_kernel<MODE, D>, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's unified memory as shared memory: two blocks fit
  err = cudaFuncSetAttribute(conv_split_kernel<MODE, D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  conv_split_kernel<MODE, D><<<grid, CONV_THREADS, S::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch_conv(const ConvArgs& a, int dim, int grid, int tm, int smem,
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

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The caller checks shapes, dtypes (f32 / int32), contiguity, 16-byte
// aligned tables and, for the convs, D in {8, 16, 32, 64, 128}, and gives
// the launch plan (grid, t_min, tm, smem) of kernels/ops.py conv_plan.

// pair == nullptr: the directed store; else e_a is an (Eu, D) table read
// through pair, and with und != 0 e is one too.
int atom_conv_fwd(const float* v, const float* e, const float* e_a,
                  const float* w, const float* b, const float* ln_scale,
                  const float* ln_bias, const int* center, const int* nbr,
                  const int* pair, const int* offs, float* out, int n_rows,
                  int dim, int und, int grid, int t_min, int tm, int smem,
                  void* stream) {
  if (n_rows == 0) return 0;
  ConvArgs a{};
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
  if (n_rows == 0) return 0;
  ConvArgs a{};
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

// Phase A of the symmetric bond conv: messages (n_au, D) of the real dedup
// rows [0, offs[n_eu] / 2); w23 is (3D, 2D) = [W1 | W2 + W3 | W4].
int sym_msg_fwd(const float* v, const float* e, const float* a_u,
                const float* e_b, const float* w23, const float* b,
                const float* ln_scale, const float* ln_bias, const int* ctr,
                const int* du1, const int* du2, const int* offs, float* out,
                int n_eu, int n_au, int dim, int rows_per_block,
                void* stream) {
  if (n_au == 0) return 0;
  const size_t smem = sizeof(float) * TE * (3 * dim + 2 * dim);
  cudaError_t err = set_smem(sym_msg_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_au + rows_per_block - 1) / rows_per_block;
  sym_msg_kernel<<<grid, round_up_warp(2 * dim), smem,
                   (cudaStream_t)stream>>>(
      v, e, a_u, e_b, w23, b, ln_scale, ln_bias, ctr, du1, du2, offs, out,
      n_eu, dim, rows_per_block);
  return (int)cudaGetLastError();
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
