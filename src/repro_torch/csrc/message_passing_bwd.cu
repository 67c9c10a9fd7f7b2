// The backward of kernels 2 and 3 (the fused atom and bond convs):
// conv_bwd_kernel, on the message-passing templates of
// message_passing.cuh, and its entries.  f32 only: the backward widens
// bf16 operands.  A library of its own, so that it compiles beside the
// forward's (kernels/build.py builds every source in parallel).

#include "message_passing.cuh"

namespace {

// ---------------------------------------------------------------------------
// Kernels 2 and 3 backward: conv_bwd_kernel<MODE, D> (MODE ATOM or BOND of
// the forward's template) and the ordered sum of its blocks' partials
// ---------------------------------------------------------------------------
//
// The backward of atom_conv_fwd and bond_conv_fwd, taken where the
// operands lie on the card and the backward is of first order
// (kernels/ops.py: with grad mode off inside the backward).  It replaces
// the chunked recompute of kernels/ops.py (_recompute_vjp through the
// plain GatedMLP), ~250 device ops a call, by three launches and the
// sorts of the ids; the JAX package's custom VJPs recompute the same way
// and have no kernel to replace.  Per edge n of row r(n),
// with x = [parts], z = x W + bias, y = LN(z) per half, phi = silu(y_c)
// sigmoid(y_g) and msg = phi * env (the atom conv's e_a[b']; the bond
// conv's e_b[p1] e_b[p2]), from the output's cotangent G:
//   gm = G[r(n)],  d env = gm * phi (* the other envelope),
//   dphi = gm * env,  dy = dphi * d phi / dy,
//   dzhat = dy * ln_scale,
//   dz = rstd (dzhat - mean dzhat - zhat mean(dzhat zhat)),
//   dx = dz W^T,  dW += x^T dz,  db += dz,  dln_scale += dy zhat,
//   dln_bias += dy.
//
// The design.  The blocks walk the forward's edge partition (conv_plan's
// grid; each non-empty CSR row owned by the block where it starts), in
// tiles of TM = 64 edges, one m16 tile a warp.  Each tile streams its
// (x chunk, W chunk) pairs through the forward's two cp.async stages
// twice: pass 1 recomputes z in split f32 (3xTF32 mma.sync m16n8k8, as the
// forward), and its epilogue runs on the accumulators: the LayerNorm
// statistics, the gate, G gathered at each edge's row, the envelopes'
// cotangents, then dz, kept in shared memory (TM x 2D f32) with the
// tile's column sums of dz, dy zhat and dy added into each warp's row of
// parameter partials.  Pass 2, per K chunk of 32 columns, forms dW's rows
// of the chunk (x chunk^T dz, 64 edges deep) and dx's columns of the
// chunk (dz W chunk^T), both in split f32.  No message, z or dz reaches
// device memory.
//
// Where the cotangents go, with no atomics, so that every run gives the
// same bits:
//   - the part summed by CSR row, the atom conv's v[center] and the bond
//     conv's e[ij] (the edges of a row are a contiguous run): summed in
//     edge order per run, as the forward's tile_run_sums (a row that
//     continues past a tile carries its partial), and stored once, by the
//     block that owns the row (dsum);
//   - every other part and the envelopes: each edge's cotangent row stored
//     at the edge's own row (dx[p], denv0, denv1), where the wrapper gives
//     either the cotangent itself (a per-edge operand: the directed store's
//     e and e_a, the bond conv's a) or a scratch of edge rows that
//     sorted_row_sum_kernel then sums into the rows the edges read (the
//     atom conv's v[nbr], and e and e_a through pair; the bond conv's
//     v[ctr], e[ik] and both e_b rows), each row's edges in the order of a
//     stable sort of their ids (kernels/ops.py), added to what the row
//     already holds (dsum's sums, or zeros);
//   - dW, db, dln_scale and dln_bias: each block's partials (dW added to
//     its own slice of `part` tile by tile, the rest summed per warp in
//     shared memory, then the warps in order) go to a grid x (K 2D + 6D)
//     scratch, and block_partial_sum_kernel sums them in block order.
//
// Bound (FAST_FUSED, D = 64, the first training batch of the benchmark's
// mix: 79,746 bonds, 63,712 angles): three products of 2 E K 2D each, the
// atom conv 11.8 GFLOP, the bond conv 12.5: as three TF32 products each,
// 0.071 and 0.076 ms at 494.7 TFLOP/s, above the ~0.025 ms their bytes
// take at 3.35 TB/s (operands and cotangents of the real rows, ~85 MB
// each): bound by operations.  Beyond the products, the tile's epilogue
// (two LayerNorms, the gate, the envelopes, per element ~40 f32
// operations) and the dW partials' read-modify-write in L2 (K 2D floats a
// tile: 24 MB an atom conv at 64-edge tiles) cost what the 64-edge tile
// keeps small: two blocks a SM (108,832 bytes of shared memory each at
// D = 64, dz and the stages), each warp's accumulators 2D / 8 tiles.  The
// edge rows that sorted_row_sum_kernel then sums (the atom conv's E D
// floats of v[nbr], 20 MB; the bond conv's 4 A D of v[ctr], e[ik] and
// both e_b rows, 65 MB) are written once and read once: ~0.03 ms at
// 3.35 TB/s, the price of sums in a fixed order.
template <int MODE, int D>
struct ConvBwdShape {
  static constexpr int BLOCKS = D <= 64 ? 2 : 1;
  static constexpr int NT = 2 * D / 8;        // n8 tiles of [core | gate]
  static constexpr int TM = CONV_WARPS * 16;  // edges a tile, m16 a warp
  static constexpr int D_IN = (MODE == BOND ? 4 : 3) * D;  // rows of W
  static constexpr int NK = (D_IN + KC - 1) / KC;
  // row strides in floats: x chunks and W chunks as the forward's, dz and
  // the run-summed dx chunk 8 mod 32
  static constexpr int LDX = KC + 8, LDW = 2 * D + 4;
  static constexpr int LDZ = 2 * D + 8, LDS = KC + 8;
  // the part whose cotangent rows are summed by CSR row, columns [RS0,
  // RS0 + D) of x: v[center] (atom), e[ij] (bond)
  static constexpr int RS_PART = MODE == BOND ? 1 : 0, RS0 = RS_PART * D;
  static constexpr int STAGE = TM * LDX + KC * LDW;
  static constexpr int N_PARAM = D_IN * 2 * D + 6 * D;  // dW, db, dls, dlb
  // floats: the stages, dz, the dx chunk, bias / ln_scale / ln_bias, each
  // warp's db / dls / dlb partials, two carry rows of D; ints: row
  // starts, run starts and run rows (TM each), 8 scalars
  static constexpr int FLOATS = STAGES * STAGE + TM * LDZ + TM * LDS +
                                6 * D + CONV_WARPS * 6 * D + 2 * D;
  static constexpr size_t SMEM =
      sizeof(float) * FLOATS + sizeof(int) * (3 * TM + 8);
};

// The forward's operands (out unused), the output's cotangent g (n_rows,
// D); dsum, the cotangent of the part summed by row (zeroed by the
// caller: rows with no edge stay 0); dx[p], the rows of part p's
// cotangent, and denv0 / denv1, those of the envelopes read at env0 /
// env1, at each edge's row (dx[RS_PART] unused); the blocks' partials and
// the summed dW | db | dls | dlb.
struct ConvBwdArgs {
  ConvArgs<float> f;
  const float* g;
  float* dsum;
  float* dx[4];
  float* denv0;
  float* denv1;
  float* part;
  float* dparams;
};

// The runs of one tile as tile_run_sums finds them, for sums taken later
// column chunk by column chunk: run_pos / run_row hold the n_runs runs
// (returned); carry_in says the first continues the row carried from the
// last tile, carry_out that the last continues past this one.  Every
// thread of the block calls it; it resets starts[] for the next tile.
template <int TM>
__device__ __forceinline__ int tile_runs(int n_e, int tile_end, int* starts,
                                         int* run_pos, int* run_row,
                                         int* scal, int& carry_row,
                                         int& scan_from, bool& carry_in,
                                         bool& carry_out,
                                         const int* __restrict__ offs) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int srow = -1;
  if (tid < TM) {
    srow = starts[tid];
    starts[tid] = -1;
  }
  const bool first = tid < n_e && (tid == 0 || srow >= 0);
  const unsigned ball = __ballot_sync(0xffffffffu, first);
  if (lane == 0) scal[warp] = __popc(ball);
  if (tid == 0) scal[6] = srow < 0;
  __syncthreads();
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
  carry_in = scal[6];
  const int last_row = run_row[n_runs - 1];
  carry_out = __ldg(offs + last_row + 1) > tile_end;
  carry_row = carry_out ? last_row : -1;
  scan_from = last_row + 1;
  return n_runs;
}

__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(1.0f + expf(-x));
}

// the three passes of a split product into accumulator d
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

template <int MODE, int D>
__global__ void __launch_bounds__(CONV_THREADS, ConvBwdShape<MODE, D>::BLOCKS)
    conv_bwd_kernel(const __grid_constant__ ConvBwdArgs a) {
  using S = ConvBwdShape<MODE, D>;
  constexpr int NT = S::NT, TM = S::TM, NK = S::NK, D_IN = S::D_IN;
  constexpr int LDX = S::LDX, LDW = S::LDW, LDZ = S::LDZ, LDS = S::LDS;
  constexpr int N2 = 2 * D, RS_PART = S::RS_PART, RS0 = S::RS0;
  constexpr int K_LAST = D_IN - (NK - 1) * KC;  // columns of the last chunk
  constexpr int SPR = KC / 4;                   // 16-byte copies a chunk row
  // pass 2's dW tiles of a chunk (32 rows by 2D columns), spread over the
  // warps: MIW m16 tiles by NJW n8 tiles each
  constexpr int MIW = D >= 16 ? 2 : 1, NJW = D >= 16 ? D / 16 : 1;
  const ConvArgs<float>& f = a.f;
  extern __shared__ __align__(16) float smem[];
  float* const stages = smem;
  float* const dz = stages + STAGES * S::STAGE;  // (TM, LDZ): dzhat, then dz
  float* const stg = dz + TM * LDZ;   // (TM, LDS): the chunk's summed parts
  float* const prm = stg + TM * LDS;  // bias, ln_scale, ln_bias
  float* const pw = prm + 3 * N2;     // per warp: db, dls, dlb
  float* const carry = pw + CONV_WARPS * 3 * N2;  // two rows, by tile parity
  int* const starts = reinterpret_cast<int*>(carry + 2 * D);
  int* const run_pos = starts + TM;
  int* const run_row = run_pos + TM;
  int* const scal = run_row + TM;  // warp counts, r_lo, r_hi, carry-in

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n_rows = f.n_rows;
  const int n_real = __ldg(f.offs + n_rows);
  const int T_ = max(f.t_min, (n_real + (int)gridDim.x - 1) / (int)gridDim.x);
  const int c0 = (int)blockIdx.x * T_;
  float* const part = a.part + (size_t)blockIdx.x * S::N_PARAM;
  const int* const grow = MODE == ATOM ? f.id0 : f.id1;  // an edge's row

  int n_tiles = 0;
  if (c0 < n_real) {
    block_rows(f.offs, n_rows, c0, T_, n_real, scal);
    for (int i = tid; i < TM; i += CONV_THREADS) starts[i] = -1;
    for (int i = tid; i < N2; i += CONV_THREADS) {
      prm[i] = f.bias[i];
      prm[N2 + i] = f.lns[i];
      prm[2 * N2 + i] = f.lnb[i];
    }
    for (int i = tid; i < CONV_WARPS * 3 * N2; i += CONV_THREADS) pw[i] = 0.0f;
    __syncthreads();
    const int r_hi = scal[5];
    const int start = __ldg(f.offs + scal[4]);
    const int end = __ldg(f.offs + r_hi);
    n_tiles = (end - start + TM - 1) / TM;
    const int total = n_tiles * 2 * NK;

    // stage s: chunk s % NK of tile s / (2 NK), in pass 1 then pass 2 (the
    // same rows).  Rows past the tile's edges and columns past d_in are
    // zeros, in x and in W
    auto load_stage = [&](int s) {
      if (s < total) {
        const int base = start + s / (2 * NK) * TM;
        const int n_e = min(TM, end - base);
        const int k0 = s % NK * KC;
        float* xs = stages + (s % STAGES) * S::STAGE;
        float* ws = xs + TM * LDX;
#pragma unroll
        for (int it = 0; it < TM * SPR / CONV_THREADS; ++it) {
          const int i = tid + it * CONV_THREADS;
          const int r = i / SPR, c = (i % SPR) * 4;
          const int k = k0 + c;
          const bool in = r < n_e && k < D_IN;
          cp_async16(xs + r * LDX + c,
                     in ? part_row<D>(f, k / D, base + r) + k % D : f.w, in);
        }
        for (int i = tid; i < KC * N2 / 4; i += CONV_THREADS) {
          const int r = i / (N2 / 4), c = (i % (N2 / 4)) * 4;
          const bool in = k0 + r < D_IN;
          cp_async16(ws + r * LDW + c,
                     in ? f.w + (size_t)(k0 + r) * N2 + c : f.w, in);
        }
      }
      cp_async_commit();
    };

    load_stage(0);
    float acc[NT][4];
    float mu[2][2], rstd[2][2];  // [row i][half]
    int scan_from = scal[4], carry_row = -1, n_runs = 0;
    bool carry_in = false, carry_out = false;

    for (int s = 0; s < total; ++s) {
      cp_async_wait<0>();
      // stage s, dz and the runs are visible to every warp, and every warp
      // is done with stage s - 1 and with the chunk's summed parts
      __syncthreads();
      load_stage(s + 1);

      const int tile = s / (2 * NK), q = s % (2 * NK), kc = q % NK;
      const int base = start + tile * TM;
      const int n_e = min(TM, end - base);
      const int tile_end = base + n_e;
      const float* xs = stages + (s % STAGES) * S::STAGE;
      const float* ws = xs + TM * LDX;
      const int ncols = kc < NK - 1 ? KC : K_LAST;  // the chunk's columns

      if (q < NK) {
        // pass 1: z = x W, the forward's products (k = t / t + 4 of an
        // 8-wide step are columns 2t / 2t + 1)
        if (kc == 0) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
          mark_starts(f.offs, scan_from, r_hi, base, tile_end, starts);
        }
        const float* xw = xs + (warp * 16 + g) * LDX + 2 * tq;
        const float* ww = ws + 2 * tq * LDW + g;
#pragma unroll
        for (int k8 = 0; k8 < KC / 8; ++k8) {
          if (k8 * 8 >= ncols) break;
          uint32_t ah[4], al[4];
          const float2 top = *reinterpret_cast<const float2*>(xw + k8 * 8);
          const float2 bot =
              *reinterpret_cast<const float2*>(xw + 8 * LDX + k8 * 8);
          const float xa[4] = {top.x, bot.x, top.y, bot.y};
          split_frag(xa, ah, al);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t bh[2], bl[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              split_tf32(ww[(k8 * 8 + e) * LDW + j * 8], bh[e], bl[e]);
            mma_split(acc[j], ah, al, bh, bl);
          }
        }
        if (kc != NK - 1) continue;

        n_runs = tile_runs<TM>(n_e, tile_end, starts, run_pos, run_row, scal,
                               carry_row, scan_from, carry_in, carry_out,
                               f.offs);

        // epilogue.  This thread holds columns 8 j + 2 tq + e of tile rows
        // 16 warp + g (i = 0) and + 8 (i = 1) in acc[j][2 i + e]; tiles j
        // < NT / 2 are the core half.  First z and each half's statistics
        int ge[2];
        bool valid[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = warp * 16 + 8 * i + g;
          valid[i] = t < n_e;
          ge[i] = base + (valid[i] ? t : 0);
          float sum[2] = {0.0f, 0.0f};
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc[j][2 * i + e] += prm[j * 8 + 2 * tq + e];
              sum[j / (NT / 2)] += acc[j][2 * i + e];
            }
#pragma unroll
          for (int h = 0; h < 2; ++h) mu[i][h] = quad_sum(sum[h]) / (float)D;
          float sq[2] = {0.0f, 0.0f};
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dl = acc[j][2 * i + e] - mu[i][j / (NT / 2)];
              sq[j / (NT / 2)] += dl * dl;
            }
#pragma unroll
          for (int h = 0; h < 2; ++h)
            rstd[i][h] = rsqrtf(quad_sum(sq[h]) / (float)D + LN_EPS);
        }

        // then, column pair by column pair, the gate's and the envelopes'
        // cotangents, dzhat (to shared memory) and its row sums, and the
        // tile's column sums of dy zhat and dy
        float m1[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [i][half]
        float m2[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
        float* const pwl = pw + warp * 3 * N2;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          float pls[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [half][e]
          float plb[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
          const int c = j * 8 + 2 * tq;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int t = warp * 16 + 8 * i + g;
            float2 gm = make_float2(0.0f, 0.0f), f1 = gm, f2 = gm;
            if (valid[i]) {
              gm = load2(a.g + (size_t)__ldg(grow + ge[i]) * D + c);
              f1 = load2(f.env + (size_t)row_of(f.env0, ge[i]) * D + c);
              if (MODE == BOND)
                f2 = load2(f.env + (size_t)__ldg(f.env1 + ge[i]) * D + c);
            }
            float dzc[2], dzg[2], de0[2], de1[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float gme = e ? gm.y : gm.x;
              const float fa = e ? f1.y : f1.x, fb = e ? f2.y : f2.x;
              const float hc = (acc[j][2 * i + e] - mu[i][0]) * rstd[i][0];
              const float hg =
                  (acc[j + NT / 2][2 * i + e] - mu[i][1]) * rstd[i][1];
              const float yc = hc * prm[N2 + c + e] + prm[2 * N2 + c + e];
              const float yg =
                  hg * prm[N2 + D + c + e] + prm[2 * N2 + D + c + e];
              const float sc = sigmoid(yc), sg = sigmoid(yg);
              const float silu_c = yc * sc, phi = silu_c * sg;
              float dphi;
              if (MODE == ATOM) {
                dphi = gme * fa;
                de0[e] = gme * phi;
              } else {
                dphi = gme * (fa * fb);
                de0[e] = gme * phi * fb;
                de1[e] = gme * phi * fa;
              }
              const float dyc = dphi * sg * (sc * (1.0f + yc * (1.0f - sc)));
              const float dyg = dphi * silu_c * (sg * (1.0f - sg));
              pls[0][e] += dyc * hc;
              plb[0][e] += dyc;
              pls[1][e] += dyg * hg;
              plb[1][e] += dyg;
              dzc[e] = dyc * prm[N2 + c + e];
              dzg[e] = dyg * prm[N2 + D + c + e];
              m1[i][0] += dzc[e];
              m2[i][0] += dzc[e] * hc;
              m1[i][1] += dzg[e];
              m2[i][1] += dzg[e] * hg;
            }
            *reinterpret_cast<float2*>(dz + t * LDZ + c) =
                make_float2(dzc[0], dzc[1]);
            *reinterpret_cast<float2*>(dz + t * LDZ + D + c) =
                make_float2(dzg[0], dzg[1]);
            if (valid[i]) {
              *reinterpret_cast<float2*>(a.denv0 + (size_t)ge[i] * D + c) =
                  make_float2(de0[0], de0[1]);
              if (MODE == BOND)
                *reinterpret_cast<float2*>(a.denv1 + (size_t)ge[i] * D + c) =
                    make_float2(de1[0], de1[1]);
            }
          }
          // the warp's 16 rows: a sum over the 8 lanes of each tq
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float ls = pls[h][e], lb = plb[h][e];
#pragma unroll
              for (int o = 4; o < 32; o <<= 1) {
                ls += __shfl_xor_sync(0xffffffffu, ls, o);
                lb += __shfl_xor_sync(0xffffffffu, lb, o);
              }
              if (g == 0) {
                pwl[N2 + h * D + c + e] += ls;
                pwl[2 * N2 + h * D + c + e] += lb;
              }
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            m1[i][h] = quad_sum(m1[i][h]) / (float)D;
            m2[i][h] = quad_sum(m2[i][h]) / (float)D;
          }
        // dz = rstd (dzhat - mean dzhat - zhat mean(dzhat zhat)), in place,
        // and the tile's column sums of dz
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int h = j / (NT / 2);
          float pdb[2] = {0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float2* p = reinterpret_cast<float2*>(
                dz + (warp * 16 + 8 * i + g) * LDZ + j * 8 + 2 * tq);
            const float2 dh = *p;
            float r[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float hz = (acc[j][2 * i + e] - mu[i][h]) * rstd[i][h];
              r[e] = rstd[i][h] *
                     ((e ? dh.y : dh.x) - m1[i][h] - hz * m2[i][h]);
              pdb[e] += r[e];
            }
            *p = make_float2(r[0], r[1]);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float sb = pdb[e];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1)
              sb += __shfl_xor_sync(0xffffffffu, sb, o);
            if (g == 0) pwl[j * 8 + 2 * tq + e] += sb;
          }
        }
        continue;
      }

      // pass 2, chunk kc: dW's rows [32 kc, 32 kc + 32) += x_chunk^T dz
      // over the tile's 64 edges, this warp's m16 x n8 tiles of them
      {
        const int mi0 = D >= 16 ? 0 : warp >> 1;
        const int nj0 = D >= 16 ? warp * NJW : warp & 1;
        float* const pdw = part + (size_t)kc * KC * N2;
        float dw[MIW][NJW][4], old[MIW][NJW][4];
#pragma unroll
        for (int m = 0; m < MIW; ++m)
#pragma unroll
          for (int n = 0; n < NJW; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 16 * (mi0 + m) + g + 8 * h;
              float2 o2 = make_float2(0.0f, 0.0f);
              if (tile > 0 && row < ncols)
                o2 = *reinterpret_cast<const float2*>(
                    pdw + (size_t)row * N2 + 8 * (nj0 + n) + 2 * tq);
              old[m][n][2 * h] = o2.x;
              old[m][n][2 * h + 1] = o2.y;
              dw[m][n][2 * h] = 0.0f;
              dw[m][n][2 * h + 1] = 0.0f;
            }
#pragma unroll
        for (int k8 = 0; k8 < TM / 8; ++k8) {
          const float* x0 = xs + (k8 * 8 + tq) * LDX + g;
          const float* z0 = dz + (k8 * 8 + tq) * LDZ + g;
          uint32_t ah[MIW][4], al[MIW][4];
#pragma unroll
          for (int m = 0; m < MIW; ++m) {
            const int r0 = 16 * (mi0 + m);
            const float xa[4] = {x0[r0], x0[r0 + 8], x0[4 * LDX + r0],
                                 x0[4 * LDX + r0 + 8]};
            split_frag(xa, ah[m], al[m]);
          }
#pragma unroll
          for (int n = 0; n < NJW; ++n) {
            const int c0n = 8 * (nj0 + n);
            uint32_t bh[2], bl[2];
            split_tf32(z0[c0n], bh[0], bl[0]);
            split_tf32(z0[4 * LDZ + c0n], bh[1], bl[1]);
#pragma unroll
            for (int m = 0; m < MIW; ++m)
              mma_split(dw[m][n], ah[m], al[m], bh, bl);
          }
        }
#pragma unroll
        for (int m = 0; m < MIW; ++m)
#pragma unroll
          for (int n = 0; n < NJW; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 16 * (mi0 + m) + g + 8 * h;
              if (row < ncols)
                *reinterpret_cast<float2*>(pdw + (size_t)row * N2 +
                                           8 * (nj0 + n) + 2 * tq) =
                    make_float2(dw[m][n][2 * h] + old[m][n][2 * h],
                                dw[m][n][2 * h + 1] + old[m][n][2 * h + 1]);
            }
      }

      // dx's columns [32 kc, 32 kc + 32) = dz W_chunk^T, 2D deep, the
      // warp's 16 rows
      float dx[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dx[n][e] = 0.0f;
      {
        const float* z0 = dz + (warp * 16 + g) * LDZ + tq;
        const float* w0 = ws + g * LDW + tq;
#pragma unroll
        for (int k8 = 0; k8 < N2 / 8; ++k8) {
          uint32_t ah[4], al[4];
          const float xa[4] = {z0[k8 * 8], z0[8 * LDZ + k8 * 8],
                               z0[k8 * 8 + 4], z0[8 * LDZ + k8 * 8 + 4]};
          split_frag(xa, ah, al);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if (n * 8 >= ncols) break;
            uint32_t bh[2], bl[2];
            split_tf32(w0[n * 8 * LDW + k8 * 8], bh[0], bl[0]);
            split_tf32(w0[n * 8 * LDW + k8 * 8 + 4], bh[1], bl[1]);
            mma_split(dx[n], ah, al, bh, bl);
          }
        }
      }
      // the part summed by row to the chunk tile, the others to their
      // edges' rows
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (n * 8 >= ncols) break;
        const int k = kc * KC + n * 8;
        const int p = k / D, col = k % D + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = warp * 16 + g + 8 * h;
          const float2 v2 = make_float2(dx[n][2 * h], dx[n][2 * h + 1]);
          if (p == RS_PART)
            *reinterpret_cast<float2*>(stg + t * LDS + n * 8 + 2 * tq) = v2;
          else if (t < n_e)
            *reinterpret_cast<float2*>(a.dx[p] + (size_t)(base + t) * D +
                                       col) = v2;
        }
      }
      // the chunk's columns of the part summed by row, [lo, hi) of x
      const int lo = max(kc * KC, RS0), hi = min(kc * KC + ncols, RS0 + D);
      if (lo >= hi) continue;

      // the run sums of those columns, wr / 4 threads a run, a float4 of
      // columns each; the carry rows as tile_run_sums'
      __syncthreads();
      {
        const int wr = hi - lo, off = lo - kc * KC, rc = lo - RS0;
        const int g4 = wr / 4, ngrp = CONV_THREADS / g4;
        const int c4 = (tid % g4) * 4;
        const float* crd = carry + ((tile + 1) & 1) * D + rc;
        float* cwr = carry + (tile & 1) * D + rc;
        for (int k = tid / g4; k < n_runs && tid < ngrp * g4; k += ngrp) {
          const int t0 = run_pos[k], t1 = k + 1 < n_runs ? run_pos[k + 1] : n_e;
          float4 s4 = k == 0 && carry_in
                          ? *reinterpret_cast<const float4*>(crd + c4)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int t = t0; t < t1; ++t) {
            const float4 m =
                *reinterpret_cast<const float4*>(stg + t * LDS + off + c4);
            s4.x += m.x;
            s4.y += m.y;
            s4.z += m.z;
            s4.w += m.w;
          }
          if (k == n_runs - 1 && carry_out)
            *reinterpret_cast<float4*>(cwr + c4) = s4;
          else  // the row's last edge: its sum, stored once
            *reinterpret_cast<float4*>(a.dsum + (size_t)run_row[k] * D + rc +
                                       c4) = s4;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp's parameter partials
    if (n_tiles > 0)
      for (int i = tid; i < 3 * N2; i += CONV_THREADS) {
        float s = pw[i];
#pragma unroll
        for (int w2 = 1; w2 < CONV_WARPS; ++w2) s += pw[w2 * 3 * N2 + i];
        part[D_IN * N2 + i] = s;
      }
  }
  if (n_tiles == 0)  // a block with no edges: its partials are zeros
    for (int i = tid; i < S::N_PARAM; i += CONV_THREADS) part[i] = 0.0f;
}

// dparams[i] = the sum of part[c][i] over the blocks c, in block order
constexpr int PARTIAL_THREADS = 256;

__global__ void __launch_bounds__(PARTIAL_THREADS) block_partial_sum_kernel(
    const float* __restrict__ part, float* __restrict__ out, int n,
    int blocks) {
  const int i = blockIdx.x * PARTIAL_THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < blocks; ++c) s += __ldg(part + (size_t)c * n + i);
  out[i] = s;
}

// The edges' cotangent rows summed into the rows they read, up to three
// jobs a launch (blockIdx.y): out[r] += src[p] over the sources p whose id
// is r, in the order of a stable sort of the ids (perm, the sources in
// that order; starts, each row's first position in it, from
// sorted_row_starts_kernel), so the same bits on every run.  Source p is
// edge p % src_rows of copy p / src_rows (the bond conv's e_b scratch
// holds the angles' ij rows, then their ik rows); those of padded edges,
// at or past the real count offs[n_rows], are left out.  The sort keeps
// each row's sources ascending, so each copy's real sources are one run,
// found by binary search in the row's own positions: a row that padded
// edges point at (often all of them) costs no more than its real edges.
// A warp a row, each lane D / 32 columns (a row of D < 32 leaves lanes
// idle); the warp reads 32 sources' positions at a time and each source
// row whole.
constexpr int ROW_SUM_THREADS = 256, ROW_SUM_JOBS = 3, ROW_SUM_COPIES = 2;

struct RowSumJob {
  float* out;
  const float* src;
  const int* starts;
  const long long* perm;
  int n_keys;
  int n_out;
  int src_rows;
};

struct RowSumArgs {
  RowSumJob job[ROW_SUM_JOBS];
  const int* offs;
  int n_rows;
};

// the first i in [lo, hi) with v[i] >= x (hi if none); v ascends there
__device__ __forceinline__ int first_at_least(const long long* __restrict__ v,
                                              int lo, int hi, long long x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(v + mid) < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int D>
__global__ void __launch_bounds__(ROW_SUM_THREADS)
    sorted_row_sum_kernel(const __grid_constant__ RowSumArgs a) {
  constexpr int Q = (D + 31) / 32;
  const RowSumJob& j = a.job[blockIdx.y];
  const int lane = threadIdx.x & 31;
  const int row = (int)blockIdx.x * (ROW_SUM_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= j.n_out || j.src_rows <= 0) return;
  const long long n_real = __ldg(a.offs + a.n_rows);
  const int lo = __ldg(j.starts + row), hi = __ldg(j.starts + row + 1);
  float* const out = j.out + (size_t)row * D;
  float s[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = lane + 32 * q;
    s[q] = c < D ? out[c] : 0.0f;
  }
  const int copies = j.n_keys / j.src_rows;
  int b0 = lo;
  for (int cp = 0; cp < copies && b0 < hi; ++cp) {
    const long long first = (long long)cp * j.src_rows;
    b0 = first_at_least(j.perm, b0, hi, first);
    const int b1 = first_at_least(j.perm, b0, hi, first + n_real);
    for (int b = b0; b < b1; b += 32) {
      const int n = min(32, b1 - b);
      const long long mine = lane < n ? __ldg(j.perm + b + lane) : 0;
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const float* src =
            j.src + (size_t)__shfl_sync(0xffffffffu, mine, t) * D;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int c = lane + 32 * q;
          if (c < D) s[q] += __ldg(src + c);
        }
      }
    }
    b0 = b1;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = lane + 32 * q;
    if (c < D) out[c] = s[q];
  }
}

// starts[r] = the first i with key[i] >= r, r in [0, n_out], over the
// ascending key[0, n_keys): position i writes the rows in (key[i - 1],
// key[i]], clamped to [0, n_out] (the last position, n_keys, the rest), so
// every row once
constexpr int STARTS_THREADS = 256;

__global__ void __launch_bounds__(STARTS_THREADS)
    sorted_row_starts_kernel(const int* __restrict__ key,
                             int* __restrict__ starts, int n_keys,
                             int n_out) {
  const int i = (int)blockIdx.x * STARTS_THREADS + (int)threadIdx.x;
  if (i > n_keys) return;
  const int prev = i == 0 ? -1 : __ldg(key + i - 1);
  const int cur = i == n_keys ? n_out : min(__ldg(key + i), n_out);
  for (int r = max(prev + 1, 0); r <= cur; ++r) starts[r] = i;
}

template <int D>
int launch_row_sums(const RowSumArgs& a, int jobs, cudaStream_t stream) {
  int rows = 0;
  for (int i = 0; i < jobs; ++i) rows = max(rows, a.job[i].n_out);
  if (rows == 0) return 0;
  const int per = ROW_SUM_THREADS / 32;
  sorted_row_sum_kernel<D>
      <<<dim3((rows + per - 1) / per, jobs), ROW_SUM_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// one conv backward: the kernel on the caller's plan (tm, smem, as
// kernels/ops.py conv_bwd_plan), then the sum of its partials
template <int MODE, int D>
int launch_conv_bwd(const ConvBwdArgs& a, int grid, int tm, int smem,
                    cudaStream_t stream) {
  using S = ConvBwdShape<MODE, D>;
  if (tm != S::TM || smem != (int)S::SMEM || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(conv_bwd_kernel<MODE, D>, S::SMEM);
  if (err != cudaSuccess) return (int)err;
  conv_bwd_kernel<MODE, D><<<grid, CONV_THREADS, S::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  block_partial_sum_kernel<<<(S::N_PARAM + PARTIAL_THREADS - 1) /
                                 PARTIAL_THREADS,
                             PARTIAL_THREADS, 0, stream>>>(
      a.part, a.dparams, S::N_PARAM, grid);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch_conv_bwd(const ConvBwdArgs& a, int dim, int grid, int tm,
                      int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 8:
      return launch_conv_bwd<MODE, 8>(a, grid, tm, smem, st);
    case 16:
      return launch_conv_bwd<MODE, 16>(a, grid, tm, smem, st);
    case 32:
      return launch_conv_bwd<MODE, 32>(a, grid, tm, smem, st);
    case 64:
      return launch_conv_bwd<MODE, 64>(a, grid, tm, smem, st);
    case 128:
      return launch_conv_bwd<MODE, 128>(a, grid, tm, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// The caller checks shapes, dtypes (f32 features, int32 ids), contiguity,
// 16-byte aligned tables, D in {8, 16, 32, 64, 128}, and gives the launch
// plan (grid, t_min, tm, smem) of kernels/ops.py conv_bwd_plan.

// The backward of atom_conv_fwd (conv_bwd_kernel<ATOM, D> and the sum of
// its partials): the operands as atom_conv_fwd's, g (n_rows, D) the
// output's cotangent; dv (n_rows, D) zeroed by the caller, which gets
// v[center]'s sums; at each edge's row the cotangent of v[nbr] (dx_nbr),
// of e (dx_e) and of e_a (dx_ea); part (grid x (3D 2D + 6D)) scratch,
// dparams (3D 2D + 6D) = dW | db | dln_scale | dln_bias; the plan of
// kernels/ops.py conv_bwd_plan("atom", ...).
int atom_conv_bwd(const float* v, const float* e, const float* e_a,
                  const float* w, const float* b, const float* ln_scale,
                  const float* ln_bias, const int* center, const int* nbr,
                  const int* pair, const int* offs, const float* g,
                  float* dv, float* dx_nbr, float* dx_e, float* dx_ea,
                  float* part, float* dparams, int n_rows, int dim, int und,
                  int grid, int t_min, int tm, int smem, void* stream) {
  ConvBwdArgs a{};
  a.f.tab0 = v;
  a.f.id0 = center;
  a.f.tab1 = v;
  a.f.id1 = nbr;
  a.f.tab2 = e;
  a.f.id2 = und ? pair : nullptr;
  a.f.env = e_a;
  a.f.env0 = pair;
  a.f.w = w;
  a.f.bias = b;
  a.f.lns = ln_scale;
  a.f.lnb = ln_bias;
  a.f.offs = offs;
  a.f.n_rows = n_rows;
  a.f.t_min = t_min;
  a.g = g;
  a.dsum = dv;
  a.dx[1] = dx_nbr;
  a.dx[2] = dx_e;
  a.denv0 = dx_ea;
  a.part = part;
  a.dparams = dparams;
  return dispatch_conv_bwd<ATOM>(a, dim, grid, tm, smem, stream);
}

// The backward of bond_conv_fwd: the operands as bond_conv_fwd's, g
// (n_rows, D); de (n_rows, D) zeroed by the caller, which gets e[ij]'s
// sums; at each angle's row the cotangent of v[ctr] (dx_ctr), of e[ik]
// (dx_ik), of a (da) and of e_b read at env_ij (denv_ij) and at env_ik
// (denv_ik); part (grid x (4D 2D + 6D)), dparams (4D 2D + 6D); the plan
// of conv_bwd_plan("bond", ...).
int bond_conv_bwd(const float* v, const float* e, const float* a_feat,
                  const float* e_b, const float* w, const float* b,
                  const float* ln_scale, const float* ln_bias,
                  const int* angle_ij, const int* angle_ik,
                  const int* center_ids, const int* env_ij,
                  const int* env_ik, const int* offs, const float* g,
                  float* de, float* dx_ctr, float* dx_ik, float* da,
                  float* denv_ij, float* denv_ik, float* part,
                  float* dparams, int n_rows, int dim, int grid, int t_min,
                  int tm, int smem, void* stream) {
  ConvBwdArgs a{};
  a.f.tab0 = v;
  a.f.id0 = center_ids;
  a.f.tab1 = e;
  a.f.id1 = angle_ij;
  a.f.tab2 = e;
  a.f.id2 = angle_ik;
  a.f.tab3 = a_feat;
  a.f.env = e_b;
  a.f.env0 = env_ij;
  a.f.env1 = env_ik;
  a.f.w = w;
  a.f.bias = b;
  a.f.lns = ln_scale;
  a.f.lnb = ln_bias;
  a.f.offs = offs;
  a.f.n_rows = n_rows;
  a.f.t_min = t_min;
  a.g = g;
  a.dsum = de;
  a.dx[0] = dx_ctr;
  a.dx[2] = dx_ik;
  a.dx[3] = da;
  a.denv0 = denv_ij;
  a.denv1 = denv_ik;
  a.part = part;
  a.dparams = dparams;
  return dispatch_conv_bwd<BOND>(a, dim, grid, tm, smem, stream);
}

// The sums of a conv backward's edge rows into the rows they read
// (sorted_row_sum_kernel), `jobs` (1 to 3) of them, job i: out_i (n_out_i,
// D) += the rows of src_i, by the stable sort of their ids (perm_i, the
// n_keys_i sources in its order; starts_i, n_out_i + 1 row starts from
// sorted_row_starts), a source p being edge p % src_rows_i of copy p /
// src_rows_i (at most 2 copies); offs[n_rows] the conv's real edge count.
int conv_bwd_row_sums(float* out0, const float* src0, const int* starts0,
                      const long long* perm0, float* out1, const float* src1,
                      const int* starts1, const long long* perm1, float* out2,
                      const float* src2, const int* starts2,
                      const long long* perm2, const int* offs, int n_keys0,
                      int n_out0, int src_rows0, int n_keys1, int n_out1,
                      int src_rows1, int n_keys2, int n_out2, int src_rows2,
                      int n_rows, int dim, int jobs, void* stream) {
  if (jobs < 1 || jobs > ROW_SUM_JOBS) return (int)cudaErrorInvalidValue;
  RowSumArgs a{};
  a.job[0] = {out0, src0, starts0, perm0, n_keys0, n_out0, src_rows0};
  a.job[1] = {out1, src1, starts1, perm1, n_keys1, n_out1, src_rows1};
  a.job[2] = {out2, src2, starts2, perm2, n_keys2, n_out2, src_rows2};
  for (int i = 0; i < jobs; ++i)
    if (a.job[i].n_keys > ROW_SUM_COPIES * (long long)a.job[i].src_rows)
      return (int)cudaErrorInvalidValue;
  a.offs = offs;
  a.n_rows = n_rows;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 8:
      return launch_row_sums<8>(a, jobs, st);
    case 16:
      return launch_row_sums<16>(a, jobs, st);
    case 32:
      return launch_row_sums<32>(a, jobs, st);
    case 64:
      return launch_row_sums<64>(a, jobs, st);
    case 128:
      return launch_row_sums<128>(a, jobs, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The first position of each row r in [0, n_out] in the ascending ids
// key[0, n_keys) (sorted_row_starts_kernel): starts (n_out + 1).
int sorted_row_starts(const int* key, int* starts, int n_keys, int n_out,
                      void* stream) {
  const int n = n_keys + 1;
  sorted_row_starts_kernel<<<(n + STARTS_THREADS - 1) / STARTS_THREADS,
                             STARTS_THREADS, 0, (cudaStream_t)stream>>>(
      key, starts, n_keys, n_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
