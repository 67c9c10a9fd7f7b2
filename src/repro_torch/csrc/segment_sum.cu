// Sorted-segment sums for Hopper (sm_90a): the aggregation of the unfused
// message path at agg_impl="pallas", and phase B of the symmetric bond
// conv.
//
//   segment_sum_fwd  replaces fused_segment_sum_pallas
//                    (src/repro/kernels/fused_segment_sum.py:99; kernel
//                    bodies _kernel :45 and _kernel_hbm :72)
//   sym_accum_fwd    replaces fused_sym_accum_pallas
//                    (src/repro/kernels/fused_message_passing.py:1163;
//                    bodies _sym_accum_kernel :1112, _hbm :1136)
//
// out[s, :] = sum of values[e, :] over e in [offs[s], offs[s+1]), in CSR
// order, for s in [0, S).  Rows are the destination-sorted CSR segments of
// the batch layout (DESIGN.md §1): offs[S] is the number of real edges and
// the padded tail past it, whose ids alias row 0, is never read.  An empty
// row, every padded row among them, is written as 0.  The segment ids are
// not read: every walk is bounded by the offsets.
//
// Bound on this card: one add per element read, so it is bound by bytes.
// At batch 128 the atom convs reduce 97k real bonds of width 64 into 6,400
// rows (25 MB read) and the bond convs 81k real angles into 394k rows,
// whose 101 MB of mostly-zero output dominate; the force head reduces
// width 3.  The design therefore streams each byte once, coalesced: thread
// i of the grid owns one (row, column group) pair, neighbouring threads
// own neighbouring columns of a row and then the next row, whose edges
// follow in memory, so a warp reads consecutive addresses.  A column group
// is four floats (one 16-byte load) where D % 4 == 0 and the input is
// 16-byte aligned, else one float, so D = 3 runs on the scalar path.  Each
// thread adds its row's edges in order into registers: no shared memory,
// no atomics, the same result from run to run.
//
// sym_accum_fwd is the same walk with one indirection (DESIGN.md §10):
// out[u, :] = sum of msg[rep[t], :] over u's incidences t in [offs[u],
// offs[u+1]), in CSR order.  Each real dedup-angle message lands on the two
// undirected bonds of its pair, so at batch 128 it reads ~81k message rows
// (of ~41k distinct ones) into 197k bond rows: bound by bytes, the mostly
// zero output dominating.  Threads of a row read the same rep entry (a
// broadcast) and neighbouring columns of one message row.
//
// TPU mechanics that are not carried over: the windowed one-hot MXU
// contraction per 256-edge chunk becomes plain loads and adds, the lanes
// are not padded to 128, and the VMEM/HBM residency tiers collapse into
// one lowering that reads device memory directly.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// GATHER: the value row of edge e is rep[e], else e.
template <bool VEC4, bool GATHER>
__global__ void segment_sum_kernel(const float* __restrict__ values,
                                   const int* __restrict__ rep,
                                   const int* __restrict__ offs,
                                   float* __restrict__ out, int n_rows,
                                   int dim) {
  const int groups = VEC4 ? dim / 4 : dim;
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long long)n_rows * groups) return;
  const int row = (int)(item / groups);
  const int g = (int)(item - (long long)row * groups);
  const int start = offs[row], end = offs[row + 1];
  if (VEC4) {
    const float4* src = reinterpret_cast<const float4*>(values);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int e = start; e < end; ++e) {
      const int src_row = GATHER ? __ldg(rep + e) : e;
      const float4 x = __ldg(src + (size_t)src_row * groups + g);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    reinterpret_cast<float4*>(out)[(size_t)row * groups + g] = acc;
  } else {
    float acc = 0.0f;
    for (int e = start; e < end; ++e) {
      const int src_row = GATHER ? __ldg(rep + e) : e;
      acc += __ldg(values + (size_t)src_row * dim + g);
    }
    out[(size_t)row * dim + g] = acc;
  }
}

template <bool GATHER>
int launch_segment_sum(const float* values, const int* rep, const int* offs,
                       float* out, int n_rows, int dim, int vec4,
                       void* stream) {
  if (n_rows == 0 || dim == 0) return 0;
  const long long items = (long long)n_rows * (vec4 ? dim / 4 : dim);
  const int grid = (int)((items + THREADS - 1) / THREADS);
  if (vec4) {
    segment_sum_kernel<true, GATHER><<<grid, THREADS, 0,
                                       (cudaStream_t)stream>>>(
        values, rep, offs, out, n_rows, dim);
  } else {
    segment_sum_kernel<false, GATHER><<<grid, THREADS, 0,
                                        (cudaStream_t)stream>>>(
        values, rep, offs, out, n_rows, dim);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).  The caller
// checks shapes, dtypes (f32 values, int32 offsets of length n_rows + 1),
// contiguity, and passes vec4 = 1 only where dim % 4 == 0 and values is
// 16-byte aligned.
int segment_sum_fwd(const float* values, const int* offs, float* out,
                    int n_rows, int dim, int vec4, void* stream) {
  return launch_segment_sum<false>(values, nullptr, offs, out, n_rows, dim,
                                   vec4, stream);
}

// Phase B of the symmetric bond conv: out (n_rows, dim) from the messages
// msg and the dest-sorted incidences (rep, offs of length n_rows + 1); the
// same checks, vec4 where dim % 4 == 0 and msg is 16-byte aligned.
int sym_accum_fwd(const float* msg, const int* rep, const int* offs,
                  float* out, int n_rows, int dim, int vec4, void* stream) {
  return launch_segment_sum<true>(msg, rep, offs, out, n_rows, dim, vec4,
                                  stream);
}

}  // extern "C"
