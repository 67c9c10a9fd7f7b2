// Sorted-segment sums for Hopper (sm_90a): the aggregation of the unfused
// message path at agg_impl="pallas", and phase B of the symmetric bond
// conv, in f32 and bf16.
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
// bf16 (DESIGN.md §4, the mixed tiers): segment_sum_bf16_fwd reads bf16
// values and sym_accum_bf16_fwd reads phase A's f32 messages; both sum in
// f32 in the same CSR order and store bf16, each output element rounded to
// nearest once, as the JAX kernels' f32 accumulators are cast back by their
// wrappers (ops.py:370 and :895 of the JAX package).  A bf16 column group
// is eight values (one 16-byte load) where D % 8 == 0 and the input is
// 16-byte aligned; the force head's D = 3 rows (6 bytes) take the scalar
// path.  Bound by bytes as in f32, with half the bytes read and written
// (kernel 6 still reads f32 messages).
//
// TPU mechanics that are not carried over: the windowed one-hot MXU
// contraction per 256-edge chunk becomes plain loads and adds, the lanes
// are not padded to 128, and the VMEM/HBM residency tiers collapse into
// one lowering that reads device memory directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One 16-byte group of a row: G = 4 floats or 8 bf16, widened exactly and
// added column by column
template <typename TIn, int G>
__device__ __forceinline__ void add_group(float (&acc)[G], const TIn* p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (std::is_same<TIn, float>::value) {
      acc[k] += __uint_as_float(w[k]);
    } else {
      acc[2 * k] += __uint_as_float(w[k] << 16);
      acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// G sums stored as TOut: 16 bytes of f32 a float4, bf16 rounded to nearest
// (8 or 16 bytes)
template <typename TOut, int G>
__device__ __forceinline__ void store_group(TOut* p, const float (&acc)[G]) {
  if constexpr (std::is_same<TOut, float>::value) {
#pragma unroll
    for (int k = 0; k < G / 4; ++k)
      reinterpret_cast<float4*>(p)[k] = make_float4(
          acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  } else if constexpr (G == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                   pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
  } else {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]));
  }
}

// VEC: 16-byte column groups of G = 16 / sizeof(TIn) values, else one
// column a thread.  GATHER: the value row of edge e is rep[e], else e.
template <typename TIn, typename TOut, bool VEC, bool GATHER>
__global__ void segment_sum_kernel(const TIn* __restrict__ values,
                                   const int* __restrict__ rep,
                                   const int* __restrict__ offs,
                                   TOut* __restrict__ out, int n_rows,
                                   int dim) {
  constexpr int G = VEC ? 16 / (int)sizeof(TIn) : 1;
  const int groups = dim / G;
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long long)n_rows * groups) return;
  const int row = (int)(item / groups);
  const int g = (int)(item - (long long)row * groups);
  const int start = offs[row], end = offs[row + 1];
  float acc[G];
#pragma unroll
  for (int k = 0; k < G; ++k) acc[k] = 0.0f;
  for (int e = start; e < end; ++e) {
    const int src_row = GATHER ? __ldg(rep + e) : e;
    const TIn* src = values + (size_t)src_row * dim + (size_t)g * G;
    if constexpr (VEC) {
      add_group<TIn, G>(acc, src);
    } else {
      acc[0] += to_f32(src[0]);
    }
  }
  TOut* dst = out + (size_t)row * dim + (size_t)g * G;
  if constexpr (VEC) {
    store_group<TOut, G>(dst, acc);
  } else {
    store1(dst, acc[0]);
  }
}

template <typename TIn, typename TOut, bool GATHER>
int launch_segment_sum(const TIn* values, const int* rep, const int* offs,
                       TOut* out, int n_rows, int dim, int vec,
                       void* stream) {
  if (n_rows == 0 || dim == 0) return 0;
  constexpr int G = 16 / (int)sizeof(TIn);
  const long long items = (long long)n_rows * (vec ? dim / G : dim);
  const int grid = (int)((items + THREADS - 1) / THREADS);
  if (vec) {
    segment_sum_kernel<TIn, TOut, true, GATHER>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(values, rep, offs, out,
                                                     n_rows, dim);
  } else {
    segment_sum_kernel<TIn, TOut, false, GATHER>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(values, rep, offs, out,
                                                     n_rows, dim);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = ok).  The caller
// checks shapes, dtypes (f32 values, int32 offsets of length n_rows + 1),
// contiguity, and passes vec = 1 only where dim % 4 == 0 and values is
// 16-byte aligned.
int segment_sum_fwd(const float* values, const int* offs, float* out,
                    int n_rows, int dim, int vec, void* stream) {
  return launch_segment_sum<float, float, false>(values, nullptr, offs, out,
                                                 n_rows, dim, vec, stream);
}

// bf16 values and output (f32 sums); vec = 1 only where dim % 8 == 0 and
// values is 16-byte aligned.
int segment_sum_bf16_fwd(const bf16* values, const int* offs, bf16* out,
                         int n_rows, int dim, int vec, void* stream) {
  return launch_segment_sum<bf16, bf16, false>(values, nullptr, offs, out,
                                               n_rows, dim, vec, stream);
}

// Phase B of the symmetric bond conv: out (n_rows, dim) from the messages
// msg and the dest-sorted incidences (rep, offs of length n_rows + 1); the
// same checks, vec where dim % 4 == 0 and msg is 16-byte aligned.
int sym_accum_fwd(const float* msg, const int* rep, const int* offs,
                  float* out, int n_rows, int dim, int vec, void* stream) {
  return launch_segment_sum<float, float, true>(msg, rep, offs, out, n_rows,
                                                dim, vec, stream);
}

// The same from f32 messages into a bf16 output (f32 sums, rounded once).
int sym_accum_bf16_fwd(const float* msg, const int* rep, const int* offs,
                       bf16* out, int n_rows, int dim, int vec,
                       void* stream) {
  return launch_segment_sum<float, bf16, true>(msg, rep, offs, out, n_rows,
                                               dim, vec, stream);
}

}  // extern "C"
