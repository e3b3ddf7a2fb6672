// table_ops.cuh: the graph megakernel's table rows, a search in shared memory.
//
// Replaces the table branch of probabilit_tpu/engine/pallas_exec.py::_make_kernel
// (_select_tree, _kernel_table_ppf, _kernel_discrete, _kernel_interp).  A TPU
// has no vector gather, so the Pallas kernel evaluates a balanced tree of n
// compares and n selects over host-constant knots for every element.  Here
// each block holds the tables in shared memory (engine/cuda_exec.py copies
// Tape.tables there), and each lane runs a branch-free binary search: with
// NB boundaries, ceil(log2(NB)) + 1 loads and compares, the same for every
// lane, so the warp never diverges.  The thread's four lanes search side by
// side, four independent chains.  What bounds it: the dependent chain of
// shared-memory loads (about 30 cycles each) when few warps are resident;
// random addresses also cost bank conflicts, which this first version
// leaves alone.
//
// Layouts (engine/cuda_exec.py::table_data), every section padded to a
// multiple of four floats, pad4(n) = n rounded up to a multiple of 4:
//   table_cdf      t[0 .. NB): boundaries (the trimmed CDF table but its last)
//   table_discrete t[0 .. NB): boundaries; t[pad4(NB) ..): the NB + 1 values
//   table_interp   t[0 .. NB): boundaries xp[:-1]; t[pad4(NB) ..): NB + 1
//                  float4 leaves (x0, f0, slope, 0); then (xp[-1], fp[-1], 0, 0)
// Each transcribes its plain twin, cuda_exec._table_row, operation for
// operation: the interval's arithmetic is rounded once per operation
// (__fsub_rn, __fmul_rn, __fadd_rn: no contraction into an FMA), so kernel
// and twin agree bitwise.  A NaN quantile gives NaN, so the non-finite flag
// sees it.

#pragma once

#include <cuda_runtime.h>

namespace table_ops {

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// The count of boundaries b[0 .. N) below q (kStrict: b < q, searchsorted
// side "left") or at or below it (b <= q, side "right"), for sorted b: the
// branch-free lower bound, one step a level, unrolled by the template.
template <int N, bool kStrict>
struct Search {
  static __device__ __forceinline__ int count(const float* __restrict__ b, int base, float q) {
    constexpr int kHalf = N / 2;
    const float v = b[base + kHalf];
    base = (kStrict ? v < q : v <= q) ? base + kHalf : base;
    return Search<N - kHalf, kStrict>::count(b, base, q);
  }
};

template <bool kStrict>
struct Search<1, kStrict> {
  static __device__ __forceinline__ int count(const float* __restrict__ b, int base, float q) {
    return base + ((kStrict ? b[base] < q : b[base] <= q) ? 1 : 0);
  }
};

template <bool kStrict>
struct Search<0, kStrict> {
  static __device__ __forceinline__ int count(const float*, int, float) { return 0; }
};

// pallas_exec._kernel_table_ppf: the count of boundaries below q; the row
// after it adds the table's loc.
template <int NB>
__device__ __forceinline__ float table_cdf(const float* __restrict__ t, float q) {
  const float count = static_cast<float>(Search<NB, true>::count(t, 0, q));
  return isnan(q) ? q : count;
}

// pallas_exec._kernel_discrete: the value at the count of boundaries at or
// below q.
template <int NB>
__device__ __forceinline__ float table_discrete(const float* __restrict__ t, float q) {
  const float value = t[pad4(NB) + Search<NB, false>::count(t, 0, q)];
  return isnan(q) ? q : value;
}

// pallas_exec._kernel_interp: interval i (the count of boundaries at or
// below q) is f0 + (q - x0) * slope, and q >= xp[-1] gives fp[-1].
template <int NB>
__device__ __forceinline__ float table_interp(const float* __restrict__ t, float q) {
  const float4* leaves = reinterpret_cast<const float4*>(t + pad4(NB));
  const float4 leaf = leaves[Search<NB, false>::count(t, 0, q)];
  const float4 tail = leaves[NB + 1];
  const float value = __fadd_rn(leaf.y, __fmul_rn(__fsub_rn(q, leaf.x), leaf.z));
  return q >= tail.x ? tail.y : value;
}

}  // namespace table_ops
