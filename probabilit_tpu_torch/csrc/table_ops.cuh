// table_ops.cuh: the graph megakernel's table rows, a guide-indexed search
// in shared memory.
//
// Replaces the table branch of probabilit_tpu/engine/pallas_exec.py::_make_kernel
// (_select_tree, _kernel_table_ppf, _kernel_discrete, _kernel_interp).  A TPU
// has no vector gather, so the Pallas kernel evaluates a balanced tree of n
// compares and n selects over host-constant knots for every element.  Here
// each block holds the tables in shared memory (engine/cuda_exec.py copies
// Tape.tables there) and each lane looks its quantile up.
//
// What bounds it: issue and shared memory.  The full binary search is
// ceil(log2 NB) + 1 dependent loads, compares and selects a lane, and at NB
// near a power of two (a 512-point Empirical or Discrete) the candidates
// of a level sit 2^k words apart, in one bank: a load of 32 lanes takes up
// to 32 wavefronts.  Every table searches boundaries in quantile space,
// [0, 1] (a trimmed CDF table, a Discrete's cumulative probabilities, a
// Cumulative's q, an Empirical's linspace), so the design is the inversion
// guide of Chen and Asau (1974): a table row with a guide of M cells (a
// power of two) reads word j = floor(q M), clamped to [0, M).  Cell j holds
// the boundaries from lo_j = #{b < j / M} to lo_{j+1} (cell 0 from 0, the
// last to NB): every boundary below it is below q and every boundary past
// it above q, under either predicate.  A cell of at most W boundaries (the
// window, a literal of the row) stores the first boundary of a window of W
// that holds it, min(lo_j, NB - W), and the count is that plus a
// branch-free search of the window, log2(W) + 1 loads at constant offsets;
// a crowded cell (a CDF table's tails) stores a negative word and its lanes
// run the full search.  So the count is the full search's for any q (a
// NaN q reads cell 0 and the row's NaN select wins), bitwise, with 1 +
// log2(W) + 1 loads for most lanes where the full search takes 10, and a
// warp takes both paths where its lanes split.  M and W come from the
// tape's structure (cuda_exec.guide_cells), never from the boundaries'
// values; a table of at most 8 boundaries (a full search of at most four
// loads), or whose guide did not fit, runs the full search (M = 1).
//
// Layouts (engine/cuda_exec.py::table_data), every section padded to a
// multiple of four floats, pad4(n) = n rounded up to a multiple of 4:
//   table_cdf      t[0 .. NB): boundaries (the trimmed CDF table but its last)
//   table_discrete t[0 .. NB): boundaries; t[pad4(NB) ..): the NB + 1 values
//   table_interp   t[0 .. NB): boundaries xp[:-1]; t[pad4(NB) ..): NB + 1
//                  float4 leaves (x0, f0, slope, 0); then (xp[-1], fp[-1], 0, 0)
// and after every section the guides, M 32-bit words each
// (cuda_exec.table_guide).  Each row transcribes its plain twin,
// cuda_exec._table_row, operation for operation: the interval's arithmetic
// is rounded once per operation (__fsub_rn, __fmul_rn, __fadd_rn: no
// contraction into an FMA), so kernel and twin agree bitwise.  A NaN
// quantile gives NaN, so the non-finite flag sees it.  The gather after the
// count (a Discrete's value, an interval's float4 leaf) reads the twin's
// layout as it is.  ops/table_search.py transcribes the lookup and counts
// its loads.

#pragma once

#include <cstdint>
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

// The same count through a guide of `cells` words and a window of
// `window` boundaries (1, 2, 4 or 8; a literal of the row): the word of
// cell floor(q cells) is the first boundary of the window that holds the
// cell (the branch-free search of `window` boundaries from there, one load
// a step), or, for a cell of more than `window` boundaries, negative (the
// full search).
template <int NB, bool kStrict>
__device__ __forceinline__ int guided_count(const float* __restrict__ b,
                                            const uint32_t* __restrict__ guide, int cells,
                                            int window, float q) {
  // q * cells is exact (cells is a power of two); cvt.rzi.u32 gives 0 for
  // NaN and for q < 0.
  const unsigned j = min(__float2uint_rz(q * static_cast<float>(cells)), cells - 1u);
  const int base = static_cast<int>(guide[j]);
  if (base < 0) return Search<NB, kStrict>::count(b, 0, q);
  switch (window) {
    case 1: return Search<1, kStrict>::count(b, base, q);
    case 2: return Search<2, kStrict>::count(b, base, q);
    case 4: return Search<4, kStrict>::count(b, base, q);
    default: return Search<8, kStrict>::count(b, base, q);
  }
}

// pallas_exec._kernel_table_ppf: the count of boundaries below q; the row
// after it adds the table's loc.
template <int NB>
__device__ __forceinline__ float table_cdf(const float* __restrict__ t, float q) {
  const float count = static_cast<float>(Search<NB, true>::count(t, 0, q));
  return isnan(q) ? q : count;
}

template <int NB>
__device__ __forceinline__ float table_cdf(const float* __restrict__ t, float q,
                                           const uint32_t* __restrict__ guide, int cells,
                                           int window) {
  const float count = static_cast<float>(guided_count<NB, true>(t, guide, cells, window, q));
  return isnan(q) ? q : count;
}

// pallas_exec._kernel_discrete: the value at the count of boundaries at or
// below q.
template <int NB>
__device__ __forceinline__ float table_discrete(const float* __restrict__ t, float q) {
  const float value = t[pad4(NB) + Search<NB, false>::count(t, 0, q)];
  return isnan(q) ? q : value;
}

template <int NB>
__device__ __forceinline__ float table_discrete(const float* __restrict__ t, float q,
                                                const uint32_t* __restrict__ guide, int cells,
                                                int window) {
  const float value = t[pad4(NB) + guided_count<NB, false>(t, guide, cells, window, q)];
  return isnan(q) ? q : value;
}

// pallas_exec._kernel_interp: interval i (the count of boundaries at or
// below q) is f0 + (q - x0) * slope, and q >= xp[-1] gives fp[-1].
template <int NB>
__device__ __forceinline__ float interp_leaf(const float* __restrict__ t, int interval,
                                             float q) {
  const float4* leaves = reinterpret_cast<const float4*>(t + pad4(NB));
  const float4 leaf = leaves[interval];
  const float4 tail = leaves[NB + 1];
  const float value = __fadd_rn(leaf.y, __fmul_rn(__fsub_rn(q, leaf.x), leaf.z));
  return q >= tail.x ? tail.y : value;
}

template <int NB>
__device__ __forceinline__ float table_interp(const float* __restrict__ t, float q) {
  return interp_leaf<NB>(t, Search<NB, false>::count(t, 0, q), q);
}

template <int NB>
__device__ __forceinline__ float table_interp(const float* __restrict__ t, float q,
                                              const uint32_t* __restrict__ guide, int cells,
                                              int window) {
  return interp_leaf<NB>(t, guided_count<NB, false>(t, guide, cells, window, q), q);
}

}  // namespace table_ops
