// graph_megakernel.cu: the whole sampling pass of a graph in one kernel.
//
// Replaces probabilit_tpu/engine/pallas_exec.py::_make_kernel (the TPU's
// per-graph Pallas megakernel).  Like it, the kernel draws one uniform per
// distribution node and sample, pushes it through the node's inverse CDF,
// evaluates every transform in topological order, and writes only the
// kept nodes: no quantile matrix and no intermediate reaches device memory.
//
// What bounds it on an H100: ALU work, not memory.  A sample of the
// flagship 20-node graph costs 8 Philox4x32-10 draws (10 rounds of two
// 32x32->64-bit multiplies each) and 8 inverse CDFs (a log, two short
// polynomials, exp/sqrt/log1p), a few hundred 32-bit operations in all,
// while its only traffic is 4 bytes per kept node: the sink of n = 1e8
// samples is 400 MB, about 0.12 ms at 3.35 TB/s.
//
// What the design does about it: every value stays in registers or
// thread-local slots; threads are independent (a grid-stride loop, no
// shared state but the tape), so the card's integer and float pipes are
// the only limit.  The kernel is not specialised per graph: it interprets
// a small tape (engine/cuda_exec.py::lower) held in shared memory, so one
// nvcc build serves every graph.  Interpretation costs a branch per
// instruction and slot traffic; per-graph code generation is later work.
//
// Random bits: Philox4x32-10 (Salmon et al., SC'11), key = the two seed
// words, counter = (i mod 2^32, i >> 32, column, 0) for global sample
// i = start + (row of the output); word 0 is used.  The stream depends on
// the seed only, not on the grid, so a streamed block that starts at
// sample b*B draws rows b*B.. of the seed's one stream.
// ops/philox.py computes the same words in PyTorch.
//
// Correlated graphs (the recolour branch of the TPU kernel,
// pallas_exec.py:542-560): SCORE k puts z_k = ndtri_fast(u) of a drawn
// column into a register array z[16]; RECOLOR i computes
// y_i = b_i + sum_j A_ij z_j with (A, b) from corr_stats.cu's statistics
// (engine/cuda_exec.py::recolor_transform), held in shared memory; then
// SCORE_NORM / SCORE_LOGNORM evaluate ppf(ndtr(y)) in closed form, or NDTR
// gives clamp_open_unit(ndtr_fast(y)) for the variable's own ppf.  (A, b)
// is a separate device array, not a tape immediate: it is known only
// after the statistics pass.  z is indexed through unrolled predicated
// loops over kMaxCorr, so it stays in registers.
//
// Math: the device functions (sampling_math.cuh) transcribe ops/special.py
// and ops/ppf.py.  nvcc contracts a*b+c into FMAs by default and
// PyTorch's eager ops do not, so results differ from the plain version by
// a few ulps (more in the normal tails); chip_smoke.py measures the
// difference.

#include <cstdint>
#include <cuda_runtime.h>

#include "sampling_math.cuh"

namespace {

using sampling_math::bits_to_open_unit;
using sampling_math::clamp_open_unit;
using sampling_math::ndtr_fast;
using sampling_math::ndtri_fast;
using sampling_math::philox_word0;

// Must equal MAX_SLOTS / MAX_INSTR / MAX_CORR_K in engine/cuda_exec.py.
constexpr int kMaxSlots = 64;
constexpr int kMaxInstr = 1024;
constexpr int kMaxCorr = 16;
constexpr int kFields = 6;  // [opcode, dst, a, b, c, d]
constexpr int kThreads = 256;

// Same names, same order as cuda_exec.OPCODES.
enum Op : int {
  OP_DRAW,
  OP_LOADK,
  OP_STORE,
  OP_SCORE,
  OP_RECOLOR,
  OP_NDTR,
  OP_PPF_UNIFORM,
  OP_PPF_NORM,
  OP_PPF_EXPON,
  OP_PPF_LOGNORM,
  OP_PPF_TRIANG,
  OP_SCORE_NORM,
  OP_SCORE_LOGNORM,
  OP_ADD,
  OP_MUL,
  OP_MAX,
  OP_MIN,
  OP_AND,
  OP_OR,
  OP_FLOORDIV,
  OP_MOD,
  OP_DIV,
  OP_POW,
  OP_SUB,
  OP_EQ,
  OP_NE,
  OP_LT,
  OP_LE,
  OP_GT,
  OP_GE,
  OP_ISCLOSE,
  OP_ATAN2,
  OP_NEG,
  OP_ABS,
  OP_LOG,
  OP_EXP,
  OP_FLOOR,
  OP_CEIL,
  OP_SIGN,
  OP_SQRT,
  OP_SQUARE,
  OP_LOG10,
  OP_SIN,
  OP_COS,
  OP_TAN,
  OP_ASIN,
  OP_ACOS,
  OP_ATAN,
  OP_SINH,
  OP_COSH,
  OP_TANH,
  OP_ASINH,
  OP_ACOSH,
  OP_ATANH,
  OP_LOG1P,
  OP_EXPM1,
};

// torch.floor_divide on floats (ATen's div_floor_floating).
__device__ __forceinline__ float floor_divide(float a, float b) {
  if (b == 0.0f) return a / b;
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div -= 1.0f;
  if (div == 0.0f) return copysignf(0.0f, a / b);
  float floordiv = floorf(div);
  if (div - floordiv > 0.5f) floordiv += 1.0f;
  return floordiv;
}

// jnp.mod / torch.remainder: the result takes the divisor's sign.
__device__ __forceinline__ float floor_mod(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

// torch.maximum / torch.minimum propagate NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// jnp.isclose / torch.isclose with rtol = 1e-5, atol = 1e-8.
__device__ __forceinline__ bool isclose(float a, float b) {
  if (a == b) return true;
  const float diff = fabsf(a - b);
  return isfinite(diff) && diff <= 1e-8f + fabsf(1e-5f * b);
}

// jnp.sign: NaN stays NaN, zeros keep their value.
__device__ __forceinline__ float sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__global__ void __launch_bounds__(kThreads)
    graph_megakernel(const int* __restrict__ code, const float* __restrict__ imm,
                     int n_instr, const float* __restrict__ ab, int n_corr, uint32_t k0,
                     uint32_t k1, int64_t start, int64_t n, float* __restrict__ out,
                     int* __restrict__ nonfinite) {
  // The tape, sized at launch: n_instr * kFields ints, n_instr floats,
  // then the recolour transform: A (n_corr x n_corr, row-major) and b.
  extern __shared__ int s_code[];
  float* s_imm = reinterpret_cast<float*>(s_code + n_instr * kFields);
  float* s_ab = s_imm + n_instr;
  for (int t = threadIdx.x; t < n_instr * kFields; t += blockDim.x) s_code[t] = code[t];
  for (int t = threadIdx.x; t < n_instr; t += blockDim.x) s_imm[t] = imm[t];
  for (int t = threadIdx.x; t < n_corr * n_corr + n_corr; t += blockDim.x) s_ab[t] = ab[t];
  __syncthreads();

  float slot[kMaxSlots];
  float z[kMaxCorr];
#pragma unroll
  for (int j = 0; j < kMaxCorr; ++j) z[j] = 0.0f;
  bool bad = false;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    for (int p = 0; p < n_instr; ++p) {
      const int* ins = s_code + p * kFields;
      const int op = ins[0];
      if (op == OP_STORE) {
        const float v = slot[ins[2]];
        out[static_cast<int64_t>(ins[1]) * n + i] = v;
        bad |= !isfinite(v);
        continue;
      }
      float r;
      switch (op) {
        case OP_DRAW:
          r = bits_to_open_unit(philox_word0(static_cast<uint64_t>(start + i),
                                             static_cast<uint32_t>(ins[2]), k0, k1));
          break;
        case OP_LOADK: r = s_imm[p]; break;
        case OP_SCORE: {  // dst is the score's index k, a the drawn column.
          const float score = ndtri_fast(slot[ins[2]]);
          const int k = ins[1];
#pragma unroll
          for (int j = 0; j < kMaxCorr; ++j) {
            if (j == k) z[j] = score;
          }
          continue;
        }
        case OP_RECOLOR: {  // a is the variable's index i.
          const float* a_row = s_ab + ins[2] * n_corr;
          r = s_ab[n_corr * n_corr + ins[2]];
#pragma unroll
          for (int j = 0; j < kMaxCorr; ++j) {
            if (j < n_corr) r = r + a_row[j] * z[j];
          }
          break;
        }
        case OP_NDTR: r = clamp_open_unit(ndtr_fast(slot[ins[2]])); break;
        case OP_SCORE_NORM: r = slot[ins[3]] + slot[ins[4]] * slot[ins[2]]; break;
        case OP_SCORE_LOGNORM:
          r = slot[ins[4]] + slot[ins[5]] * expf(slot[ins[3]] * slot[ins[2]]);
          break;
        // ops/ppf.py: q in a; then the family's parameters in b, c, d.
        case OP_PPF_UNIFORM: r = slot[ins[3]] + slot[ins[4]] * slot[ins[2]]; break;
        case OP_PPF_NORM: r = slot[ins[3]] + slot[ins[4]] * ndtri_fast(slot[ins[2]]); break;
        case OP_PPF_EXPON: r = slot[ins[3]] - slot[ins[4]] * log1pf(-slot[ins[2]]); break;
        case OP_PPF_LOGNORM:
          r = slot[ins[4]] + slot[ins[5]] * expf(slot[ins[3]] * ndtri_fast(slot[ins[2]]));
          break;
        case OP_PPF_TRIANG: {
          const float q = slot[ins[2]], c = slot[ins[3]];
          const float left = sqrtf(q * c);
          const float right = 1.0f - sqrtf((1.0f - q) * (1.0f - c));
          r = slot[ins[4]] + slot[ins[5]] * (q <= c ? left : right);
          break;
        }
        case OP_ADD: r = slot[ins[2]] + slot[ins[3]]; break;
        case OP_MUL: r = slot[ins[2]] * slot[ins[3]]; break;
        case OP_MAX: r = nan_max(slot[ins[2]], slot[ins[3]]); break;
        case OP_MIN: r = nan_min(slot[ins[2]], slot[ins[3]]); break;
        case OP_AND: r = (slot[ins[2]] != 0.0f && slot[ins[3]] != 0.0f) ? 1.0f : 0.0f; break;
        case OP_OR: r = (slot[ins[2]] != 0.0f || slot[ins[3]] != 0.0f) ? 1.0f : 0.0f; break;
        case OP_FLOORDIV: r = floor_divide(slot[ins[2]], slot[ins[3]]); break;
        case OP_MOD: r = floor_mod(slot[ins[2]], slot[ins[3]]); break;
        case OP_DIV: r = slot[ins[2]] / slot[ins[3]]; break;
        case OP_POW: r = powf(slot[ins[2]], slot[ins[3]]); break;
        case OP_SUB: r = slot[ins[2]] - slot[ins[3]]; break;
        case OP_EQ: r = slot[ins[2]] == slot[ins[3]] ? 1.0f : 0.0f; break;
        case OP_NE: r = slot[ins[2]] != slot[ins[3]] ? 1.0f : 0.0f; break;
        case OP_LT: r = slot[ins[2]] < slot[ins[3]] ? 1.0f : 0.0f; break;
        case OP_LE: r = slot[ins[2]] <= slot[ins[3]] ? 1.0f : 0.0f; break;
        case OP_GT: r = slot[ins[2]] > slot[ins[3]] ? 1.0f : 0.0f; break;
        case OP_GE: r = slot[ins[2]] >= slot[ins[3]] ? 1.0f : 0.0f; break;
        case OP_ISCLOSE: r = isclose(slot[ins[2]], slot[ins[3]]) ? 1.0f : 0.0f; break;
        case OP_ATAN2: r = atan2f(slot[ins[2]], slot[ins[3]]); break;
        case OP_NEG: r = -slot[ins[2]]; break;
        case OP_ABS: r = fabsf(slot[ins[2]]); break;
        case OP_LOG: r = logf(slot[ins[2]]); break;
        case OP_EXP: r = expf(slot[ins[2]]); break;
        case OP_FLOOR: r = floorf(slot[ins[2]]); break;
        case OP_CEIL: r = ceilf(slot[ins[2]]); break;
        case OP_SIGN: r = sign(slot[ins[2]]); break;
        case OP_SQRT: r = sqrtf(slot[ins[2]]); break;
        case OP_SQUARE: r = slot[ins[2]] * slot[ins[2]]; break;
        case OP_LOG10: r = log10f(slot[ins[2]]); break;
        case OP_SIN: r = sinf(slot[ins[2]]); break;
        case OP_COS: r = cosf(slot[ins[2]]); break;
        case OP_TAN: r = tanf(slot[ins[2]]); break;
        case OP_ASIN: r = asinf(slot[ins[2]]); break;
        case OP_ACOS: r = acosf(slot[ins[2]]); break;
        case OP_ATAN: r = atanf(slot[ins[2]]); break;
        case OP_SINH: r = sinhf(slot[ins[2]]); break;
        case OP_COSH: r = coshf(slot[ins[2]]); break;
        case OP_TANH: r = tanhf(slot[ins[2]]); break;
        case OP_ASINH: r = asinhf(slot[ins[2]]); break;
        case OP_ACOSH: r = acoshf(slot[ins[2]]); break;
        case OP_ATANH: r = atanhf(slot[ins[2]]); break;
        case OP_LOG1P: r = log1pf(slot[ins[2]]); break;
        case OP_EXPM1: r = expm1f(slot[ins[2]]); break;
        default: r = __int_as_float(0x7FC00000);  // unknown opcode: NaN
      }
      slot[ins[1]] = r;
    }
  }
  if (bad) atomicOr(nonfinite, 1);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `code` is
// int32 (n_instr, 6), `imm` float32 (n_instr,), `ab` float32
// (n_corr^2 + n_corr,) or null when n_corr is 0, `out` float32
// (n_keep, n) for samples start..start+n-1, `nonfinite` one int32 that
// the caller has zeroed.
extern "C" int graph_megakernel_launch(const void* code, const void* imm, int n_instr,
                                       const void* ab, int n_corr, uint32_t seed0,
                                       uint32_t seed1, int64_t start, int64_t n, void* out,
                                       void* nonfinite, int blocks, void* stream) {
  if (n_instr < 0 || n_instr > kMaxInstr || n < 0 || start < 0 || blocks <= 0 || n_corr < 0 ||
      n_corr > kMaxCorr || (n_corr > 0 && ab == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(n_instr) * (kFields * sizeof(int) + sizeof(float)) +
                      static_cast<size_t>(n_corr * n_corr + n_corr) * sizeof(float);
  graph_megakernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(code), static_cast<const float*>(imm), n_instr,
      static_cast<const float*>(ab), n_corr, seed0, seed1, start, n, static_cast<float*>(out),
      static_cast<int*>(nonfinite));
  return static_cast<int>(cudaGetLastError());
}
