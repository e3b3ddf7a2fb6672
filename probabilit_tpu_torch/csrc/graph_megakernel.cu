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
// words, counter = (i mod 2^32, i >> 32, column, 0) for global sample i;
// word 0 is used.  The stream depends on the seed only, not on the grid.
// ops/philox.py computes the same words in PyTorch.
//
// Math: the device functions transcribe ops/special.py (Giles erfinv) and
// ops/ppf.py.  nvcc contracts a*b+c into FMAs by default and PyTorch's
// eager ops do not, so results differ from the plain version by a few
// ulps (more in the normal tails); chip_smoke.py measures the difference.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Must equal MAX_SLOTS / MAX_INSTR in engine/cuda_exec.py.
constexpr int kMaxSlots = 64;
constexpr int kMaxInstr = 1024;
constexpr int kFields = 6;  // [opcode, dst, a, b, c, d]
constexpr int kThreads = 256;

// Same names, same order as cuda_exec.OPCODES.
enum Op : int {
  OP_DRAW,
  OP_LOADK,
  OP_STORE,
  OP_PPF_UNIFORM,
  OP_PPF_NORM,
  OP_PPF_EXPON,
  OP_PPF_LOGNORM,
  OP_PPF_TRIANG,
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

__device__ __forceinline__ uint32_t philox_word0(uint64_t i, uint32_t column,
                                                 uint32_t k0, uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(i);
  uint32_t c1 = static_cast<uint32_t>(i >> 32);
  uint32_t c2 = column;
  uint32_t c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// pallas_exec._bits_to_open_unit: the top 23 bits in the mantissa of 1.0f.
__device__ __forceinline__ float bits_to_open_unit(uint32_t bits) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float tiny = 5.9604644775390625e-08f;  // 2^-24
  return fminf(fmaxf(u, tiny), 1.0f - tiny);
}

// ops/special.py::erfinv_f32 with _giles_branch_polys.
__device__ __forceinline__ float erfinv_f32(float x) {
  float w = -logf(fmaxf((1.0f - x) * (1.0f + x), 1e-37f));
  w = fminf(w, 16.64f);
  const float wc = w - 2.5f;
  float p1 = 2.81022636e-08f;
  p1 = 3.43273939e-07f + p1 * wc;
  p1 = -3.5233877e-06f + p1 * wc;
  p1 = -4.39150654e-06f + p1 * wc;
  p1 = 0.00021858087f + p1 * wc;
  p1 = -0.00125372503f + p1 * wc;
  p1 = -0.00417768164f + p1 * wc;
  p1 = 0.246640727f + p1 * wc;
  p1 = 1.50140941f + p1 * wc;
  const float ws = sqrtf(fminf(w, 16.64f)) - 3.0f;
  float p2 = -0.000200214257f;
  p2 = 0.000100950558f + p2 * ws;
  p2 = 0.00134934322f + p2 * ws;
  p2 = -0.00367342844f + p2 * ws;
  p2 = 0.00573950773f + p2 * ws;
  p2 = -0.0076224613f + p2 * ws;
  p2 = 0.00943887047f + p2 * ws;
  p2 = 1.00167406f + p2 * ws;
  p2 = 2.83297682f + p2 * ws;
  return (w < 5.0f ? p1 : p2) * x;
}

__device__ __forceinline__ float ndtri_fast(float q) {
  return 1.4142135623730951f * erfinv_f32(2.0f * q - 1.0f);
}

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
                     int n_instr, uint32_t k0, uint32_t k1, int64_t n,
                     float* __restrict__ out, int* __restrict__ nonfinite) {
  // The tape, sized at launch: n_instr * kFields ints, then n_instr floats.
  extern __shared__ int s_code[];
  float* s_imm = reinterpret_cast<float*>(s_code + n_instr * kFields);
  for (int t = threadIdx.x; t < n_instr * kFields; t += blockDim.x) s_code[t] = code[t];
  for (int t = threadIdx.x; t < n_instr; t += blockDim.x) s_imm[t] = imm[t];
  __syncthreads();

  float slot[kMaxSlots];
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
          r = bits_to_open_unit(philox_word0(static_cast<uint64_t>(i),
                                             static_cast<uint32_t>(ins[2]), k0, k1));
          break;
        case OP_LOADK: r = s_imm[p]; break;
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
// int32 (n_instr, 6), `imm` float32 (n_instr,), `out` float32
// (n_keep, n), `nonfinite` one int32 that the caller has zeroed.
extern "C" int graph_megakernel_launch(const void* code, const void* imm, int n_instr,
                                       uint32_t seed0, uint32_t seed1, int64_t n,
                                       void* out, void* nonfinite, int blocks,
                                       void* stream) {
  if (n_instr < 0 || n_instr > kMaxInstr || n < 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(n_instr) * (kFields * sizeof(int) + sizeof(float));
  graph_megakernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(code), static_cast<const float*>(imm), n_instr, seed0,
      seed1, n, static_cast<float*>(out), static_cast<int*>(nonfinite));
  return static_cast<int>(cudaGetLastError());
}
