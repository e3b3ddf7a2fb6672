// bitonic_sort.cu: the blocked bitonic (key, payload) row sort, three kernels.
//
// Replaces the three Pallas kernels of probabilit_tpu/ops/pallas_sort.py:
//
// * sort_tiles_kernel (K3) for _local_sort_kernel (:116, call :153):
//   stages 1..T of the network inside each 2^T-element tile, T = 14 (13
//   for 8-byte keys with 8-byte payloads) in a row sort, T = 13 for the
//   8192-runs of sort_runs (stage 13's direction is then the parity of the
//   global run index, as the TPU kernel's);
// * block_exchange_kernel (K4) for _block_exchange_kernel (:171, call
//   :230): a group of up to kMaxFuse consecutive steps j_top..j_lo of
//   stage s, all with j_lo >= the tile, in one pass;
// * tail_kernel (K5) for _tail_kernel (:195, call :246): steps T-1..0 of
//   stage s inside each 2^T-element tile.
//
// In every step a pair (e, e + 2^j), bit j of e clear, sorts descending
// iff bit s of e's index within its row is set, and swaps iff it is
// strictly out of order, written as explicit '<' selects (fminf/fmaxf
// would treat NaN and signed zeros otherwise); the payload moves with its
// key as raw bits.  With these rules the keys and payloads equal the TPU
// kernels' bit for bit.  ops/bitonic_sort.py holds the plain twins and
// the wrappers, which pad rows with sentinel keys, launch K3 once for
// stages 1..T, then per stage T+1.. the K4 groups and the K5 tail of
// _merge_plan, and decide the tile T per key and payload width (passed in
// as tile_log).
//
// What bounds them on an H100: memory traffic.  A launch must read the
// padded keys and payloads once and write the slots it changes: at
// (50, 1e7) float32/int32, rows padded to 2^24, 6.7 GB read and at most
// 6.7 GB written, 2.0-4.0 ms at 3.35 TB/s.
//
// The tile T is the largest power of two whose keys and payloads fit in
// 227 KB of shared memory with a pad slot after every 32: 2^14 for 4+4,
// 4+8 and 8+4 bytes (132 or 198 KB), 2^13 for 8+8 (132 KB).  K3 and K5
// hold a tile in registers, 2^(T-5) threads of 32 elements each, and go
// through shared memory only to change layouts.  Three layouts, each a map
// from (thread, register r) to a tile element:
//
//   A  register r = element bits T-5..T-1, thread = bits 0..T-6: a warp's
//      lanes on consecutive elements, the order of every device-memory
//      load and store;
//   B  register r = bits 5..9 (K3: lane = bits 0..4, warp = bits 10..;
//      K5: bits T-10..T-6, the thread's other bits split between the
//      lowest T-10 and the top five);
//   C  register r = bits 0..4, lane = bits 5..9, warp = bits 10..T-1.
//
// pad(e) puts a pad slot after every 32 elements, so that a warp reaches
// 32 banks in every layout and each register's slot is a base register
// plus a constant.  A thread always writes back the slots it read, so a
// layout change needs one barrier: __syncwarp() between B and C in K3 (a
// warp's B and C elements are the same 1024), __syncthreads() otherwise.
//
// * K3.  The kernel it replaced ran the 91 steps of stages 1..13 in shared
//   memory, a __syncthreads() after each, 2-way bank conflicts in the 55
//   steps with j <= 4: 53.67 ms at (50, 1e7) (chip_smoke.py, one H100,
//   700 W), 6% of its bound.  Now: load in A's order, through shared
//   memory to C; stages 1..5 in registers; stages 6..10 through a warp
//   transpose to B (steps S-1..5) and back to C (steps 4..0), __syncwarp()
//   only; stages 11..T in A (steps S-1..10), B (9..5) and C (4..0), two
//   __syncthreads() a stage; out through shared memory in A's order.
//   2 + 2 (T - 10) block barriers a tile, 10 at T = 14.  At T = 14 K3 runs
//   stage 14, which K5 ran before: one tail fewer a row sort.  Every step
//   sorts ascending on keys reversed where their stage sorts descending
//   (reverse_keys, once a stage in layout C): a compare-exchange is one
//   compare and four selects; a direction in each compare added compares
//   and predicate logic to every pair.  Stages 6..T are runtime loops over
//   one copy of each layout's steps (a uniform branch skips a step a stage
//   does not have): fully unrolled, the 105 steps outgrew the instruction
//   cache and ran far slower.  Warp shuffles for the lane steps of
//   stages 6-7 (a step moves 32 keys and payloads a lane) and a 2^13 tile
//   at two blocks an SM with stage 14 back in K5 both measured slower at
//   (50, 1e7) (PERF.md).  Its time is the sum of its shared-memory wavefronts
//   (24 layout changes, ~9.6 ms), its ALU work (~7 ms) and one unoverlapped
//   read and write (~4.4 ms): the barriers keep one block's phases apart.
// * K4 fuses up to kMaxFuse = 5 distances a pass.  Thread t of a pass
//   over steps j_top..j_lo (G = j_top - j_lo + 1) holds the 2^G elements
//   base + m * 2^j_lo, m < 2^G, in registers, runs the G steps there from
//   the largest distance down, and stores back only the slots a swap
//   touched (an element that moves never returns to its slot within a
//   pass, since its distances are distinct powers of two).  The
//   direction, bit s of the element index, is the same for the whole set.
//   Consecutive lanes take consecutive low-order positions (bits below
//   j_lo >= 13), so every load and store of a warp is 128 contiguous
//   bytes.  A stage takes ceil((s - T) / 5) passes.  ptxas at G = 5: 140
//   registers for 4+4 bytes, 190 for 4+8, 192-211 for 8+4, 217-247 for
//   8+8, no spills; blocks of 128 threads keep at least 2 blocks an SM.
//   chip_smoke.py at (50, 1e7) on one H100 (700 W): F = 4 made 18 passes
//   in 67.30 ms, F = 5 15 in 56.25, the same 3.75 ms a pass.
// * K5 loads in A: steps T-1..T-5; B: steps T-6..T-10; C: steps T-11..0;
//   out through shared memory in A's order; three __syncthreads() a tail.
//   Loads and stores are scalar, a warp's 32 lanes on 128 consecutive
//   bytes.  chip_smoke.py at (50, 1e7), one H100 (700 W): storing
//   16-byte vectors straight from layout C (a warp's lanes 128 bytes
//   apart) took 7.49 ms a tail; scalar stores through shared memory 5.61;
//   the pad slots in place of an XOR swizzle, which kept each slot's
//   address in a register, 5.29 ms (a copy of the same bytes 4.42).
//
// One block of 512 threads (256 for T = 13) an SM for K3 and K5: the tile
// fills the shared memory, so a block's steps do not overlap its loads.
// 512 threads leave 128 registers each: K3's instances at T = 14 spill,
// and K5's for 8-byte keys with 4-byte payloads or 4-byte keys with
// 8-byte payloads (chip_smoke.py prints each instance's registers and
// spill bytes).
//
// Predicted on one H100 at 700 W before the first run of this K3, at
// (50, 1e7) float32/int32: K3 12-25 ms for stages 1..14 (one read and one
// write of 13.4 GB, about 4.4 ms; ~4.4e10 compare-exchanges, about 7 ms;
// ~18 layout changes, about 7 ms), the call 125-140 ms (173.33 with the
// replaced K3 of 53.67 ms); at (128, 2^17) K3 0.25-0.5 ms, the call 1.1-1.4 ms.
// Measured (chip_smoke.py): K3 21.46 ms, the call 135.86 (torch.sort +
// gather 36.49); at (128, 2^17) K3 0.55 ms, the call 1.35 (2.10).
//
// All three kernels work in place on contiguous buffers and launch on the
// caller's stream.

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kRunLog = 13;       // the least tile: K4 steps are >= 13
constexpr int kExchangeThreads = 128;
constexpr int kMaxFuse = 5;
constexpr int kMaxSmem = 232448;  // one block's dynamic shared memory on sm_90
constexpr int kRegs = 32;         // elements a K3 or K5 thread holds (5 index bits)

// One compare-exchange of two register-held pairs; true iff they swapped.
template <class K, class P>
__device__ __forceinline__ bool swap_pair(K& ka, K& kb, P& pa, P& pb, bool desc) {
  const K a = ka, b = kb;
  const P x = pa, y = pb;
  const bool swap = desc ? (a < b) : (b < a);
  ka = swap ? b : a;
  kb = swap ? a : b;
  pa = swap ? y : x;
  pb = swap ? x : y;
  return swap;
}

// The steps over register-index bits kBits-1..kLow of k[0..kN) below
// `top`, largest first; bit b of the returned mask is set iff slot b took
// part in a swap.  A runtime `top` is a uniform branch per step: one copy
// of the code serves every stage of K3's loops.
template <int kBits, int kLow = 0, int kN, class K, class P>
__device__ __forceinline__ unsigned register_steps(K (&k)[kN], P (&p)[kN], bool desc,
                                                   int top = kBits) {
  unsigned moved = 0;
#pragma unroll
  for (int b = kBits - 1; b >= kLow; --b) {
    if (b >= top) continue;
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      if (r & (1 << b)) continue;
      const int h = r | (1 << b);
      if (swap_pair(k[r], k[h], p[r], p[h], desc)) moved |= (1u << r) | (1u << h);
    }
  }
  return moved;
}

// Shared-memory slot of tile element e: one pad slot after every 32, so
// that layouts A, B and C each reach 32 banks from a warp.  For e = b | x
// with disjoint bits, pad(e) = pad(b) + pad(x): each layout adds a
// constant per register to one base.
__host__ __device__ constexpr int pad(int e) { return e + (e >> 5); }

// Register r of this thread to (from) slot base + pad(r << kShift).
template <int kShift, class K, class P>
__device__ __forceinline__ void store_tile(const K (&k)[kRegs], const P (&p)[kRegs], K* sk, P* sp,
                                           int base) {
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    sk[base + pad(r << kShift)] = k[r];
    sp[base + pad(r << kShift)] = p[r];
  }
}

template <int kShift, class K, class P>
__device__ __forceinline__ void load_tile(K (&k)[kRegs], P (&p)[kRegs], const K* sk, const P* sp,
                                          int base) {
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    k[r] = sk[base + pad(r << kShift)];
    p[r] = sp[base + pad(r << kShift)];
  }
}

// ---- K3 ----

// K3 sorts every step ascending on keys held reversed where their stage
// sorts descending: a float's sign bit flipped (-k exactly, NaN bits
// kept), an integer's every bit (~k).  a < b iff rev(b) < rev(a), ties
// and NaN included, so a descending pair swaps exactly when the twin's
// does.  Register r is reversed anew iff `uniform` differs from the parity
// of r & kMask.
__host__ __device__ constexpr bool parity(unsigned x) {
  return x && (x & 1) != parity(x >> 1);
}

template <unsigned kMask, class K>
__device__ __forceinline__ void reverse_keys(K (&k)[kRegs], bool uniform) {
  using U = std::conditional_t<sizeof(K) == 4, uint32_t, uint64_t>;
  constexpr U kAll = std::is_floating_point_v<K> ? U{1} << (8 * sizeof(K) - 1) : ~U{0};
  const U odd = uniform ? U{0} : kAll;  // for registers whose r & kMask has odd parity
  const U even = uniform ? kAll : U{0};
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    U u;
    memcpy(&u, &k[r], sizeof(K));
    u ^= parity(r & kMask) ? odd : even;
    memcpy(&k[r], &u, sizeof(K));
  }
}

// Stages S..5 of K3, in registers on layout C, with keys reversed where
// stage S sorts descending; on return they are reversed where stage 6
// does.  row_bits: bits 5.. of the index within its row of this thread's
// layout-C elements, whose bit s is the direction of stage s >= 5.
template <int S, class K, class P>
__device__ __forceinline__ void register_stages(K (&k)[kRegs], P (&p)[kRegs], int64_t row_bits) {
  register_steps<S>(k, p, false);
  if constexpr (S < 4) {
    reverse_keys<(3u << S)>(k, false);
  } else if constexpr (S == 4) {
    reverse_keys<(1u << 4)>(k, ((row_bits >> 5) & 1) != 0);
  } else {
    reverse_keys<0>(k, ((row_bits ^ (row_bits >> 1)) >> 5 & 1) != 0);
  }
  if constexpr (S < 5) register_stages<S + 1>(k, p, row_bits);
}

// Stages 1..T inside each 2^T-element tile; stage s's direction is bit s
// of an element's index within its row of 2^n_pad_log.  Every step sorts
// ascending on reversed keys (reverse_keys).
template <class K, class P, int T>
__global__ void __launch_bounds__(1 << (T - 5), 1)
    sort_tiles_kernel(K* keys, P* pay, int n_pad_log) {
  constexpr int kTop = T - 5;  // layout A: register r is element (r << kTop) | tid
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  P* sp = reinterpret_cast<P*>(smem + sizeof(K) * pad(1 << T));
  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) << T;
  const int64_t row_bits = (first & ((int64_t{1} << n_pad_log) - 1)) | (tid << 5);
  // Layout A's elements: one base address a thread plus constants (an
  // index (r << kTop) | tid costs a 64-bit address a register, kept live
  // to the stores: 128 registers).
  K* gk = keys + first + tid;
  P* gp = pay + first + tid;
  K k[kRegs];
  P p[kRegs];
  const int a0 = pad(tid);
  const int b0 = pad(((tid >> 5) << 10) | (tid & 31));
  const int c0 = pad(tid << 5);
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    k[r] = gk[r << kTop];
    p[r] = gp[r << kTop];
  }
  store_tile<kTop>(k, p, sk, sp, a0);
  __syncthreads();
  load_tile<0>(k, p, sk, sp, c0);
  reverse_keys<2u>(k, false);  // stage 1 sorts descending where bit 1 is set
  register_stages<1>(k, p, row_bits);

  // Stages 6..10: steps S-1..5 across lanes in layout B, inside the warp;
  // steps 4..0 in C.
#pragma unroll 1
  for (int S = 6; S <= 10; ++S) {
    store_tile<0>(k, p, sk, sp, c0);
    __syncwarp();
    load_tile<5>(k, p, sk, sp, b0);
    register_steps<5>(k, p, false, S - 5);
    store_tile<5>(k, p, sk, sp, b0);
    __syncwarp();
    load_tile<0>(k, p, sk, sp, c0);
    register_steps<5>(k, p, false);
    reverse_keys<0>(k, ((row_bits ^ (row_bits >> 1)) >> S & 1) != 0);
  }

  // Stages 11..T: steps S-1..10 in layout A, across warps; 9..5 in B; 4..0
  // in C.  After stage T the keys are restored.
#pragma unroll 1
  for (int S = 11; S <= T; ++S) {
    store_tile<0>(k, p, sk, sp, c0);
    __syncthreads();
    load_tile<kTop>(k, p, sk, sp, a0);
    register_steps<5, 10 - kTop>(k, p, false, S - kTop);
    store_tile<kTop>(k, p, sk, sp, a0);
    __syncthreads();
    load_tile<5>(k, p, sk, sp, b0);
    register_steps<5>(k, p, false);
    store_tile<5>(k, p, sk, sp, b0);
    __syncwarp();
    load_tile<0>(k, p, sk, sp, c0);
    register_steps<5>(k, p, false);
    const int64_t next = S < T ? row_bits >> 1 : 0;  // bit S of next: stage S+1's direction
    reverse_keys<0>(k, ((row_bits ^ next) >> S & 1) != 0);
  }
  store_tile<0>(k, p, sk, sp, c0);
  __syncthreads();
  load_tile<kTop>(k, p, sk, sp, a0);
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    gk[r << kTop] = k[r];
    gp[r << kTop] = p[r];
  }
}

// ---- end of K3 ----

template <class K, class P, int G>
__global__ void __launch_bounds__(kExchangeThreads)
    block_exchange_kernel(K* keys, P* pay, int64_t sets, int n_pad_log, int stage, int j_lo) {
  constexpr int kSet = 1 << G;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t low = (int64_t{1} << j_lo) - 1;
  const int64_t in_row = (int64_t{1} << n_pad_log) - 1;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < sets;
       t += stride) {
    // The set's first element, over all rows: t's bits below j_lo stay,
    // the rest move up past the G bits of the set.
    const int64_t base = ((t >> j_lo) << (j_lo + G)) | (t & low);
    const bool desc = (((base & in_row) >> stage) & 1) != 0;
    K k[kSet];
    P p[kSet];
#pragma unroll
    for (int m = 0; m < kSet; ++m) {
      const int64_t e = base + (static_cast<int64_t>(m) << j_lo);
      k[m] = keys[e];
      p[m] = pay[e];
    }
    const unsigned moved = register_steps<G>(k, p, desc);
#pragma unroll
    for (int m = 0; m < kSet; ++m) {
      if (moved & (1u << m)) {
        const int64_t e = base + (static_cast<int64_t>(m) << j_lo);
        keys[e] = k[m];
        pay[e] = p[m];
      }
    }
  }
}

template <class K, class P, int T>
__global__ void __launch_bounds__(1 << (T - 5), 1)
    tail_kernel(K* keys, P* pay, int n_pad_log, int stage) {
  constexpr int kTop = T - 5;   // layout A: register r is element (r << kTop) | tid
  constexpr int kMid = T - 10;  // layout B: register r is element bits kMid..kMid+4
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  P* sp = reinterpret_cast<P*>(smem + sizeof(K) * pad(1 << T));
  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) << T;
  const bool desc = (((first & ((int64_t{1} << n_pad_log) - 1)) >> stage) & 1) != 0;
  K* gk = keys + first;
  P* gp = pay + first;
  K k[kRegs];
  P p[kRegs];

  // Layout A: steps T-1..T-5.
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    k[r] = gk[(r << kTop) | tid];
    p[r] = gp[(r << kTop) | tid];
  }
  register_steps<5>(k, p, desc);
  const int a0 = pad(tid);
  store_tile<kTop>(k, p, sk, sp, a0);
  __syncthreads();

  // Layout B: steps T-6..T-10; each thread writes back the slots it read.
  const int b0 = pad((tid & ((1 << kMid) - 1)) | ((tid >> kMid) << kTop));
  load_tile<kMid>(k, p, sk, sp, b0);
  register_steps<5>(k, p, desc);
  store_tile<kMid>(k, p, sk, sp, b0);
  __syncthreads();

  // Layout C: steps T-11..0 on 32 consecutive elements; then out through
  // shared memory in layout A's order, each warp store 32 consecutive
  // elements.
  const int c0 = pad(tid << 5);
  load_tile<0>(k, p, sk, sp, c0);
  register_steps<kMid>(k, p, desc);
  store_tile<0>(k, p, sk, sp, c0);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    gk[(r << kTop) | tid] = sk[a0 + pad(r << kTop)];
    gp[(r << kTop) | tid] = sp[a0 + pad(r << kTop)];
  }
}

constexpr int kMaxGrid = 0x7FFFFFFF;

// Launches a tile kernel (2^(T-5) threads, the padded tile in dynamic
// shared memory) over `tiles` blocks.
template <int T, class K, class P, class... Args>
int launch_tiles(void (*kernel)(K*, P*, Args...), int64_t tiles, cudaStream_t stream, void* keys,
                 void* pay, Args... args) {
  constexpr int smem = static_cast<int>(sizeof(K) + sizeof(P)) * pad(1 << T);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(tiles), 1 << (T - 5), smem, stream>>>(
      static_cast<K*>(keys), static_cast<P*>(pay), args...);
  return static_cast<int>(cudaGetLastError());
}

// True iff a 2^T tile of K keys and P payloads fits one block (no kernel
// instance is built for a tile that does not).
template <class K, class P, int T>
constexpr bool tile_fits() {
  return static_cast<int>(sizeof(K) + sizeof(P)) * pad(1 << T) <= kMaxSmem;
}

template <class K, class P>
struct SortTiles {
  template <int T>
  static int launch(void* keys, void* pay, int64_t tiles, int n_pad_log, cudaStream_t stream) {
    if constexpr (tile_fits<K, P, T>()) {
      return launch_tiles<T>(sort_tiles_kernel<K, P, T>, tiles, stream, keys, pay, n_pad_log);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }

  static int run(void* keys, void* pay, int64_t tiles, int n_pad_log, int tile_log,
                 cudaStream_t stream) {
    if (tiles <= 0 || tiles > kMaxGrid || n_pad_log < tile_log || n_pad_log > 40) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (tile_log == 14) return launch<14>(keys, pay, tiles, n_pad_log, stream);
    if (tile_log == 13) return launch<13>(keys, pay, tiles, n_pad_log, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

template <class K, class P>
struct Tail {
  template <int T>
  static int launch(void* keys, void* pay, int64_t tiles, int n_pad_log, int stage,
                    cudaStream_t stream) {
    if constexpr (tile_fits<K, P, T>()) {
      return launch_tiles<T>(tail_kernel<K, P, T>, tiles, stream, keys, pay, n_pad_log, stage);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }

  static int run(void* keys, void* pay, int64_t rows, int n_pad_log, int stage, int tile_log,
                 cudaStream_t stream) {
    if (rows <= 0 || n_pad_log > 40 || stage < tile_log || stage > n_pad_log ||
        (rows << (n_pad_log - tile_log)) > kMaxGrid) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t tiles = rows << (n_pad_log - tile_log);
    if (tile_log == 14) return launch<14>(keys, pay, tiles, n_pad_log, stage, stream);
    if (tile_log == 13) return launch<13>(keys, pay, tiles, n_pad_log, stage, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

template <class K, class P>
struct BlockExchange {
  template <int G>
  static int launch(void* keys, void* pay, int64_t rows, int n_pad_log, int stage, int j_lo,
                    cudaStream_t stream) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t sets = rows << (n_pad_log - G);
    const int64_t wanted = (sets + kExchangeThreads - 1) / kExchangeThreads;
    const int64_t resident = static_cast<int64_t>(sms) * (2048 / kExchangeThreads);
    const int blocks = static_cast<int>(wanted < resident ? wanted : resident);
    block_exchange_kernel<K, P, G><<<blocks, kExchangeThreads, 0, stream>>>(
        static_cast<K*>(keys), static_cast<P*>(pay), sets, n_pad_log, stage, j_lo);
    return static_cast<int>(cudaGetLastError());
  }

  static int run(void* keys, void* pay, int64_t rows, int n_pad_log, int stage, int j_top,
                 int steps, cudaStream_t stream) {
    const int j_lo = j_top - steps + 1;
    if (rows <= 0 || n_pad_log > 40 || stage > n_pad_log || j_top >= stage || j_lo < kRunLog ||
        steps < 1 || steps > kMaxFuse) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (steps) {
      case 1: return launch<1>(keys, pay, rows, n_pad_log, stage, j_lo, stream);
      case 2: return launch<2>(keys, pay, rows, n_pad_log, stage, j_lo, stream);
      case 3: return launch<3>(keys, pay, rows, n_pad_log, stage, j_lo, stream);
      case 4: return launch<4>(keys, pay, rows, n_pad_log, stage, j_lo, stream);
      default: return launch<5>(keys, pay, rows, n_pad_log, stage, j_lo, stream);
    }
  }
};

// Launcher<Key, Payload>::run(args...) for the key type code (0 float32,
// 1 int32, 2 float64, 3 int64, as ops/bitonic_sort.py's _KEY_CODE) and the
// payload's width in bytes (4 or 8, moved as raw bits).
template <template <class, class> class Launcher, class P, class... Args>
int by_key(int key_type, Args... args) {
  switch (key_type) {
    case 0: return Launcher<float, P>::run(args...);
    case 1: return Launcher<int32_t, P>::run(args...);
    case 2: return Launcher<double, P>::run(args...);
    case 3: return Launcher<int64_t, P>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <template <class, class> class Launcher, class... Args>
int dispatch(int key_type, int payload_bytes, Args... args) {
  if (payload_bytes == 4) return by_key<Launcher, uint32_t>(key_type, args...);
  if (payload_bytes == 8) return by_key<Launcher, uint64_t>(key_type, args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// All three launch on `stream`, work in place on contiguous buffers, and
// return cudaGetLastError() (0 on success).  K3 sorts `tiles` consecutive
// 2^tile_log-element tiles (stages 1..tile_log), in rows of 2^n_pad_log
// elements for the directions; K4 and K5 take `rows` rows of 2^n_pad_log.
// K4 runs steps j_top..j_top-steps+1 of `stage`; K5 steps tile_log-1..0 in
// 2^tile_log-element tiles.  tile_log is 13 or 14, chosen by the caller.

extern "C" int bitonic_sort_runs(void* keys, void* payload, int key_type, int payload_bytes,
                                 int64_t tiles, int n_pad_log, int tile_log, void* stream) {
  return dispatch<SortTiles>(key_type, payload_bytes, keys, payload, tiles, n_pad_log, tile_log,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int bitonic_block_exchange(void* keys, void* payload, int key_type,
                                      int payload_bytes, int64_t rows, int n_pad_log,
                                      int stage, int j_top, int steps, void* stream) {
  return dispatch<BlockExchange>(key_type, payload_bytes, keys, payload, rows, n_pad_log, stage,
                                 j_top, steps, static_cast<cudaStream_t>(stream));
}

extern "C" int bitonic_tail(void* keys, void* payload, int key_type, int payload_bytes,
                            int64_t rows, int n_pad_log, int stage, int tile_log, void* stream) {
  return dispatch<Tail>(key_type, payload_bytes, keys, payload, rows, n_pad_log, stage, tile_log,
                        static_cast<cudaStream_t>(stream));
}
