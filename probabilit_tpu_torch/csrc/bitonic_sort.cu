// bitonic_sort.cu: the blocked bitonic (key, payload) row sort, three kernels.
//
// Replaces the three Pallas kernels of probabilit_tpu/ops/pallas_sort.py:
//
// * sort_runs_kernel (K3) for _local_sort_kernel (:116, call :153):
//   stages 1..13 of the network inside each 8192-element run; run g ends
//   ascending iff g is even (stage 13's direction is the parity of the
//   global run index);
// * block_exchange_kernel (K4) for _block_exchange_kernel (:171, call
//   :230): a group of up to kMaxFuse consecutive steps j_top..j_lo of
//   stage s, all with j_lo >= the tail's tile, in one pass;
// * tail_kernel (K5) for _tail_kernel (:195, call :246): steps T-1..0 of
//   stage s inside each 2^T-element tile.
//
// In every step a pair (e, e + 2^j), bit j of e clear, sorts descending
// iff bit s of e's index within its row is set, and swaps iff it is
// strictly out of order, written as explicit '<' selects (fminf/fmaxf
// would treat NaN and signed zeros otherwise); the payload moves with its
// key as raw bits.  With these rules the keys and payloads equal the TPU
// kernels' bit for bit.  ops/bitonic_sort.py holds the plain twins and
// the wrappers, which pad rows with sentinel keys, launch K3 once, then
// per stage the K4 groups and the K5 tail of _merge_plan, and decide the
// tile T per key and payload width (passed in as tile_log).
//
// What bounds them on an H100: memory traffic.  A stage must read the
// padded keys and payloads once and write the slots it changes: at
// (50, 1e7) float32/int32, rows padded to 2^24, 6.7 GB read and at most
// 6.7 GB written, 2.0-4.0 ms at 3.35 TB/s, 11 stages.  PR 3's design made
// one pass per step j >= 13 (66 K4 passes at 2.99 ms) and ran the 13 tail
// steps through shared memory with a __syncthreads() after each (7.92 ms
// a tail), 285 ms for K4 and K5 where ~25-45 ms is the floor.
//
// The design:
//
// * K4 fuses up to kMaxFuse = 5 distances a pass.  Thread t of a pass
//   over steps j_top..j_lo (G = j_top - j_lo + 1) holds the 2^G elements
//   base + m * 2^j_lo, m < 2^G, in registers, runs the G steps there from
//   the largest distance down, and stores back only the slots a swap
//   touched (an element that moves never returns to its slot within a
//   pass, since its distances are distinct powers of two), so pad and
//   sorted regions stay unwritten, as in PR 3: at (50, 1e7) a pass writes
//   about half the slots.  The direction, bit s of the element index, is
//   the same for the whole set (every offset differs only in bits below
//   s).  Consecutive lanes take consecutive low-order positions (bits
//   below j_lo >= 13), so every load and store of a warp is 128
//   contiguous bytes.  A stage takes ceil((s - T) / 5) passes: 15 at
//   (50, 1e7), against 66.  ptxas at G = 5: 140 registers for 4+4 bytes,
//   190 for 4+8, 192-211 for 8+4, 217-247 for 8+8, no spills; blocks of
//   128 threads keep at least 2 blocks an SM.  chip_smoke.py at (50, 1e7)
//   on one H100 (700 W): F = 4 made 18 passes in 67.30 ms, F = 5 15 in
//   56.25, the same 3.75 ms a pass.
// * K5 keeps its tile in registers: 2^(T-5) threads hold 32 elements
//   each.  The tile T is the largest power of two whose keys and payloads
//   fit in 227 KB of shared memory with their pad slots: 2^14 for 4+4,
//   4+8 and 8+4 bytes (132 or 198 KB), 2^13 for 8+8 (132 KB).  Three
//   register layouts: A, register r = element bits T-1..T-5, loaded from
//   device memory (lanes on consecutive elements): steps T-1..T-5 with no
//   synchronisation; one transpose through shared memory (a pad slot after
//   every 32 keeps every layout free of bank conflicts, and its addresses
//   a base register plus constants) to B, register r = bits T-6..T-10,
//   the thread's other bits split between the lowest T-10 bits and the
//   top five: steps T-6..T-10; back to shared memory (each thread
//   rewrites the slots it read) and out to C, register r = bits 4..0, 32
//   consecutive elements: steps T-11..0; back once more, and out to device
//   memory in layout A's order.  Three
//   __syncthreads() a tail, against 13.  Loads and stores are scalar, a
//   warp's 32 lanes on 128 consecutive bytes, neither 16-byte vectors nor
//   cp.async.bulk: a bulk copy into shared memory would add a barrier
//   before the transposed write, and the first five steps run in
//   registers.  chip_smoke.py at (50, 1e7), one H100 (700 W): storing
//   16-byte vectors straight from layout C (a warp's lanes 128 bytes
//   apart, two barriers) took 7.49 ms a tail; the third barrier and
//   scalar stores 5.61 ms; the pad slots in place of an XOR swizzle, which
//   kept each slot's address in a register (128 registers and 104 bytes
//   of stack for 4+4 bytes, now 96 and none), 5.29 ms.  One block of 512
//   threads (256 for T = 13) an SM: the tile fills the shared memory, so
//   a block's steps do not overlap its loads.  8-byte keys with 4-byte
//   payloads, and 4-byte keys with 8-byte payloads, spill 136-224 bytes a
//   thread at T = 14 (512 threads leave 128 registers each).
//
// Predicted on one H100 at 700 W, before the first run of this design
// (then with F = 4 and 16-byte stores from layout C), at (50, 1e7)
// float32/int32: K4 3.3-3.8 ms a pass (one read, 30-50% of the slots
// written), 60-68 ms for 18 passes; K5 5-6 ms a tail (a read and a
// write of every slot at 4 ms, plus the steps, which one block an SM does
// not overlap with its loads), 55-66 ms for 11; the call ~170-190 ms with
// K3's 53.66 ms.  At (128, 2^17): ~1.5-1.9 ms for the call.  Measured
// (chip_smoke.py, the design above): K4 56.26 ms for 15 passes, K5 58.34
// for 11 (a copy of the same bytes 4.42 ms a tail), the call 173.33 ms
// against torch.sort + gather's 36.57; at (128, 2^17) 2.16 against 2.04.
//
// All three kernels work in place on contiguous buffers and launch on the
// caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRun = 8192;
constexpr int kRunLog = 13;
constexpr int kThreads = 1024;
constexpr int kPairsPerThread = kRun / 2 / kThreads;
constexpr int kExchangeThreads = 128;
constexpr int kMaxFuse = 5;
constexpr int kMaxSmem = 232448;  // one block's dynamic shared memory on sm_90
constexpr int kTailRegs = 32;     // elements a K5 thread holds (5 index bits)

template <class K, class P>
__device__ __forceinline__ void exchange(K* k, P* p, int lo, int hi, bool desc) {
  const K a = k[lo];
  const K b = k[hi];
  if (desc ? (a < b) : (b < a)) {
    k[lo] = b;
    k[hi] = a;
    const P t = p[lo];
    p[lo] = p[hi];
    p[hi] = t;
  }
}

// Steps j = j_top..0 of `stage` on the run in shared memory.  desc < 0:
// the direction is bit `stage` of the lo element's index; else desc.
template <class K, class P>
__device__ __forceinline__ void run_steps(K* sk, P* sp, int stage, int j_top, int desc) {
  for (int j = j_top; j >= 0; --j) {
#pragma unroll
    for (int r = 0; r < kPairsPerThread; ++r) {
      const int q = threadIdx.x + r * kThreads;
      const int lo = ((q >> j) << (j + 1)) | (q & ((1 << j) - 1));
      exchange(sk, sp, lo, lo + (1 << j), desc < 0 ? ((lo >> stage) & 1) != 0 : desc != 0);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (int t = threadIdx.x; t < bytes / 16; t += blockDim.x) d[t] = s[t];
}

template <class K, class P>
__global__ void __launch_bounds__(kThreads) sort_runs_kernel(K* keys, P* pay) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  P* sp = reinterpret_cast<P*>(smem + kRun * sizeof(K));
  const int64_t run = blockIdx.x;
  K* gk = keys + run * kRun;
  P* gp = pay + run * kRun;
  copy16(sk, gk, kRun * sizeof(K));
  copy16(sp, gp, kRun * sizeof(P));
  __syncthreads();
  for (int stage = 1; stage < kRunLog; ++stage) run_steps(sk, sp, stage, stage - 1, -1);
  run_steps(sk, sp, kRunLog, kRunLog - 1, static_cast<int>(run & 1));
  copy16(gk, sk, kRun * sizeof(K));
  copy16(gp, sp, kRun * sizeof(P));
}

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

// The steps over register-index bits kBits-1..0 of k[0..kN), largest
// first; bit b of the returned mask is set iff slot b took part in a swap.
template <int kBits, int kN, class K, class P>
__device__ __forceinline__ unsigned register_steps(K (&k)[kN], P (&p)[kN], bool desc) {
  unsigned moved = 0;
#pragma unroll
  for (int b = kBits - 1; b >= 0; --b) {
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      if (r & (1 << b)) continue;
      const int h = r | (1 << b);
      if (swap_pair(k[r], k[h], p[r], p[h], desc)) moved |= (1u << r) | (1u << h);
    }
  }
  return moved;
}

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

// Shared-memory slot of tile element e: one pad slot after every 32, so
// that layouts A, B and C each reach 32 banks from a warp.  For e = b | x
// with disjoint bits, pad(e) = pad(b) + pad(x): each layout adds a
// constant per register to one base.
__host__ __device__ constexpr int pad(int e) { return e + (e >> 5); }

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
  K k[kTailRegs];
  P p[kTailRegs];

  // Layout A: steps T-1..T-5.
#pragma unroll
  for (int r = 0; r < kTailRegs; ++r) {
    const int e = (r << kTop) | tid;
    k[r] = gk[e];
    p[r] = gp[e];
  }
  register_steps<5>(k, p, desc);
  const int a0 = pad(tid);
#pragma unroll
  for (int r = 0; r < kTailRegs; ++r) {
    const int s = a0 + pad(r << kTop);
    sk[s] = k[r];
    sp[s] = p[r];
  }
  __syncthreads();

  // Layout B: steps T-6..T-10; each thread writes back the slots it read.
  const int b0 = pad((tid & ((1 << kMid) - 1)) | ((tid >> kMid) << kTop));
#pragma unroll
  for (int r = 0; r < kTailRegs; ++r) {
    const int s = b0 + pad(r << kMid);
    k[r] = sk[s];
    p[r] = sp[s];
  }
  register_steps<5>(k, p, desc);
#pragma unroll
  for (int r = 0; r < kTailRegs; ++r) {
    const int s = b0 + pad(r << kMid);
    sk[s] = k[r];
    sp[s] = p[r];
  }
  __syncthreads();

  // Layout C: steps T-11..0 on 32 consecutive elements; then out through
  // shared memory in layout A's order, each warp store 32 consecutive
  // elements.
  const int c0 = pad(tid << 5);
#pragma unroll
  for (int r = 0; r < kTailRegs; ++r) {
    const int s = c0 + r;
    k[r] = sk[s];
    p[r] = sp[s];
  }
  register_steps<kMid>(k, p, desc);
#pragma unroll
  for (int r = 0; r < kTailRegs; ++r) {
    const int s = c0 + r;
    sk[s] = k[r];
    sp[s] = p[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kTailRegs; ++r) {
    const int e = (r << kTop) | tid;
    gk[e] = sk[a0 + pad(r << kTop)];
    gp[e] = sp[a0 + pad(r << kTop)];
  }
}

constexpr int kMaxGrid = 0x7FFFFFFF;

template <class K, class P>
struct SortRuns {
  static int run(void* keys, void* pay, int64_t runs, cudaStream_t stream) {
    if (runs <= 0 || runs > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = kRun * static_cast<int>(sizeof(K) + sizeof(P));
    cudaError_t err = cudaFuncSetAttribute(
        sort_runs_kernel<K, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sort_runs_kernel<K, P><<<static_cast<unsigned>(runs), kThreads, smem, stream>>>(
        static_cast<K*>(keys), static_cast<P*>(pay));
    return static_cast<int>(cudaGetLastError());
  }
};

template <class K, class P>
struct Tail {
  template <int T>
  static int launch(void* keys, void* pay, int64_t tiles, int n_pad_log, int stage,
                    cudaStream_t stream) {
    constexpr int smem = static_cast<int>(sizeof(K) + sizeof(P)) * pad(1 << T);
    if constexpr (smem > kMaxSmem) {  // no such instance is built
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      return launch_fits<T, smem>(keys, pay, tiles, n_pad_log, stage, stream);
    }
  }

  template <int T, int smem>
  static int launch_fits(void* keys, void* pay, int64_t tiles, int n_pad_log, int stage,
                         cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        tail_kernel<K, P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tail_kernel<K, P, T><<<static_cast<unsigned>(tiles), 1 << (T - 5), smem, stream>>>(
        static_cast<K*>(keys), static_cast<P*>(pay), n_pad_log, stage);
    return static_cast<int>(cudaGetLastError());
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
// return cudaGetLastError() (0 on success).  `keys` and `payload` hold
// `runs` 8192-runs (K3), or `rows` rows of 2^n_pad_log elements (K4, K5).
// K4 runs steps j_top..j_top-steps+1 of `stage`; K5 steps tile_log-1..0 in
// 2^tile_log-element tiles (13 or 14, chosen by the caller).

extern "C" int bitonic_sort_runs(void* keys, void* payload, int key_type, int payload_bytes,
                                 int64_t runs, void* stream) {
  return dispatch<SortRuns>(key_type, payload_bytes, keys, payload, runs,
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
