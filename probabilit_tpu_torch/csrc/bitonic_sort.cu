// bitonic_sort.cu: the blocked bitonic (key, payload) row sort, three kernels.
//
// Replaces the three Pallas kernels of probabilit_tpu/ops/pallas_sort.py:
//
// * sort_runs_kernel (K3) for _local_sort_kernel: stages 1..13 of the
//   network inside each 8192-element run; run g ends ascending iff g is
//   even (stage 13's direction is the parity of the global run index);
// * block_exchange_kernel (K4) for _block_exchange_kernel: one step j >= 13
//   of stage s, pairs (e, e + 2^j) with bit j of e clear, descending iff
//   bit s of e is set;
// * tail_kernel (K5) for _tail_kernel: steps 12..0 of stage s inside each
//   8192-block, descending iff bit (s - 13) of the block's index in its
//   row is set.
//
// Element e of a run is its flat position: the TPU's row-major (64, 128)
// run layout is the same order.  ops/bitonic_sort.py holds the plain
// twins and the wrappers, which pad rows with sentinel keys and launch
// K3 once, then per stage s its s - 13 K4 passes and one K5.
//
// The exchange: a pair swaps iff it is strictly out of order, written as
// explicit '<' selects (fminf/fmaxf would treat NaN and signed zeros
// otherwise); the payload moves with its key as raw bits.  With these
// rules the keys and payloads equal the TPU kernels' bit for bit.
//
// What bounds it on an H100: memory traffic.  Each K4 pass and each
// K3/K5 launch reads and writes every key and payload once; a (50, 1e7)
// float32/int32 sort pads rows to 2^24 and makes 1 + 66 + 11 = 78 passes
// over 6.7 GB, ~1 TB, ~312 ms at 3.35 TB/s, where one read and one write
// of the unpadded data would take ~2.4 ms.  torch.sort's radix sort makes
// a few passes; this network is expected to lose to it.
//
// What the design does about it, as a first, simple version: K3 and K5
// keep a whole 8192-run in shared memory (64 KB for 4-byte keys and
// payloads, up to 128 KB for 8-byte ones, opted in with
// cudaFuncAttributeMaxDynamicSharedMemorySize), so their 91 and 13 steps
// cost one pass over device memory each; 1024 threads do 4 pairs each per
// step, with __syncthreads() between steps; loads and stores are 16-byte
// vectors.  K4 is a grid-stride elementwise pass over quads of pairs, with
// 16-byte loads of four keys (and four payloads) at e and e + 2^j.  All
// three work in place.  Fusing K4 steps (several distances per pass) and
// register-resident steps for small j are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRun = 8192;
constexpr int kRunLog = 13;
constexpr int kThreads = 1024;
constexpr int kPairsPerThread = kRun / 2 / kThreads;
constexpr int kExchangeThreads = 256;

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

template <class K, class P>
__global__ void __launch_bounds__(kThreads)
    tail_kernel(K* keys, P* pay, int n_blocks_log, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  P* sp = reinterpret_cast<P*>(smem + kRun * sizeof(K));
  const int64_t block = blockIdx.x;
  const int64_t in_row = block & ((int64_t{1} << n_blocks_log) - 1);
  K* gk = keys + block * kRun;
  P* gp = pay + block * kRun;
  copy16(sk, gk, kRun * sizeof(K));
  copy16(sp, gp, kRun * sizeof(P));
  __syncthreads();
  run_steps(sk, sp, stage, kRunLog - 1, static_cast<int>((in_row >> (stage - kRunLog)) & 1));
  copy16(gk, sk, kRun * sizeof(K));
  copy16(gp, sp, kRun * sizeof(P));
}

// Four consecutive elements, loaded and stored as one (16-byte for 4-byte
// types) vector.
template <class T>
struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

template <class K, class P>
__global__ void __launch_bounds__(kExchangeThreads)
    block_exchange_kernel(K* keys, P* pay, int64_t quads, int n_pad_log, int stage, int j) {
  const int half_log = n_pad_log - 1;  // pairs per row: 2^half_log
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; v < quads;
       v += stride) {
    const int64_t q = v << 2;  // the quad's first pair, over all rows
    const int64_t row = q >> half_log;
    const int64_t qr = q & ((int64_t{1} << half_log) - 1);
    const int64_t lo = ((qr >> j) << (j + 1)) | (qr & ((int64_t{1} << j) - 1));
    const bool desc = ((lo >> stage) & 1) != 0;
    const int64_t i_lo = (row << n_pad_log) + lo;
    const int64_t i_hi = i_lo + (int64_t{1} << j);
    Quad<K> a = *reinterpret_cast<const Quad<K>*>(keys + i_lo);
    Quad<K> b = *reinterpret_cast<const Quad<K>*>(keys + i_hi);
    Quad<P> pa = *reinterpret_cast<const Quad<P>*>(pay + i_lo);
    Quad<P> pb = *reinterpret_cast<const Quad<P>*>(pay + i_hi);
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (desc ? (a.v[i] < b.v[i]) : (b.v[i] < a.v[i])) {
        const K t = a.v[i];
        a.v[i] = b.v[i];
        b.v[i] = t;
        const P u = pa.v[i];
        pa.v[i] = pb.v[i];
        pb.v[i] = u;
        any = true;
      }
    }
    if (any) {
      *reinterpret_cast<Quad<K>*>(keys + i_lo) = a;
      *reinterpret_cast<Quad<K>*>(keys + i_hi) = b;
      *reinterpret_cast<Quad<P>*>(pay + i_lo) = pa;
      *reinterpret_cast<Quad<P>*>(pay + i_hi) = pb;
    }
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
  static int run(void* keys, void* pay, int64_t rows, int n_blocks_log, int stage,
                 cudaStream_t stream) {
    const int64_t blocks = rows << n_blocks_log;
    if (rows <= 0 || n_blocks_log < 1 || stage <= kRunLog || stage > kRunLog + n_blocks_log ||
        blocks > kMaxGrid) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int smem = kRun * static_cast<int>(sizeof(K) + sizeof(P));
    cudaError_t err = cudaFuncSetAttribute(
        tail_kernel<K, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tail_kernel<K, P><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<K*>(keys), static_cast<P*>(pay), n_blocks_log, stage);
    return static_cast<int>(cudaGetLastError());
  }
};

template <class K, class P>
struct BlockExchange {
  static int run(void* keys, void* pay, int64_t rows, int n_pad_log, int stage, int j,
                 cudaStream_t stream) {
    if (rows <= 0 || n_pad_log <= kRunLog || n_pad_log > 40 || stage > n_pad_log ||
        j < kRunLog || j >= stage) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t quads = (rows << n_pad_log) / 8;  // pairs / 4
    const int64_t wanted = (quads + kExchangeThreads - 1) / kExchangeThreads;
    const int64_t resident = static_cast<int64_t>(sms) * (2048 / kExchangeThreads);
    const int blocks = static_cast<int>(wanted < resident ? wanted : resident);
    block_exchange_kernel<K, P><<<blocks, kExchangeThreads, 0, stream>>>(
        static_cast<K*>(keys), static_cast<P*>(pay), quads, n_pad_log, stage, j);
    return static_cast<int>(cudaGetLastError());
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
// `runs` 8192-runs (K3), or `rows` rows of 2^n_pad_log elements (K4), or
// `rows` rows of 2^n_blocks_log 8192-blocks (K5).

extern "C" int bitonic_sort_runs(void* keys, void* payload, int key_type, int payload_bytes,
                                 int64_t runs, void* stream) {
  return dispatch<SortRuns>(key_type, payload_bytes, keys, payload, runs,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int bitonic_block_exchange(void* keys, void* payload, int key_type,
                                      int payload_bytes, int64_t rows, int n_pad_log,
                                      int stage, int j, void* stream) {
  return dispatch<BlockExchange>(key_type, payload_bytes, keys, payload, rows, n_pad_log, stage,
                                 j, static_cast<cudaStream_t>(stream));
}

extern "C" int bitonic_tail(void* keys, void* payload, int key_type, int payload_bytes,
                            int64_t rows, int n_blocks_log, int stage, void* stream) {
  return dispatch<Tail>(key_type, payload_bytes, keys, payload, rows, n_blocks_log, stage,
                        static_cast<cudaStream_t>(stream));
}
