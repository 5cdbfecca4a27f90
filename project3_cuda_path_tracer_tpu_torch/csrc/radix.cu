// The radix route of the big-mesh path for Hopper (sm_90a): three kernels
// that replace the JAX package's binary-radix machinery (ops/pipeline.py),
// which _sorted_mesh_merge runs in place of both lax.sorts of its
// compacted stream when PT_TPU_SORT_RADIX=1 (_radix_sort_stream,
// _radix_unsort_stream):
//
//   radix_counts_kernel     the count half of #15 _kr_partition: per block,
//                           the elements whose split flag is 0;
//   radix_scatter_kernel    #15's packing and #16 _kr_stitch2, folded
//                           together: each element, its key and its payload
//                           words to its place in the split stream;
//   radix_unscatter_kernel  #17 _kr_unpartition: the exact inverse of one
//                           split on the result arrays, out[e] =
//                           in[dest(e)], dest recomputed from the split's
//                           recorded input key and block offsets exactly as
//                           the scatter computed it. No sort, no index rides.
//
// All three share one STABLE split: the elements whose flag is 0 first, in
// their order, then the others, in their order. Two kinds:
//
//   a bit pass (bit >= 0) over the first *count elements of a stream, flag
//     bit `bit` of the key: one LSB radix pass, the function of one
//     _kr_partition + _kr_stitch2 call (whose tile-local packing with
//     cross-tile offsets is the same global stable partition);
//   the compaction split (bit < 0) over A's slot-major (E, n) keys, flag 0
//     iff the entry is real: its column j = e % n is listed (j < *count,
//     #7's list) and its key is below the dead key. Its zeros are the real
//     entries in entry-id order (the stable compaction of #12 _kc_compact
//     and #13 _ks_stitch); its ones are not placed. Its payload is gathered
//     by column (A's object-space ray of lane j). Its unscatter writes the
//     results back to [slot, j] (#14 _kx_expand's function).
//
// The place of element e of block b (kRadixThreads consecutive elements):
// a zero goes to zoff + rank0, a one to t0 + (b * kRadixThreads - zoff) +
// rank1, where zoff = csum[b - 1] (0 for b = 0) is the zeros before block b
// (csum: the inclusive scan of radix_counts, torch.cumsum in the wrapper),
// t0 = csum[last] the split's zeros, rank0 the zeros before e in its block
// (a __ballot_sync prefix in the warp, the earlier warps' counts from
// shared memory) and rank1 the ones before e in its block. Every block
// before the one that holds the stream's end is full, so b * kRadixThreads
// - zoff is the ones before block b.
//
// No host sync: the stream's length stays on the device; every grid is
// sized by the capacity, and blocks past the length return (radix_counts
// first writes their 0).
// Bound: bytes. radix_counts reads each key once (4 B); radix_scatter
// moves the key and the payload words (28 B in, 28 B out per entry of the
// route's stream); radix_unscatter reads the stage key and moves the
// result words (4 + 16 B in, 16 B out). What the design does about it:
// one element per thread, so reads coalesce; a block's zeros and its ones
// each land in one contiguous run, so its writes coalesce within a run;
// the TPU's per-tile routing networks (Mosaic has no gather or scatter)
// become one ballot and one popcount per element.

#include <cuda_runtime.h>

namespace {

constexpr int kRadixThreads = 256;  // ops/pipeline.py::RADIX_BLOCK
constexpr int kWarps = kRadixThreads / 32;
constexpr int kMaxWords = 8;  // ops/pipeline.py::RADIX_MAX_WORDS

inline int blocks_of(int n) { return (n + kRadixThreads - 1) / kRadixThreads; }

// The arrays of 32-bit words a launch moves: out[k][dest] = in[k][src].
struct Words {
  const unsigned* in[kMaxWords];
  unsigned* out[kMaxWords];
  int n;
};

struct Split {
  const int* key;    // (capacity,) stream keys, or A's (E, n) slot-major keys
  const int* count;  // the stream's length, or #7's listed lanes (compaction)
  int capacity;      // elements the grid covers: the stream's buffer, or E * n
  int n;             // compaction: the pool size, the keys' row stride
  int bit;           // the key bit of a pass; < 0: the compaction split
  int dead;          // compaction: the dead key 2 * n_supers
};

// The elements the split orders: [0, length).
__device__ __forceinline__ int split_length(const Split& s) {
  return s.bit < 0 ? s.capacity : __ldg(s.count);
}

// Is element e (below the length) a zero of the split? `listed`: #7's
// count (compaction only).
__device__ __forceinline__ bool is_zero(const Split& s, int e, int listed) {
  if (s.bit < 0) return e % s.n < listed && __ldg(s.key + e) < s.dead;
  return ((__ldg(s.key + e) >> s.bit) & 1) == 0;
}

// The zeros before this thread's element in its block. Every thread of the
// block calls it (it holds a barrier).
__device__ __forceinline__ int block_rank(bool zero) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, zero);
  if (lane == 0) s_warp[warp] = __popc(b);
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  return before + __popc(b & ((1u << lane) - 1u));
}

// The place of element e in the split stream; -1 for a one of the
// compaction split (not placed).
__device__ __forceinline__ int split_dest(const Split& s, const int* __restrict__ csum,
                                          int n_blocks, int e, bool zero, int rank0) {
  const int zoff = blockIdx.x > 0 ? __ldg(csum + blockIdx.x - 1) : 0;
  if (zero) return zoff + rank0;
  if (s.bit < 0) return -1;
  const int base = blockIdx.x * kRadixThreads;
  return __ldg(csum + n_blocks - 1) + (base - zoff) + (e - base - rank0);
}

__global__ void __launch_bounds__(kRadixThreads)
    radix_counts_kernel(const Split s, int* __restrict__ counts) {
  __shared__ int s_count;
  const int len = split_length(s);
  const int base = blockIdx.x * kRadixThreads;
  if (base >= len) {  // the whole block: past the stream
    if (threadIdx.x == 0) counts[blockIdx.x] = 0;
    return;
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const int e = base + threadIdx.x;
  const int listed = s.bit < 0 ? __ldg(s.count) : 0;
  const bool zero = e < len && is_zero(s, e, listed);
  const unsigned b = __ballot_sync(0xffffffffu, zero);
  if ((threadIdx.x & 31) == 0 && b != 0u) atomicAdd(&s_count, __popc(b));
  __syncthreads();
  if (threadIdx.x == 0) counts[blockIdx.x] = s_count;
}

__global__ void __launch_bounds__(kRadixThreads)
    radix_scatter_kernel(const Split s, const int* __restrict__ csum, int n_blocks,
                         const Words w, int* __restrict__ key_out) {
  const int len = split_length(s);
  const int base = blockIdx.x * kRadixThreads;
  if (base >= len) return;  // the whole block
  const int e = base + threadIdx.x;
  const bool valid = e < len;
  const int listed = s.bit < 0 ? __ldg(s.count) : 0;
  const bool zero = valid && is_zero(s, e, listed);
  const int rank0 = block_rank(zero);
  if (!valid) return;
  const int dest = split_dest(s, csum, n_blocks, e, zero, rank0);
  if (dest < 0) return;
  key_out[dest] = __ldg(s.key + e);
  const int src = s.bit < 0 ? e % s.n : e;  // compaction: the lane's payload
  for (int k = 0; k < w.n; ++k) w.out[k][dest] = __ldg(w.in[k] + src);
}

__global__ void __launch_bounds__(kRadixThreads)
    radix_unscatter_kernel(const Split s, const int* __restrict__ csum, int n_blocks,
                           const Words w) {
  const int len = split_length(s);
  const int base = blockIdx.x * kRadixThreads;
  if (base >= len) return;  // the whole block
  const int e = base + threadIdx.x;
  const bool valid = e < len;
  const int listed = s.bit < 0 ? __ldg(s.count) : 0;
  const bool zero = valid && is_zero(s, e, listed);
  const int rank0 = block_rank(zero);
  if (!valid) return;
  const int dest = split_dest(s, csum, n_blocks, e, zero, rank0);
  if (dest < 0) return;
  for (int k = 0; k < w.n; ++k) w.out[k][e] = __ldg(w.in[k] + dest);
}

Split make_split(const int* key, const int* count, int capacity, int n, int bit, int dead) {
  return Split{key, count, capacity, n, bit, dead};
}

// in/out: n_words device pointers each; returns false if n_words is out of
// range.
bool make_words(void* const* in, void* const* out, int n_words, Words* w) {
  if (n_words < 0 || n_words > kMaxWords) return false;
  for (int k = 0; k < kMaxWords; ++k) {
    w->in[k] = k < n_words ? static_cast<const unsigned*>(in[k]) : nullptr;
    w->out[k] = k < n_words ? static_cast<unsigned*>(out[k]) : nullptr;
  }
  w->n = n_words;
  return true;
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t,
// PyTorch's current stream) of CUDA device `device` and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a bad
// argument). A split is (key, count, capacity, n, bit, dead) as in `Split`
// above; csum is the inclusive scan of its radix_counts, one int32 per
// block of 256 elements of the capacity.

// Out: counts (one int32 per block; 0 past the stream's length).
extern "C" int pt_radix_counts(const int* key, const int* count, int capacity, int n, int bit,
                               int dead, int* counts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (capacity <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  radix_counts_kernel<<<blocks_of(capacity), kRadixThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      make_split(key, count, capacity, n, bit, dead), counts);
  return static_cast<int>(cudaGetLastError());
}

// in: the payload's n_words arrays (of the capacity; of n for the
// compaction split, read by column). Out: key_out and the payload's
// n_words arrays, in split order at [0, length) ([0, total) for the
// compaction split).
extern "C" int pt_radix_scatter(const int* key, const int* count, int capacity, int n, int bit,
                                int dead, const int* csum, void* const* in, void* const* out,
                                int n_words, int* key_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Words w;
  if (capacity <= 0 || n <= 0 || !make_words(in, out, n_words, &w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = blocks_of(capacity);
  radix_scatter_kernel<<<blocks, kRadixThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_split(key, count, capacity, n, bit, dead), csum, blocks, w, key_out);
  return static_cast<int>(cudaGetLastError());
}

// in: n_words result arrays in split order. Out: n_words arrays in the
// split's input order (for the compaction split: at each real [slot, j],
// the rest not written).
extern "C" int pt_radix_unscatter(const int* key, const int* count, int capacity, int n,
                                  int bit, int dead, const int* csum, void* const* in,
                                  void* const* out, int n_words, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Words w;
  if (capacity <= 0 || n <= 0 || !make_words(in, out, n_words, &w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = blocks_of(capacity);
  radix_unscatter_kernel<<<blocks, kRadixThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_split(key, count, capacity, n, bit, dead), csum, blocks, w);
  return static_cast<int>(cudaGetLastError());
}
