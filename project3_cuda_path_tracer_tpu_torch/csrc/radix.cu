// The radix route of the big-mesh path for Hopper (sm_90a): two kernels
// that replace the JAX package's binary-radix machinery (ops/pipeline.py),
// which _sorted_mesh_merge runs in place of both lax.sorts of its
// compacted stream when PT_TPU_SORT_RADIX=1 (_radix_sort_stream,
// _radix_unsort_stream):
//
//   radix_split_kernel      #15 _kr_partition and #16 _kr_stitch2 in one
//                           single-pass launch: each element of a stream,
//                           its key and its payload words to its place in
//                           the stable split by a digit of the key;
//   radix_unscatter_kernel  #17 _kr_unpartition, the whole unsort in one
//                           launch: out[k][entry[i]] = in[k][i], each
//                           result back at its entry id, carried by the
//                           sort.
//
// A split is STABLE: the elements in order of their digit, and in their
// order within a digit. Two kinds (the template argument):
//
//   a digit pass over the first *count elements of a stream, digit (key >>
//     shift) & (2^width - 1), width <= 8. width = 1 at shift b is one LSB
//     binary pass, the function of one _kr_partition + _kr_stitch2 call;
//     the route runs ceil(bits / 8) 8-bit passes (bits = bit_length(2 x
//     supernodes): one pass up to 127 supernodes), whose composition is
//     the one-bit passes' stable permutation;
//   the compaction split over A's slot-major (E, n) keys, flag 0 iff the
//     entry is real: its column j is listed (j < *count, #7's list) and
//     its key is below the dead key. Only the listed columns are visited
//     (elements v = slot * count + j). Its zeros are the real entries in
//     entry-id order (the stable compaction of #12 _kc_compact and #13
//     _ks_stitch); its ones are not placed. Its payload is gathered by
//     column (A's object-space ray of lane j); it writes each real entry's
//     id slot * n + j, the stream's length, and the digit histograms of
//     the real keys for the passes that follow.
//
// Single pass, decoupled look-back (Merrill & Garland's single-pass scan,
// Adinets & Merrill's Onesweep): a persistent grid (as many blocks as stay
// resident) takes tiles of kTile elements from a device-side counter, in
// arrival order, and stops at the first tile past the stream's length. In
// a tile, warp w holds elements [w * 32 * kKeys, (w + 1) * 32 * kKeys), its
// lane l element 32 * i + l of them for i < kKeys: a warp ranks its
// elements in order, one row of 32 at a time (__match_any_sync over the
// digits, each digit's running count in shared memory), so a rank is the
// element's place among its digit's elements of the warp. Per digit, the
// warps' counts scan to each warp's offset in the tile and sum to the
// tile's count, published at once as the tile's aggregate (status word:
// flag and count in 32 bits). Thread d then walks back over the earlier
// tiles' words of digit d, kWindow words loaded at once, adding
// aggregates until it reaches an inclusive prefix, and publishes the
// tile's inclusive prefix. An element's place: the digit's base (the
// exclusive scan of the stream's digit histogram, computed by each block
// from its 256 counters) + the digit's count in earlier tiles + the
// warp's offset + its rank. A digit pass writes through shared memory:
// the tile in its own sorted order (digit by digit), so consecutive
// threads write each digit's run side by side. A tile waits only on tiles
// taken before it, whose blocks are running and publish their aggregates
// before they look back, so the wait ends.
//
// No host sync and no scan launch: the length and the histogram stay on
// the device; the tile counters and look-back words of one sort (one
// buffer: the compaction split's, then each pass's) are zeroed by one
// cudaMemsetAsync, issued by the compaction split's entry point.
// Bound: bytes. A digit pass moves its key and its payload words (32 B in
// and 32 B out per entry of the route's stream: the key, the six ray
// words and the id); the compaction split reads the listed columns' keys
// and rays and writes 32 B per real entry; the unscatter reads the id and
// C's 16 B and writes 16 B per entry. What the design does about it: no
// block runs for the capacity past the stream; one launch per split, its
// look-back in place of a count launch and a scan launch; reads coalesce
// (a warp's row of 32 consecutive elements), and writes land in runs (the
// compaction's in order, a pass's staged by digit). The unscatter's
// writes are scattered by nature (a stable sort's order of ids). The
// TPU's per-tile routing networks (Mosaic has no gather or scatter)
// become a warp match, a staged tile and a scatter.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // ops/pipeline.py::RADIX_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 8;                  // elements a thread holds
constexpr int kTile = kThreads * kKeys;   // ops/pipeline.py::RADIX_TILE
constexpr int kMaxWidth = 8;              // a digit's bits at most
constexpr int kDigits = 1 << kMaxWidth;   // ops/pipeline.py::RADIX_DIGITS
constexpr int kMaxPasses = 4;             // ops/pipeline.py::RADIX_MAX_PASSES
constexpr int kMaxWords = 8;              // ops/pipeline.py::RADIX_MAX_WORDS
constexpr int kWindow = 4;                // look-back words loaded at once
static_assert(kThreads == kDigits, "thread d scans and looks back for digit d");

// A look-back word: 0 until the tile publishes; then a flag and a count.
constexpr unsigned kAggregate = 1u << 30;  // the tile's own count
constexpr unsigned kInclusive = 2u << 30;  // the count of this and every earlier tile
constexpr unsigned kCountMask = kAggregate - 1u;

// The arrays of 32-bit words a launch moves: out[k][dest] = in[k][src].
struct Words {
  const unsigned* in[kMaxWords];
  unsigned* out[kMaxWords];
  int n;
};

struct Split {
  const int* key;    // (capacity,) stream keys, or A's (E, n) slot-major keys
  const int* count;  // the stream's length, or #7's listed lanes (compaction)
  const int* hist;   // digit pass: the stream's count of each digit value
  int n;             // compaction: the pool size, the keys' row stride
  int E;             // compaction: the slots (rows) of the keys
  int shift;         // digit pass: the digit's lowest key bit
  int width;         // digit pass: its bits; compaction: the route's key bits
  int dead;          // compaction: the dead key 2 * n_supers
};

struct Out {
  int* key;     // the split stream's keys
  int* entry;   // compaction: each real entry's id slot * n + j
  int* length;  // compaction: the real entries (written by the last tile)
  int* hist;    // compaction: (passes, kDigits) digit counts, accumulated
};

struct Work {
  int* tiles;         // the tile counter, zero at launch
  unsigned* status;   // (tiles x digits) look-back words, zero at launch
  unsigned* probe;    // optional (nullptr): [look-back steps, spins]
};

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The count of digit d in the tiles before `tile` (words of tile t at
// status[t * stride]): aggregates summed back to the first inclusive
// prefix, kWindow earlier tiles' words loaded at once (independent loads
// in place of a chain of dependent ones), waiting where a tile has not
// published yet. probe (nullptr: none) counts the words summed (steps)
// and the windows read again without progress (spins).
__device__ __forceinline__ int look_back(const unsigned* status, int stride, int tile,
                                         unsigned* probe) {
  int sum = 0;
  unsigned steps = 0, spins = 0;
  bool done = false;
  for (int t = tile - 1; !done;) {
    unsigned v[kWindow];
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      v[k] = t - k >= 0 ? load_status(status + static_cast<size_t>(t - k) * stride)
                        : kInclusive;  // before tile 0: nothing
    }
    bool open = true;
    int used = 0;
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      if (open && v[k] == 0u) open = false;  // not published: read again from here
      if (open) {
        sum += static_cast<int>(v[k] & kCountMask);
        ++used;
        if (v[k] & kInclusive) open = false, done = true;
      }
    }
    steps += used;
    spins += used == 0;
    t -= used;
  }
  if (probe != nullptr) {
    atomicAdd(probe, steps);
    atomicAdd(probe + 1, spins);
  }
  return sum;
}

// The exclusive prefix of v over the block's threads in order. Every
// thread calls it (it holds barriers).
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_sums[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_sums[w];
  __syncthreads();
  return before + x - v;
}

template <bool kCompact>
__global__ void __launch_bounds__(kThreads)
    radix_split_kernel(const Split s, const Words w, const Out o, const Work work) {
  __shared__ int s_warp[kWarps][kDigits];  // per warp: running counts, then offsets
  __shared__ int s_base[kDigits];          // a digit's place before this tile
  __shared__ int s_hist[kCompact ? kMaxPasses : 1][kDigits];
  __shared__ unsigned s_stage[kCompact ? 1 : kTile];  // a digit pass's tile, sorted
  __shared__ int s_sums[kWarps];
  __shared__ int s_tile;
  const int d = threadIdx.x;  // the digit this thread scans and looks back for
  const int lane = d & 31;
  const int warp = d >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int R = kCompact ? 1 : 1 << s.width;  // the digit values
  const int listed = kCompact ? __ldg(s.count) : 0;
  const int len = kCompact ? s.E * listed : __ldg(s.count);
  const int passes = kCompact ? (s.width + kMaxWidth - 1) / kMaxWidth : 0;
  if (kCompact) {
    for (int x = threadIdx.x; x < passes * kDigits; x += kThreads) {
      s_hist[x / kDigits][x % kDigits] = 0;
    }
  }
  int start = 0;  // thread d: digit d's first place in the split stream
  bool started = false;
  for (;;) {
    if (threadIdx.x == 0) s_tile = atomicAdd(work.tiles, 1);
    __syncthreads();
    const int tile = s_tile;
    const int base = tile * kTile;
    if (base >= len) break;  // the whole block, at once
    if (!kCompact && !started) {
      start = block_exclusive_scan(d < R ? __ldg(s.hist + d) : 0, s_sums);
      started = true;
    }
    for (int x = threadIdx.x; x < kWarps * kDigits; x += kThreads) (&s_warp[0][0])[x] = 0;
    __syncthreads();
    int key[kKeys], digit[kKeys], rank[kKeys], src[kKeys], id[kKeys];
    const int first = base + warp * (32 * kKeys) + lane;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int v = first + 32 * i;
      digit[i] = -1;  // not placed: past the length, or not real
      key[i] = 0;
      src[i] = v;
      id[i] = 0;
      if (v < len) {
        if constexpr (kCompact) {
          const int slot = v / listed;
          const int j = v - slot * listed;
          id[i] = slot * s.n + j;
          src[i] = j;
          key[i] = __ldg(s.key + id[i]);
          if (key[i] < s.dead) digit[i] = 0;
        } else {
          key[i] = __ldg(s.key + v);
          digit[i] = (key[i] >> s.shift) & (R - 1);
        }
      }
    }
    // each row of 32 in order: the lanes of one digit take consecutive
    // ranks after the digit's count so far in this warp
    if constexpr (kCompact) {
      int run = 0;  // the warp's real elements so far
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const unsigned real = __ballot_sync(0xffffffffu, digit[i] == 0);
        rank[i] = run + __popc(real & below);
        run += __popc(real);
        if (digit[i] == 0) {  // the real key's digits, into the block's histograms
          for (int p = 0; p < passes; ++p) {
            const int bits = min(kMaxWidth, s.width - kMaxWidth * p);
            atomicAdd(&s_hist[p][(key[i] >> (kMaxWidth * p)) & ((1 << bits) - 1)], 1);
          }
        }
      }
      if (lane == 0) s_warp[warp][0] = run;
    } else {
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const unsigned peers = __match_any_sync(0xffffffffu, digit[i]);
        const int before = __popc(peers & below);
        int prior = 0;
        if (digit[i] >= 0) prior = s_warp[warp][digit[i]];
        __syncwarp();
        if (digit[i] >= 0 && before == 0) s_warp[warp][digit[i]] = prior + __popc(peers);
        __syncwarp();
        rank[i] = prior + before;
      }
    }
    __syncthreads();
    // per digit: each warp's offset among the tile's elements of the
    // digit and their count, published at once as the tile's aggregate
    int count = 0;
    unsigned* mine = work.status + static_cast<size_t>(tile) * R + d;
    if (d < R) {
      for (int x = 0; x < kWarps; ++x) {
        const int c = s_warp[x][d];
        s_warp[x][d] = count;
        count += c;
      }
      store_status(mine, (tile == 0 ? kInclusive : kAggregate) | static_cast<unsigned>(count));
    }
    // the digit's first place in the tile's own sorted order (a digit
    // pass; the compaction split has one digit)
    const int local = kCompact ? 0 : block_exclusive_scan(count, s_sums);
    if (d < R) {
      int earlier = 0;
      if (tile > 0) {
        earlier = look_back(work.status + d, R, tile, work.probe);
        store_status(mine, kInclusive | static_cast<unsigned>(earlier + count));
      }
      for (int x = 0; x < kWarps; ++x) s_warp[x][d] += local;
      s_base[d] = start + earlier - local;  // tile place p of digit d -> s_base[d] + p
      if (kCompact && base + kTile >= len) *o.length = earlier + count;
    }
    __syncthreads();
    int at[kKeys];  // each element's place in the tile's sorted order
#pragma unroll
    for (int i = 0; i < kKeys; ++i) at[i] = digit[i] < 0 ? -1 : s_warp[warp][digit[i]] + rank[i];
    if constexpr (kCompact) {
      // one digit: a warp's real elements of a row land side by side;
      // word by word, a word's loads for all kKeys elements issued before
      // its stores (one memory round trip per word, not per element)
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        if (at[i] < 0) continue;
        o.key[s_base[0] + at[i]] = key[i];
        o.entry[s_base[0] + at[i]] = id[i];
      }
      for (int k = 0; k < w.n; ++k) {
        unsigned val[kKeys];
#pragma unroll
        for (int i = 0; i < kKeys; ++i) val[i] = at[i] < 0 ? 0u : __ldg(w.in[k] + src[i]);
#pragma unroll
        for (int i = 0; i < kKeys; ++i) {
          if (at[i] >= 0) w.out[k][s_base[0] + at[i]] = val[i];
        }
      }
    } else {
      // the tile in its sorted order through shared memory, so that
      // consecutive threads write each digit's run of the tile side by
      // side: the keys (and each place), then word by word
      const int n_tile = min(kTile, len - base);
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        if (at[i] >= 0) s_stage[at[i]] = static_cast<unsigned>(key[i]);
      }
      __syncthreads();
      int dest[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int p = threadIdx.x + j * kThreads;
        dest[j] = -1;
        if (p < n_tile) {
          const int k = static_cast<int>(s_stage[p]);
          dest[j] = s_base[(k >> s.shift) & (R - 1)] + p;
          o.key[dest[j]] = k;
        }
      }
      // word k + 1's loads issued while word k goes through the stage
      unsigned val[kKeys];
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        val[i] = at[i] < 0 || w.n == 0 ? 0u : __ldg(w.in[0] + src[i]);
      }
      for (int k = 0; k < w.n; ++k) {
        __syncthreads();  // the stage read
#pragma unroll
        for (int i = 0; i < kKeys; ++i) {
          if (at[i] >= 0) s_stage[at[i]] = val[i];
        }
        if (k + 1 < w.n) {
#pragma unroll
          for (int i = 0; i < kKeys; ++i) val[i] = at[i] < 0 ? 0u : __ldg(w.in[k + 1] + src[i]);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          if (dest[j] >= 0) w.out[k][dest[j]] = s_stage[threadIdx.x + j * kThreads];
        }
      }
    }
    __syncthreads();
  }
  if (kCompact) {  // the block's real keys, into the stream's histograms
    for (int x = threadIdx.x; x < passes * kDigits; x += kThreads) {
      const int c = s_hist[x / kDigits][x % kDigits];
      if (c != 0) atomicAdd(o.hist + x, c);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    radix_unscatter_kernel(const int* __restrict__ entry, const int* __restrict__ length,
                           const Words w) {
  const int len = __ldg(length);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < len; i += gridDim.x * kThreads) {
    const int id = __ldg(entry + i);
    unsigned val[kMaxWords];  // every load before the first store
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) val[k] = k < w.n ? __ldg(w.in[k] + i) : 0u;
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) {
      if (k < w.n) w.out[k][id] = val[k];
    }
  }
}

// The blocks of `kernel` that stay resident on `device` (SMs x
// occupancy), queried once per device into `cache` (64 entries).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int device, int* cache, int* out) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
    cache[device] = sms * per_sm;
  }
  *out = cache[device];
  return cudaSuccess;
}

// The persistent grid: the resident blocks, at most one per tile (or per
// kThreads elements) of the capacity.
int grid_of(int resident, long long units) {
  return static_cast<int>(units < resident ? (units > 0 ? units : 1) : resident);
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
// argument).

// One split. shift >= 0: a digit pass over the first *count of `capacity`
// stream elements, digit (key >> shift) & (2^width - 1), hist its 2^width
// counts over the stream; in: n_words arrays of the capacity (the payload
// rows, then the entry ids), out: the same, and key_out; entry_out,
// length_out and hist_out unused (NULL). shift < 0: the compaction split
// of A's (E, n) keys (count: #7's listed lanes), width the route's key
// bits (ceil(width / 8) <= 4 passes); in: n_words arrays of n read by
// column; out: key_out, n_words arrays, entry_out (ids slot * n + j),
// length_out (the real entries) and hist_out ((passes, 256) counts of the
// real keys' 8-bit digits from bit 0 up, added to). tiles / status: the
// split's tile counter and look-back words ((capacity / 2048 rounded up)
// x 2^width words; x 1 for the compaction split), zero at the launch:
// `clear_words` int32 words at `clear` (NULL for none) are zeroed first,
// on the stream. probe: NULL, or 2 words that count the look-back's steps
// and spins.
extern "C" int pt_radix_split(const int* key, const int* count, const int* hist, int capacity,
                              int n, int E, int shift, int width, int dead, void* const* in,
                              void* const* out, int n_words, int* key_out, int* entry_out,
                              int* length_out, int* hist_out, int* tiles, unsigned* status,
                              void* clear, int clear_words, unsigned* probe, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Words w;
  const bool compact = shift < 0;
  const bool bad_digit = compact ? (width < 1 || width > kMaxWidth * kMaxPasses - 1 ||
                                    dead <= 0 || n <= 0 || E <= 0 || entry_out == nullptr ||
                                    length_out == nullptr || hist_out == nullptr)
                                 : (width < 1 || width > kMaxWidth || shift + width > 31 ||
                                    hist == nullptr);
  if (capacity <= 0 || capacity > (1 << 30) - kTile || bad_digit || clear_words < 0 ||
      !make_words(in, out, n_words, &w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clear != nullptr && clear_words > 0) {
    err = cudaMemsetAsync(clear, 0, static_cast<size_t>(clear_words) * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Split sp{key, count, hist, n, E, shift, width, dead};
  const Out o{key_out, entry_out, length_out, hist_out};
  const Work wk{tiles, status, probe};
  const long long n_tiles = (static_cast<long long>(capacity) + kTile - 1) / kTile;
  static int resident[2][64] = {};
  int blocks = 0;
  if (compact) {
    err = resident_blocks(radix_split_kernel<true>, device, resident[1], &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    radix_split_kernel<true><<<grid_of(blocks, n_tiles), kThreads, 0, s>>>(sp, w, o, wk);
  } else {
    err = resident_blocks(radix_split_kernel<false>, device, resident[0], &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    radix_split_kernel<false><<<grid_of(blocks, n_tiles), kThreads, 0, s>>>(sp, w, o, wk);
  }
  return static_cast<int>(cudaGetLastError());
}

// The unsort: for i below *length, out[k][entry[i]] = in[k][i] for each of
// the n_words arrays (in: of the stream's capacity, in sorted order; out:
// of `capacity` words, the rest not written).
extern "C" int pt_radix_unscatter(const int* entry, const int* length, int capacity,
                                  void* const* in, void* const* out, int n_words, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Words w;
  if (capacity <= 0 || !make_words(in, out, n_words, &w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int resident[64] = {};
  int blocks = 0;
  err = resident_blocks(radix_unscatter_kernel, device, resident, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = (static_cast<long long>(capacity) + kThreads - 1) / kThreads;
  radix_unscatter_kernel<<<grid_of(blocks, units), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(entry, length, w);
  return static_cast<int>(cudaGetLastError());
}
