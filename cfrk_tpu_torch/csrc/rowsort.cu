// Fused per-read k-mer key build + bitonic row sort + run-length encode.
//
// Replaces the Pallas TPU kernels rowsort_rle_pallas (k <= 15) and
// rowsort_rle_pallas_large (16 <= k <= 31) of
// cfrk_tpu/ops/pallas/rowsort.py.  Output is array-equal to the plain
// route of cfrk_tpu_torch/ops/perread_sparse.py: for each read, the
// window keys sorted ascending; a run start holds the key and its run
// length, every other cell the sentinel and count 0.
//
// What bounds it on the H100.  The bytes through device memory are
// small: L int8 codes in and 8-12 bytes per window out, 18-24 MB for a
// batch of 8192 reads in 256 columns, 5.5-7.3 us at 3.35 TB/s.  The
// work between them is what costs: n log2(n)(log2(n)+1)/4
// compare-exchanges per row of n keys, the run-end searches, and the
// key build.  The design keeps all three out of device memory and as
// far as it can out of shared memory and block barriers.  Measured with
// the probe at 8192 reads of 150 bases, k = 8 (PERF.md): the sort now
// leads with about half of the kernel's 19 us (its compare-exchanges
// and shuffles, near the rate at which an SM executes either), then
// staging, packing and key build with the launch itself (a third),
// then run lengths and emit.
//
// Stages, each done once per row:
//
// 1. Stage and pack.  A block copies the codes of its rows, which are
//    contiguous in device memory, into shared memory with aligned
//    16-byte loads (the ragged ends byte by byte, never past the
//    batch), then packs each row into 16-base units of 2 bits a base
//    plus one invalid bit a base (cfrk::pack_unit of kmer_key.cuh).
// 2. Key build.  A window's key is a funnel shift out of two or three
//    units, its validity a funnel shift of the invalid bits, its
//    reverse complement a bit reversal (cfrk::packed_window_key): the
//    cost does not grow with k.  No [B, W] key array crosses device
//    memory.
// 3. Sort.  Rows of up to 4096 keys sort in registers.  A thread holds
//    8 consecutive keys (16 in uint32 rows of 256 keys and more, and in
//    any row of 4096): strides below that are register
//    compare-exchanges, strides up to 16 times that are warp shuffles,
//    and only the strides that pair two warps (rows of 512 keys and
//    more at 8 keys a thread, of 1024 at 16) go through shared memory
//    with a block barrier.  A row of 256 keys takes 32 or 16 threads
//    and no barrier, so a block of 256 threads serves 8 or 16 rows and
//    a batch of 8192 reads is a grid of 1024 or 512 blocks.  Rows above
//    4096 keys keep one block a row and the bitonic network in shared
//    memory, up to the ceilings below.  Rows of up to 256 uint64 keys
//    (k > 15) sort 32-bit prefix-and-position words instead, then
//    gather their full keys (rowsort_rle_prefix, below).  At k <= 8, rows
//    whose W lies just above a power of two P, in batches that fill the
//    card, sort a head of P cells and a short tail apart, two reads a
//    word, and merge each read's tail into its head in shared memory
//    (rowsort_rle_split, below).
// 4. Run lengths and emit.  The sorted keys go to shared memory once;
//    each run start looks at the next key and, only if that repeats
//    it, finds its run end by binary search for the first larger key;
//    the row is written with coalesced int32 stores.
//
// Two keys a register (k <= 8, rows of up to 4096 keys): a key is below
// 4**8 and fits 16 bits, so rowsort_rle_pairs holds two in each 32-bit
// word, word j keys j and j + width/2, and sorts both halves of the row
// at once with Hopper's packed min.u16x2 / max.u16x2: one instruction
// each orders two pairs, one shuffle moves two keys.  The halves sort
// with the bitonic network's flip form, in which every pair ascends, so
// no compare-exchange needs a direction; the upper half's keys are
// complemented meanwhile, which makes it descend.  One stage inside each
// word and the final merge's cleaners, again two keys an instruction,
// finish the row.  A padding cell takes 0xFFFF, which at k = 8 is also
// a real key (TTTTTTTT): each row counts its real windows, n_valid, and
// after the sort cells [0, n_valid) are exactly its real keys in order,
// since no padding value is below a real key.  The emit treats the cells
// from n_valid on as sentinels and cuts the last run there; it writes
// the same int32 words as the uint32 path.
//
// Two reads a word (k <= 8, P < W <= P + (P >> kSplitShift), P in
// [kMinSplitHead, kMaxSplitHead], batches of at least kMinSplitBlocks
// blocks of the split): the path above would sort 2P cells a row, most
// of them padding (113 of 256 for 150 bp reads at k = 8).
// rowsort_rle_split instead puts cells [0, P) of two reads in the two
// lanes of one set of words, read a low and read b high, and sorts both
// lanes ascending with one flip-form network of P words: half the
// network a read, and no complemented lane or final merge.  Cells
// [P, W), padded to a power of two T >= kMinTail, sort the same way, two
// reads a word.  Each read's sorted head and tail then go to shared
// memory, and every key goes straight to its cell of the merged row: a
// head key's cell is its index plus the tail's keys < it, a tail key's
// its index plus the head's keys <= it, both found by one search a
// thread and a walk along the tail beside the thread's consecutive head
// keys (merge_row).  A pair of rows lies within a warp, so nothing
// between the staging and the emit waits on a block barrier.  The emit
// reads the merged row as the path above reads its sorted row, with the
// same n_valid cut.  Measured with the probe at [100000, 150], k = 8
// (PERF.md): the kernel 0.118 -> 0.089 ms, the sort 0.052 -> 0.037 ms,
// and the key build 0.053 -> 0.039 ms, since 144 windows a read are
// built and packed where the 2P-cell row built 256.
//
// Keys: k <= 15 sorts uint32 with sentinel 4**k; k > 15 sorts one
// uint64 `hi << 30 | lo` (< 4**31 for a real window) with sentinel
// all-ones, and splits back to the (hi, lo) uint32 words at emit.  A
// TPU split the key only because 64-bit integers are slow there.  The
// all-ones sentinel also settles the 16-T case at k = 31, whose real
// hi word equals the uint32 sentinel.
//
// Ceilings: a block's shared memory (227 KB) caps the row at n = 32768
// windows for uint32 keys and 16384 for uint64 keys (128 KB of keys,
// 12 KB of packed codes; the next power of two would need 256 KB).
// Longer rows go through count_perread_rows_tiled, which cuts them
// into tiles of that width.
//
// Step-time probe: the kernels' Variant parameter swaps the emit for
// one int64 checksum per row and leaves out stages, so the probe
// (cfrk_tpu_torch/tools/rowsort_probe.py, the port of
// tools/rowsort_probe.py) times this production code and nothing else:
//   kFull      build + sort + run-end search, sum over run starts of
//              (count & 3) + (key & 3);
//   kSortOnly  build + sort, sum of ((key ^ i) & 3) over the W cells;
//   kRleOnly   build + the run-end search on the UNSORTED keys, with
//              kFull's checksum;
//   kNoop      build, with kSortOnly's checksum.
// At k <= 8 the variants take the two-keys-a-register path of the
// production kernel; its 16-bit cells hold 0xFFFF for padding, so the
// sorted variants read the cells from n_valid on, and the unsorted ones
// the cells of invalid windows, as the sentinel 4**k.
//   kFallbacks (the prefix path only) one flag a row: whether its
//              gathered keys were repaired (register_rows).
// kEmit is the production kernel.  The searches run over the first
// n = 2**ceil(log2 W) keys of the row whatever width the sort takes, so
// kRleOnly's checksum on unsorted keys does not depend on the path;
// kRleOnly alone searches without the look at the next key, which is
// exact on sorted rows only.
//
// Checksum: kEmit with kChecksum (the JAX kernels' checksum=True) also
// writes chk[block], the sum over the block's rows of kFull's row
// checksum, (count & 3) + (key & 3) over the run starts (the key's low
// word for k > 15, whose low two bits are the key's), rows past B
// counting zero.  A bench consumes it to keep the row writes alive
// without reading them back.  The run lengths and keys are those the
// emit holds in registers: one block reduction and one store a block,
// no pass over the outputs.  Without kChecksum the kernel is the
// production kernel unchanged.
//
// The C entry points launch on the stream they are given, allocate
// nothing and return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "block_sum.cuh"
#include "kmer_key.cuh"

namespace {

constexpr int kLoBits = 30;  // 15 low bases of a k > 15 key
constexpr int kMaxThreads = 1024;
constexpr unsigned kFullWarp = 0xffffffffu;

// The register path: a block of kRegThreads threads; a thread holds
// 2**kLogKeys consecutive keys of a row of kMinWidth .. kRegThreads <<
// kLogKeys keys, or 2**kLogKeysWide keys where those are faster or the
// only way: the one width above, and uint32 rows from kWideFrom32 keys
// on.  Measured on the H100 (tools/rowsort_sweep.py, PERF.md): 16 keys
// a thread save uint32 rows a third of their shuffles and 9 % of the
// kernel at 256 keys a row, cost either key type a quarter at 128, and
// change uint64 rows of 256 by under 1 %; they carry rows of 4096 keys,
// which then beat the shared-memory network by 1.7x.
constexpr int kLogKeys = 3;
constexpr int kLogKeysWide = 4;
constexpr int kWideFrom32 = 256;
constexpr int kRegThreads = 256;
constexpr int kMinWidth = 32;
constexpr int kMaxRegWidth = kRegThreads << kLogKeysWide;

// The two-keys-a-register path (k <= kMaxPairK) holds as many keys a
// thread as the uint32 path, two a word, in the same rows a block: a
// sweep of its own counts (tools/rowsort_sweep.py, PERF.md) found none
// faster at any width.
constexpr int kMaxPairK = 8;
constexpr uint32_t kPad16 = 0xFFFFu;

// The split of rows just above a power of two P (rowsort_rle_split): a
// tail of at most P >> kSplitShift windows, heads of kMinSplitHead to
// kMaxSplitHead cells (a pair of rows within one warp at kSplitWords
// words a thread), tails padded to at least kMinTail cells (16 bytes),
// in grids of at least kMinSplitBlocks blocks.  Measured on the H100
// (PERF.md), the split is faster than the 2P-cell row up to W - P = P / 4
// at P = 64, 128 and 256 in batches of 100 000 reads, and slower from
// W - P = 3P / 8 at P = 128.  A pair of rows takes half the threads of
// one 2P-cell row, so a batch too small to fill the card runs on fewer
// threads: in grids of 128 blocks the split lost 18-35 %, of 256 blocks
// -11 to +11 %, of 512 blocks and more it gained 7-22 % at every W
// measured (129, 143, 160, 257, 320); at P = 64 it lost a third at
// 8192 reads, so P = 64 keeps the 2P-cell row.
constexpr int kSplitShift = 2;
constexpr int kMinSplitHead = 128;
constexpr int kMaxSplitHead = 256;
constexpr int kSplitWords = 1 << (kLogKeysWide - 1);
constexpr int kMinTail = 8;
constexpr int kMinSplitBlocks = 512;
static_assert(kMaxSplitHead / kSplitWords <= 32, "a pair of rows lies within a warp");
static_assert(kSplitShift >= 2 && kMinTail <= kMinSplitHead / kSplitWords,
              "a tail takes at most two words a thread");

static_assert((1 << kLogKeysWide) <= cfrk::kUnitBases &&
                  kLogKeys <= kLogKeysWide,
              "a thread's windows must start in one packed unit");
static_assert(kLogKeys >= 1, "a thread holds at least one word of two keys");

template <bool kLarge>
using KeyOf = typename std::conditional<kLarge, uint64_t, uint32_t>::type;

// The kernel's variants (see the file header); the C entry point of the
// probe takes their numbers.
enum Variant : int {
  kEmit = 0,
  kFull = 1,
  kSortOnly = 2,
  kRleOnly = 3,
  kNoop = 4,
  kFallbacks = 5
};

__host__ __device__ constexpr bool sorts(int variant) {
  return variant == kEmit || variant == kFull || variant == kSortOnly;
}

// Packed units a row of `width` sort keys needs: its windows start below
// `width` and reach 30 bases further, and a 64-bit key reads three
// units from the one its window starts in.  Even, so that the 16-bit
// invalid words of a row start on a 32-bit boundary.
__host__ __device__ constexpr int units_of(int width) {
  return width / cfrk::kUnitBases + 2;
}

// Stage 1: the codes of rows [row0, row0 + rows) of the batch, which
// are contiguous in device memory, go to `raw` with aligned 16-byte
// loads, then each row is packed into `units_per_row` units (bases) and
// 16-bit invalid words.  Rows at or past B pack as all invalid.  Never
// reads outside codes[0 .. B*L).  Every thread of the block calls it;
// it ends on a barrier, after which `raw` is dead.
__device__ __forceinline__ void stage_rows(const int8_t* __restrict__ codes,
                                           int64_t B, int L, int64_t row0,
                                           int rows, int units_per_row,
                                           int8_t* raw, uint32_t* units,
                                           uint16_t* invalid) {
  const int64_t total = B * L;
  const int64_t begin = row0 * L;
  const int64_t last_row = row0 + rows < B ? row0 + rows : B;
  const int span = int(last_row * L - begin);
  const int skew = int(reinterpret_cast<uintptr_t>(codes + begin) & 15);
  const int chunks = (skew + span + 15) >> 4;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int64_t g = begin - skew + 16 * int64_t(c);
    if (g >= 0 && g + 16 <= total) {
      reinterpret_cast<int4*>(raw)[c] =
          *reinterpret_cast<const int4*>(codes + g);
    } else {
      for (int b = 0; b < 16; ++b) {
        if (g + b >= 0 && g + b < total) raw[16 * c + b] = codes[g + b];
      }
    }
  }
  __syncthreads();
  for (int u = threadIdx.x; u < rows * units_per_row; u += blockDim.x) {
    const int r = u / units_per_row;
    const int first = (u - r * units_per_row) * cfrk::kUnitBases;
    const int avail = row0 + r < B ? L - first : 0;
    uint32_t bases, bad;
    cfrk::pack_unit(raw + skew + r * L + first, avail, bases, bad);
    units[u] = bases;
    invalid[u] = uint16_t(bad);
  }
  __syncthreads();
}

// Stage 2 for one window: the key of window p of a packed row (`bad` is
// the row's invalid words read as 32-bit).
template <typename Key>
__device__ __forceinline__ Key key_at(const uint32_t* units,
                                      const uint32_t* bad, int p, int k,
                                      bool canonical, Key sentinel) {
  const uint32_t* u = units + (p >> 4);
  const uint32_t* m = bad + (p >> 5);
  return cfrk::packed_window_key<Key>(
      u[0], u[1], u[2], __funnelshift_r(m[0], m[1], p & 31), p & 15, k,
      canonical, sentinel);
}

// Order a <= b when ascending, a >= b otherwise: one comparison folded
// with the direction into one predicate, then a select a word.
template <typename Key>
__device__ __forceinline__ void compare_exchange(Key& a, Key& b,
                                                 bool ascending) {
  const bool exchange = (b < a) == ascending;
  const Key x = exchange ? b : a;
  b = exchange ? a : b;
  a = x;
}

// One stage of the bitonic network on s[0..n) in shared memory: `pairs`
// threads-worth of pairs at `stride`, starting at pair t, step `step`.
template <typename Key>
__device__ __forceinline__ void shared_stage(Key* s, int size, int stride,
                                             int t, int step, int pairs) {
  for (int q = t; q < pairs; q += step) {
    const int i = 2 * q - (q & (stride - 1));
    const int j = i + stride;
    const Key a = s[i];
    const Key b = s[j];
    const bool ascending = (i & size) == 0;
    if ((a > b) == ascending) {
      s[i] = b;
      s[j] = a;
    }
  }
}

// Ascending bitonic sort of s[0..n), n a power of two, by the block.
template <typename Key>
__device__ __forceinline__ void bitonic_sort(Key* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      shared_stage(s, size, stride, int(threadIdx.x), int(blockDim.x), n >> 1);
      __syncthreads();
    }
  }
}

// A thread's kKeys consecutive keys to and from shared memory, 16 bytes
// at a time (`p` is aligned to kKeys keys), or one by one where they are
// fewer.
template <typename Key, int kKeys>
__device__ __forceinline__ void store_keys(Key* p, const Key (&v)[kKeys]) {
  if constexpr (kKeys * sizeof(Key) < 16) {
#pragma unroll
    for (int e = 0; e < kKeys; ++e) p[e] = v[e];
  } else {
#pragma unroll
    for (int e = 0; e < kKeys; e += 16 / int(sizeof(Key))) {
      if constexpr (sizeof(Key) == 4) {
        *reinterpret_cast<uint4*>(p + e) =
            make_uint4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      } else {
        *reinterpret_cast<ulonglong2*>(p + e) =
            make_ulonglong2(v[e], v[e + 1]);
      }
    }
  }
}

template <typename Key, int kKeys>
__device__ __forceinline__ void load_keys(Key (&v)[kKeys], const Key* p) {
  if constexpr (kKeys * sizeof(Key) < 16) {
#pragma unroll
    for (int e = 0; e < kKeys; ++e) v[e] = p[e];
  } else {
#pragma unroll
    for (int e = 0; e < kKeys; e += 16 / int(sizeof(Key))) {
      if constexpr (sizeof(Key) == 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(p + e);
        v[e] = q.x;
        v[e + 1] = q.y;
        v[e + 2] = q.z;
        v[e + 3] = q.w;
      } else {
        const ulonglong2 q = *reinterpret_cast<const ulonglong2*>(p + e);
        v[e] = q.x;
        v[e + 1] = q.y;
      }
    }
  }
}

// The compare-exchanges of one merge at strides below kKeys: both keys
// of a pair are the thread's own.
template <typename Key, int kKeys>
__device__ __forceinline__ void register_strides(Key (&v)[kKeys],
                                                 bool ascending) {
#pragma unroll
  for (int stride = kKeys >> 1; stride > 0; stride >>= 1) {
#pragma unroll
    for (int e = 0; e < kKeys; ++e) {
      if ((e & stride) == 0) {
        compare_exchange(v[e], v[e | stride], ascending);
      }
    }
  }
}

// Stage 3 of the register path: ascending bitonic sort of a row of
// `width` keys held by width / kKeys threads, thread t the keys
// [t * kKeys, (t + 1) * kKeys).  The network is bitonic_sort's: pair
// (i, i + stride) of a merge of `size` ascends iff (i & size) == 0.
// `srow` is the row's place in shared memory, used only by strides that
// pair two warps; every thread of the block must call this with the
// same `width` (those strides end on block barriers).
template <typename Key, int kKeys>
__device__ __forceinline__ void sort_in_registers(Key (&v)[kKeys], Key* srow,
                                                  int t, int width) {
  // Strides from here on pair keys of different warps.
  constexpr int kWarpSpan = 32 * kKeys;
  // Merges of up to kKeys keys lie inside one thread.
#pragma unroll
  for (int size = 2; size <= kKeys; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int e = 0; e < kKeys; ++e) {
        if ((e & stride) == 0) {
          const bool ascending =
              size < kKeys ? (e & size) == 0 : (t & 1) == 0;
          compare_exchange(v[e], v[e | stride], ascending);
        }
      }
    }
  }
  const int threads = width / kKeys;
  for (int size = 2 * kKeys; size <= width; size <<= 1) {
    const bool ascending = (t & (size / kKeys)) == 0;
    int stride = size >> 1;
    if (stride >= kWarpSpan) {
      store_keys(srow + t * kKeys, v);
      __syncthreads();
      for (; stride >= kWarpSpan; stride >>= 1) {
        shared_stage(srow, size, stride, t, threads, width >> 1);
        __syncthreads();
      }
      load_keys(v, srow + t * kKeys);
    }
    for (; stride >= kKeys; stride >>= 1) {
      const int lane_mask = stride / kKeys;
      const bool keep_low = ((t & lane_mask) == 0) == ascending;
#pragma unroll
      for (int e = 0; e < kKeys; ++e) {
        const Key other = __shfl_xor_sync(kFullWarp, v[e], lane_mask);
        const bool other_lower = other < v[e];
        v[e] = (other_lower == keep_low) ? other : v[e];
      }
    }
    register_strides(v, ascending);
  }
}

// First index in [lo, hi) whose key is greater than `key` (s is sorted).
template <typename Key>
__device__ __forceinline__ int upper_bound(const Key* s, int lo, int hi,
                                           Key key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] > key) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Where the run of the run start s[i] = key ends.  On a sorted row that
// is the next cell unless it repeats the key, so the search looks there
// first: reads of mostly distinct k-mers then skip the binary search,
// whose scattered reads of shared memory are the stage's cost.  kRleOnly
// searches unsorted keys, where the look ahead would change the
// result, and always runs the whole search.
template <int kVariant, typename Key>
__device__ __forceinline__ int run_end(const Key* s, int i, int n, Key key) {
  if constexpr (kVariant != kRleOnly) {
    if (i + 1 >= n || s[i + 1] > key) return i + 1;
  }
  return upper_bound(s, i + 1, n, key);
}

// Stage 4 for one row: the cells t, t + step, ... of the row's W cells,
// from its keys s[0..n) in shared memory.  kEmit writes the row at
// `base` of the outputs and returns the thread's share of the row's
// checksum with kChecksum, else 0; a probe variant returns that share
// and writes nothing.
template <bool kLarge, int kVariant, bool kChecksum = false>
__device__ __forceinline__ int64_t finish_row(
    const KeyOf<kLarge>* s, int n, int W, int t, int step, int64_t base,
    int32_t* __restrict__ key_out, int32_t* __restrict__ lo_out,
    int32_t* __restrict__ cnt_out, KeyOf<kLarge> sentinel) {
  using Key = KeyOf<kLarge>;
  int64_t acc = 0;
  for (int i = t; i < W; i += step) {
    const Key key = s[i];
    if constexpr (kVariant == kSortOnly || kVariant == kNoop) {
      acc += int((key ^ Key(i)) & 3);
    } else {
      const bool first = key != sentinel && (i == 0 || s[i - 1] != key);
      if constexpr (kVariant == kEmit) {
        const int count = first ? run_end<kVariant>(s, i, n, key) - i : 0;
        cnt_out[base + i] = count;
        if constexpr (kChecksum) {
          if (first) acc += (count & 3) + int(key & 3);
        }
        if constexpr (kLarge) {
          const Key lo_mask = (Key(1) << kLoBits) - 1;
          key_out[base + i] =
              first ? int32_t(uint32_t(key >> kLoBits)) : int32_t(-1);
          lo_out[base + i] =
              first ? int32_t(uint32_t(key & lo_mask)) : int32_t(-1);
        } else {
          key_out[base + i] = int32_t(first ? key : sentinel);
        }
      } else if (first) {
        acc += ((run_end<kVariant>(s, i, n, key) - i) & 3) + int(key & 3);
      }
    }
  }
  return acc;
}

// ---- the flip form of the bitonic network on 32-bit words -----------
//
// Every pair of the flip form ascends, so no compare-exchange needs a
// direction: it is one min and one max.  Two users: the two-keys-a-
// register path (k <= 8), where a word holds two 16-bit keys and
// Hopper's min.u16x2 / max.u16x2 order both lanes at once (kPacked), and
// the prefix-and-position words of the uint64 path (k > 15, rows within
// a warp), whole-word min.u32 / max.u32.

__device__ __forceinline__ uint32_t min_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The smaller and the larger of a and b: of each 16-bit lane with
// kPacked, else of the whole word.
template <bool kPacked>
__device__ __forceinline__ uint32_t lower(uint32_t a, uint32_t b) {
  if constexpr (kPacked) {
    return min_u16x2(a, b);
  } else {
    return min(a, b);
  }
}

template <bool kPacked>
__device__ __forceinline__ uint32_t upper(uint32_t a, uint32_t b) {
  if constexpr (kPacked) {
    return max_u16x2(a, b);
  } else {
    return max(a, b);
  }
}

// Order a and b ascending (both 16-bit lanes with kPacked): no
// direction, no select.
template <bool kPacked>
__device__ __forceinline__ void exchange_words(uint32_t& a, uint32_t& b) {
  const uint32_t lo = lower<kPacked>(a, b);
  b = upper<kPacked>(a, b);
  a = lo;
}

// One stage of the flip-form network on a row's words in shared memory:
// pairs (i, i + span), or with `mirror` (i, i ^ (2 span - 1)), for the
// words' pairs t, t + step, ... of `pairs`.
template <bool kPacked>
__device__ __forceinline__ void shared_words(uint32_t* s, int span,
                                             bool mirror, int t, int step,
                                             int pairs) {
  for (int q = t; q < pairs; q += step) {
    const int i = 2 * q - (q & (span - 1));
    const int j = mirror ? i ^ (2 * span - 1) : i + span;
    uint32_t a = s[i];
    uint32_t b = s[j];
    exchange_words<kPacked>(a, b);
    s[i] = a;
    s[j] = b;
  }
}

// The cleaner strides below kWords: both words of a pair are the
// thread's own.
template <bool kPacked, int kWords>
__device__ __forceinline__ void register_words(uint32_t (&v)[kWords]) {
#pragma unroll
  for (int stride = kWords >> 1; stride > 0; stride >>= 1) {
#pragma unroll
    for (int e = 0; e < kWords; ++e) {
      if ((e & stride) == 0) exchange_words<kPacked>(v[e], v[e | stride]);
    }
  }
}

// The stages of one merge from word stride `stride` (>= kWords) down to
// 1, over `n` words a row held by n / kWords threads: the first is the
// flip form's mirror stage when `mirror` (word i against the merge's
// last word minus its offset), the rest are cleaners.  Strides that pair
// two warps go through shared memory at `srow` with block barriers
// (every thread of the block calls this with the same `n`; rows of up to
// 32 kWords words never take them), then strides of a warp are shuffles,
// where each thread keeps the smaller or the larger of a pair of words
// as a whole; the last are the thread's own.
template <bool kPacked, int kWords>
__device__ __forceinline__ void merge_words(uint32_t (&v)[kWords],
                                            uint32_t* srow, int t, int n,
                                            int stride, bool mirror) {
  constexpr int kWarpSpan = 32 * kWords;
  if (stride >= kWarpSpan) {
    store_keys(srow + t * kWords, v);
    __syncthreads();
    for (; stride >= kWarpSpan; stride >>= 1, mirror = false) {
      shared_words<kPacked>(srow, stride, mirror, t, n / kWords, n >> 1);
      __syncthreads();
    }
    load_keys(v, srow + t * kWords);
  } else if (mirror) {
    // Word e's partner is word kWords - 1 - e of lane t ^ lane_mask.
    const int lane_mask = 2 * stride / kWords - 1;
    const bool keep_low = (t & (stride / kWords)) == 0;
    uint32_t other[kWords];
#pragma unroll
    for (int e = 0; e < kWords; ++e) {
      other[e] = __shfl_xor_sync(kFullWarp, v[kWords - 1 - e], lane_mask);
    }
#pragma unroll
    for (int e = 0; e < kWords; ++e) {
      v[e] = keep_low ? lower<kPacked>(v[e], other[e])
                      : upper<kPacked>(v[e], other[e]);
    }
    stride >>= 1;
  }
  for (; stride >= kWords; stride >>= 1) {
    const int lane_mask = stride / kWords;
    const bool keep_low = (t & lane_mask) == 0;
#pragma unroll
    for (int e = 0; e < kWords; ++e) {
      const uint32_t other = __shfl_xor_sync(kFullWarp, v[e], lane_mask);
      v[e] = keep_low ? lower<kPacked>(v[e], other) : upper<kPacked>(v[e], other);
    }
  }
  register_words<kPacked>(v);
}

// Ascending sort of a row of `n` words (of each 16-bit lane on its own
// with kPacked), thread t the words [t * kWords, (t + 1) * kWords), by
// the flip form: a merge of `size` pairs word i first with
// i ^ (size - 1), then cleans at size / 4, ..., 1.  `srow` as for
// merge_words.
template <bool kPacked, int kWords>
__device__ __forceinline__ void flip_sort(uint32_t (&v)[kWords],
                                          uint32_t* srow, int t, int n) {
  // Merges of up to kWords words lie inside one thread.
#pragma unroll
  for (int size = 2; size <= kWords; size <<= 1) {
#pragma unroll
    for (int e = 0; e < kWords; ++e) {
      if ((e & (size >> 1)) == 0) exchange_words<kPacked>(v[e], v[e ^ (size - 1)]);
    }
#pragma unroll
    for (int stride = size >> 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int e = 0; e < kWords; ++e) {
        if ((e & stride) == 0) exchange_words<kPacked>(v[e], v[e | stride]);
      }
    }
  }
  for (int size = 2 * kWords; size <= n; size <<= 1) {
    merge_words<kPacked>(v, srow, t, n, size >> 1, true);
  }
}

// ---- prefix-and-position words (k > 15, rows within a warp) ---------
//
// A uint64 key costs the select form of the network: a two-word compare,
// a direction and four selects a compare-exchange, two shuffles a key.
// Rows of up to kMaxPrefixWidth keys (one warp's threads, kKeys keys
// each) sort 32-bit words instead, with the flip form's min.u32 /
// max.u32 and one shuffle a word: bit 31 marks the sentinel (an invalid
// window or padding), the next 31 - log2(width) bits are the key's top
// bits, the low log2(width) bits its position.  The sentinel's words sort
// after every real key's, and no real prefix can tie with them.  Each
// thread then gathers the full keys of its sorted words from shared
// memory, where the build left them by position, and checks them: two
// distinct keys that share a prefix are ordered by position, which may
// be wrong.  Equal keys need no order among themselves.  Canonical keys
// share a prefix at every even reverse-complement palindrome of 12
// bases (the reverse complement of the window that ends on it and the
// forward window that starts on it), about 1 % of the rows of 152 bp
// reads at k = 31; such ties come in pairs, adjacent after the sort.  So
// a warp whose gathered keys are out of order first runs up to
// kRepairRounds rounds of odd-even transposition on them, each a few
// instructions a key, and only a warp still out of order then sorts its
// rows' keys again with the uint64 network.  A row lies within a warp:
// neither needs a block barrier.  Wider rows would give the position
// more bits and make ties common: they keep the uint64 network.
// Measured at [100000, 152], k = 31 canonical (PERF.md): the repair
// takes the probe's sort from 0.0565 ms, with the network for every such
// warp, to 0.0508, the time with no repair at all.
constexpr int kMaxPrefixWidth = 32 << kLogKeys;
constexpr int kRepairRounds = 2;
constexpr uint32_t kSentinelWord = 0x80000000u;

// Whether a thread's keys, or its last key and the next thread's first,
// are out of order, in a row held kKeys keys a thread by `threads`
// threads of one warp.
template <int kKeys>
__device__ __forceinline__ bool out_of_order(const uint64_t (&v)[kKeys], int t,
                                             int threads) {
  const uint64_t next = __shfl_down_sync(kFullWarp, v[0], 1);
  bool descent = t + 1 < threads && next < v[kKeys - 1];
#pragma unroll
  for (int e = 0; e + 1 < kKeys; ++e) descent |= v[e + 1] < v[e];
  return descent;
}

// One round of odd-even transposition over such a row: the pairs of
// cells (2i, 2i + 1), then (2i + 1, 2i + 2), of which one pairs a
// thread's last key with the next thread's first.
template <int kKeys>
__device__ __forceinline__ void transposition_round(uint64_t (&v)[kKeys],
                                                    int t, int threads) {
#pragma unroll
  for (int e = 0; e + 1 < kKeys; e += 2) compare_exchange(v[e], v[e + 1], true);
#pragma unroll
  for (int e = 1; e + 1 < kKeys; e += 2) compare_exchange(v[e], v[e + 1], true);
  const uint64_t next = __shfl_down_sync(kFullWarp, v[0], 1);
  const uint64_t prev = __shfl_up_sync(kFullWarp, v[kKeys - 1], 1);
  if (t + 1 < threads && next < v[kKeys - 1]) v[kKeys - 1] = next;
  if (t > 0 && v[0] < prev) v[0] = prev;
}

// Stage 3 of the prefix path for one thread's keys v, cells
// [t * kKeys, (t + 1) * kKeys) of a row of `width` cells (a power of two
// up to 32 kKeys) held by `threads` threads of one warp, at `srow`:
// sorts the row ascending into v and into srow.  Returns the warp's
// ballot of the threads whose gathered keys were out of order: nonzero
// iff the warp repaired its rows.
template <int kKeys>
__device__ __forceinline__ unsigned sort_prefix_words(uint64_t (&v)[kKeys],
                                                      uint64_t* srow, int t,
                                                      int threads, int width,
                                                      int k) {
  const int p0 = t * kKeys;
  store_keys(srow + p0, v);
  const int log_width = __ffs(width) - 1;
  const int shift = max(0, 2 * k - (31 - log_width));
  uint32_t word[kKeys];
#pragma unroll
  for (int e = 0; e < kKeys; ++e) {
    word[e] = (v[e] == ~uint64_t(0) ? kSentinelWord
                                    : uint32_t(v[e] >> shift) << log_width) |
              uint32_t(p0 + e);
  }
  flip_sort<false>(word, nullptr, t, width);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < kKeys; ++e) v[e] = srow[word[e] & (width - 1)];
  const unsigned ballot = __ballot_sync(kFullWarp, out_of_order(v, t, threads));
  unsigned left = ballot;
  for (int round = 0; left && round < kRepairRounds; ++round) {
    transposition_round(v, t, threads);
    left = __ballot_sync(kFullWarp, out_of_order(v, t, threads));
  }
  if (left) sort_in_registers(v, srow, t, width);
  __syncwarp();
  store_keys(srow + p0, v);
  return ballot;
}

// The register path, rows of up to kMaxRegWidth keys: `width` (a power
// of two in [kMinWidth, kRegThreads * kKeys], >= n) keys a row,
// width / kKeys threads a row, kRegThreads * kKeys / width rows a block.
// kPrefix sorts prefix-and-position words (uint64 keys, width up to
// kMaxPrefixWidth); its kFallbacks variant writes chk[row] = 1 where the
// row's own words left its keys out of order, 2 where only another row
// of its warp's did (the warp repairs both), else 0, and nothing else.
template <bool kLarge, int kVariant, int kKeys, bool kChecksum, bool kPrefix>
__device__ __forceinline__ void register_rows(
    const int8_t* __restrict__ codes, int32_t* __restrict__ key_out,
    int32_t* __restrict__ lo_out, int32_t* __restrict__ cnt_out,
    int64_t* __restrict__ chk, int B, int L, int W, int n, int width, int k,
    bool canonical) {
  using Key = KeyOf<kLarge>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long row_sum[kRegThreads * kKeys / kMinWidth];
  const int threads = width / kKeys;  // of one row
  const int rows = kRegThreads / threads;
  const int upr = units_of(width);
  Key* s = reinterpret_cast<Key*>(smem_raw);
  uint32_t* units = reinterpret_cast<uint32_t*>(s + rows * width);
  uint16_t* invalid = reinterpret_cast<uint16_t*>(units + rows * upr);
  const Key sentinel = kLarge ? ~Key(0) : (Key(1) << (2 * k));
  const int64_t row0 = int64_t(blockIdx.x) * rows;
  if constexpr (kVariant != kEmit) {
    if (int(threadIdx.x) < rows) row_sum[threadIdx.x] = 0;
  }

  // The staged codes lie where the sorted keys will: they are dead
  // before the first key is stored.
  stage_rows(codes, B, L, row0, rows, upr, reinterpret_cast<int8_t*>(s),
             units, invalid);

  const int r = int(threadIdx.x) / threads;
  const int t = int(threadIdx.x) - r * threads;
  const bool live = row0 + r < B;
  Key* srow = s + r * width;
  const int p0 = t * kKeys;
  Key v[kKeys];
  {
    const uint32_t* u = units + r * upr + (p0 >> 4);
    const uint32_t* m =
        reinterpret_cast<const uint32_t*>(invalid + r * upr) + (p0 >> 5);
    const uint32_t u0 = u[0], u1 = u[1], u2 = u[2];
    const uint32_t m0 = m[0], m1 = m[1];
#pragma unroll
    for (int e = 0; e < kKeys; ++e) {
      v[e] = (live && p0 + e < W)
                 ? cfrk::packed_window_key<Key>(
                       u0, u1, u2, __funnelshift_r(m0, m1, (p0 & 31) + e),
                       (p0 & 15) + e, k, canonical, sentinel)
                 : sentinel;
    }
  }
  if constexpr (kPrefix && (sorts(kVariant) || kVariant == kFallbacks)) {
    const unsigned ballot = sort_prefix_words(v, srow, t, threads, width, k);
    if constexpr (kVariant == kFallbacks) {
      const int lane0 = int(threadIdx.x) & 31 & ~(threads - 1);
      const unsigned row_lanes =
          (threads == 32 ? kFullWarp : (1u << threads) - 1u) << lane0;
      if (t == 0 && live) {
        chk[row0 + r] = (ballot & row_lanes) ? 1 : (ballot ? 2 : 0);
      }
      return;
    }
  } else {
    if constexpr (sorts(kVariant)) sort_in_registers(v, srow, t, width);
    store_keys(srow + p0, v);
  }
  __syncthreads();

  int64_t acc = 0;
  if (live) {
    acc = finish_row<kLarge, kVariant, kChecksum>(srow, n, W, t, threads,
                                                  (row0 + r) * W, key_out,
                                                  lo_out, cnt_out, sentinel);
  }
  if constexpr (kVariant == kEmit && kChecksum) {
    acc = cfrk::block_sum(acc);
    if (threadIdx.x == 0) chk[blockIdx.x] = acc;
  } else if constexpr (kVariant != kEmit) {
    // The row's checksum: its threads' shares, summed inside each warp
    // and then across the row's warps in shared memory.
    const int span = threads < 32 ? threads : 32;
    for (int o = span >> 1; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(kFullWarp, acc, o);
    }
    if ((t & (span - 1)) == 0) {
      atomicAdd(&row_sum[r], static_cast<unsigned long long>(acc));
    }
    __syncthreads();
    if (int(threadIdx.x) < rows && row0 + threadIdx.x < B) {
      chk[row0 + threadIdx.x] = int64_t(row_sum[threadIdx.x]);
    }
  }
}

template <bool kLarge, int kVariant, int kKeys, bool kChecksum = false>
__global__ void __launch_bounds__(kRegThreads)
    rowsort_rle_regs(const int8_t* __restrict__ codes,
                     int32_t* __restrict__ key_out,
                     int32_t* __restrict__ lo_out,
                     int32_t* __restrict__ cnt_out, int64_t* __restrict__ chk,
                     int B, int L, int W, int n, int width, int k,
                     bool canonical) {
  register_rows<kLarge, kVariant, kKeys, kChecksum, false>(
      codes, key_out, lo_out, cnt_out, chk, B, L, W, n, width, k, canonical);
}

template <int kVariant, int kKeys, bool kChecksum = false>
__global__ void __launch_bounds__(kRegThreads)
    rowsort_rle_prefix(const int8_t* __restrict__ codes,
                       int32_t* __restrict__ key_out,
                       int32_t* __restrict__ lo_out,
                       int32_t* __restrict__ cnt_out,
                       int64_t* __restrict__ chk, int B, int L, int W, int n,
                       int width, int k, bool canonical) {
  static_assert(32 * kKeys >= kMaxPrefixWidth, "a row lies within a warp");
  register_rows<true, kVariant, kKeys, kChecksum, true>(
      codes, key_out, lo_out, cnt_out, chk, B, L, W, n, width, k, canonical);
}

// ---- two keys a register (k <= 8) -----------------------------------

// Ascending sort of a row of 2 * half 16-bit keys held as `half` words,
// word j keys j (low lane) and j + half (high lane), thread t the words
// [t * kWords, (t + 1) * kWords).  Each lane's half sorts with the flip
// form, the high lane complemented so that it ends descending; then the
// row is bitonic, and one stage inside each word (key j against key
// j + half) and the cleaners from half / 2 down merge it.  `srow` as
// for merge_words.
template <int kWords>
__device__ __forceinline__ void sort_pairs(uint32_t (&v)[kWords],
                                           uint32_t* srow, int t, int half) {
#pragma unroll
  for (int e = 0; e < kWords; ++e) v[e] ^= 0xFFFF0000u;
  flip_sort<true>(v, srow, t, half);
#pragma unroll
  for (int e = 0; e < kWords; ++e) {
    const uint32_t w = v[e] ^ 0xFFFF0000u;
    const uint32_t swapped = __byte_perm(w, 0, 0x1032);
    v[e] = __byte_perm(min_u16x2(w, swapped), max_u16x2(w, swapped), 0x7610);
  }
  merge_words<true>(v, srow, t, half, half >> 1, false);
}

// Whether window j of a packed row is real: none of its k codes is < 0
// (`bad`: the row's invalid words read as 32-bit).
__device__ __forceinline__ bool window_real(const uint32_t* bad, int j, int k) {
  return (__funnelshift_r(bad[j >> 5], bad[(j >> 5) + 1], j & 31) &
          ((1u << k) - 1u)) == 0;
}

// Bit e set iff window p + e is real, for e <= 32 - k: the invalid bits
// from p on, each OR-ed with the k - 1 that follow it.
__device__ __forceinline__ uint32_t real_windows(const uint32_t* bad, int p,
                                                 int k) {
  const uint32_t x = __funnelshift_r(bad[p >> 5], bad[(p >> 5) + 1], p & 31);
  uint32_t any = x;
  int span = 1;
  for (; 2 * span <= k; span <<= 1) any |= any >> span;
  if (span < k) any |= any >> (k - span);
  return ~any;
}

// The 16-bit keys of the kWords windows from p (a multiple of kWords):
// key e in `key[e]`, kPad16 where the window is not real.  Returns the
// number of real windows.  kCanonical is a template parameter so that
// the loop holds no branch.
template <bool kCanonical, int kWords>
__device__ __forceinline__ int build_pairs(const uint32_t* units,
                                           const uint32_t* bad, int p, int k,
                                           uint32_t (&key)[kWords]) {
  const uint32_t* u = units + (p >> 4);
  const uint32_t u0 = u[0], u1 = u[1];
  const uint32_t real = real_windows(bad, p, k);
#pragma unroll
  for (int e = 0; e < kWords; ++e) {
    const uint32_t x = cfrk::packed_window_key<uint32_t>(
        u0, u1, 0, 0, (p & 15) + e, k, kCanonical, 0);
    key[e] = (real >> e) & 1u ? x : kPad16;
  }
  return __popc(real & ((1u << kWords) - 1u));
}

// The thread's words: the key of window p_lo + e of one packed row in the
// low lane of v[e], of window p_hi + e of a row (the same one or another)
// in its high lane.  Returns the low lane's number of real windows in the
// low 16 bits, the high lane's above.
template <bool kCanonical, int kWords>
__device__ __forceinline__ uint32_t build_words(
    const uint32_t* units_lo, const uint32_t* bad_lo, int p_lo,
    const uint32_t* units_hi, const uint32_t* bad_hi, int p_hi, int k,
    uint32_t (&v)[kWords]) {
  uint32_t lo[kWords];
  uint32_t hi[kWords];
  const uint32_t valid =
      uint32_t(build_pairs<kCanonical>(units_lo, bad_lo, p_lo, k, lo)) |
      uint32_t(build_pairs<kCanonical>(units_hi, bad_hi, p_hi, k, hi)) << 16;
#pragma unroll
  for (int e = 0; e < kWords; ++e) v[e] = lo[e] | (hi[e] << 16);
  return valid;
}

// Stage 4 for one row of 16-bit cells s[0..n), or at least its first W
// cells: as finish_row, with the cells from n_valid on (sorted variants)
// or of invalid windows (unsorted) read as the sentinel 4**k.
template <int kVariant, bool kChecksum = false>
__device__ __forceinline__ int64_t finish_pairs_row(
    const uint16_t* s, const uint32_t* bad, int n_valid, int n, int W, int k,
    int t, int step, int64_t base, int32_t* __restrict__ key_out,
    int32_t* __restrict__ cnt_out) {
  const uint32_t sentinel = 1u << (2 * k);
  int64_t acc = 0;
  for (int i = t; i < W; i += step) {
    const uint16_t key = s[i];
    if constexpr (kVariant == kSortOnly || kVariant == kNoop) {
      const bool real =
          kVariant == kSortOnly ? i < n_valid : window_real(bad, i, k);
      acc += int(((real ? key : sentinel) ^ uint32_t(i)) & 3);
    } else if constexpr (kVariant == kRleOnly) {
      // Unsorted cells: a search step treats an invalid window's cell, and
      // every cell from W on (a row may hold fewer than n), as the
      // sentinel, above every key.
      if (window_real(bad, i, k) &&
          (i == 0 || !window_real(bad, i - 1, k) || s[i - 1] != key)) {
        int lo = i + 1;
        int hi = n;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (mid >= W || !window_real(bad, mid, k) || s[mid] > key) {
            hi = mid;
          } else {
            lo = mid + 1;
          }
        }
        acc += ((lo - i) & 3) + int(key & 3);
      }
    } else {
      const bool first = i < n_valid && (i == 0 || s[i - 1] != key);
      const int count = first ? run_end<kVariant>(s, i, n_valid, key) - i : 0;
      if constexpr (kVariant == kEmit) {
        cnt_out[base + i] = count;
        key_out[base + i] = int32_t(first ? uint32_t(key) : sentinel);
      }
      if (kVariant != kEmit || kChecksum) {
        if (first) acc += (count & 3) + int(key & 3);
      }
    }
  }
  return acc;
}

// Rows of up to kMaxRegWidth keys at k <= kMaxPairK: `width` (a power of
// two in [kMinWidth, 2 * kRegThreads * kWords], >= n) keys a row as
// width / 2 words, width / (2 * kWords) threads a row,
// 2 * kRegThreads * kWords / width rows a block.  Eight blocks an SM
// (32 registers a thread, no spill; 40 without the bound) take 2 % off
// a call of 100 000 rows of 256 keys (PERF.md).
template <int kVariant, int kWords, bool kChecksum = false>
__global__ void __launch_bounds__(kRegThreads, 8)
    rowsort_rle_pairs(const int8_t* __restrict__ codes,
                      int32_t* __restrict__ key_out,
                      int32_t* __restrict__ cnt_out,
                      int64_t* __restrict__ chk, int B, int L, int W, int n,
                      int width, int k, bool canonical) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kMaxRows = 2 * kRegThreads * kWords / kMinWidth;
  __shared__ unsigned long long row_sum[kMaxRows];
  __shared__ int row_valid[kMaxRows];
  const int half = width >> 1;
  const int threads = half / kWords;  // of one row
  const int rows = kRegThreads / threads;
  const int upr = units_of(width);
  uint16_t* s = reinterpret_cast<uint16_t*>(smem_raw);
  uint32_t* units = reinterpret_cast<uint32_t*>(s + rows * width);
  uint16_t* invalid = reinterpret_cast<uint16_t*>(units + rows * upr);
  const int64_t row0 = int64_t(blockIdx.x) * rows;
  if (int(threadIdx.x) < rows) {
    row_valid[threadIdx.x] = 0;
    if constexpr (kVariant != kEmit) row_sum[threadIdx.x] = 0;
  }

  // As in rowsort_rle_regs, the staged codes lie where the keys will.
  stage_rows(codes, B, L, row0, rows, upr, reinterpret_cast<int8_t*>(s),
             units, invalid);

  const int r = int(threadIdx.x) / threads;
  const int t = int(threadIdx.x) - r * threads;
  uint16_t* srow = s + r * width;
  const uint32_t* urow = units + r * upr;
  const uint32_t* bad = reinterpret_cast<const uint32_t*>(invalid + r * upr);
  const int p0 = t * kWords;
  // Windows past W, and every window of a row past B, hold a code past
  // the row's end, which packs as invalid: the invalid bits alone say
  // which windows are real.
  uint32_t v[kWords];
  const uint32_t both =
      canonical ? build_words<true>(urow, bad, p0, urow, bad, half + p0, k, v)
                : build_words<false>(urow, bad, p0, urow, bad, half + p0, k, v);
  int valid = int((both & 0xFFFFu) + (both >> 16));
  // n_valid: the row's threads' counts, summed inside each warp and then
  // across the row's warps.
  const int span = threads < 32 ? threads : 32;
  for (int o = span >> 1; o > 0; o >>= 1) {
    valid += __shfl_xor_sync(kFullWarp, valid, o);
  }
  if ((t & (span - 1)) == 0) atomicAdd(&row_valid[r], valid);

  if constexpr (sorts(kVariant)) {
    uint32_t* words = reinterpret_cast<uint32_t*>(srow);
    sort_pairs(v, words, t, half);
    // Strides that paired two warps left words of other threads where
    // the cells below go.
    if (half >= 64 * kWords) __syncthreads();
  }
  // Key j of the row to srow[j]: the low lanes to [p0, p0 + kWords), the
  // high lanes to [half + p0, ...), two keys a 32-bit word.
  uint32_t low2[kWords / 2];
  uint32_t high2[kWords / 2];
#pragma unroll
  for (int e = 0; e < kWords; e += 2) {
    low2[e / 2] = __byte_perm(v[e], v[e + 1], 0x5410);
    high2[e / 2] = __byte_perm(v[e], v[e + 1], 0x7632);
  }
  store_keys(reinterpret_cast<uint32_t*>(srow + p0), low2);
  store_keys(reinterpret_cast<uint32_t*>(srow + half + p0), high2);
  __syncthreads();

  int64_t acc = 0;
  if (row0 + r < B) {
    acc = finish_pairs_row<kVariant, kChecksum>(
        srow, bad, row_valid[r], n, W, k, t, threads, (row0 + r) * W,
        key_out, cnt_out);
  }
  if constexpr (kVariant == kEmit && kChecksum) {
    acc = cfrk::block_sum(acc);
    if (threadIdx.x == 0) chk[blockIdx.x] = acc;
  } else if constexpr (kVariant != kEmit) {
    for (int o = span >> 1; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(kFullWarp, acc, o);
    }
    if ((t & (span - 1)) == 0) {
      atomicAdd(&row_sum[r], static_cast<unsigned long long>(acc));
    }
    __syncthreads();
    if (int(threadIdx.x) < rows && row0 + threadIdx.x < B) {
      chk[row0 + threadIdx.x] = int64_t(row_sum[threadIdx.x]);
    }
  }
}

// ---- two reads a word (k <= 8, W just above a power of two) ---------

// The number of keys of the sorted s[0..n) (n a power of two) below x:
// log2(n) + 1 reads, no branch.
__device__ __forceinline__ int count_below(const uint16_t* s, int n,
                                           uint32_t x) {
  int pos = 0;
  for (int step = n >> 1; step > 0; step >>= 1) {
    pos += uint32_t(s[pos + step - 1]) < x ? step : 0;
  }
  return pos + int(uint32_t(s[pos]) < x);
}

// One thread's share of the merge of one read: its sorted head s[0..head)
// and its sorted tail s[head..head + tail) to the merged row `out`.  The
// thread's head keys j in [p0, p0 + kWords) go to cell j + c, c the
// tail's keys below key j: one search for the first, then a walk along
// the tail.  A tail key the walk passes before head key j, or after the
// last one and below the next thread's first (head key p0 + kWords, or
// above every key on the last thread), has exactly j head keys at most
// it, and goes to its index plus j.  The walk of thread 0 starts at the
// tail's first key, so every tail key is placed once.
template <int kWords>
__device__ __forceinline__ void merge_row(const uint16_t* s, int head,
                                          int tail, int p0, uint16_t* out) {
  uint32_t two[kWords / 2];
  load_keys(two, reinterpret_cast<const uint32_t*>(s + p0));
  const uint16_t* tail_keys = s + head;
  int c = p0 == 0 ? 0 : count_below(tail_keys, tail, two[0] & 0xFFFFu);
  // Past the tail, a value above every key stops the walk.
  uint32_t next = c < tail ? tail_keys[c] : 0x10000u;
#pragma unroll
  for (int e = 0; e < kWords; ++e) {
    const uint32_t x = (two[e / 2] >> (16 * (e & 1))) & 0xFFFFu;
    while (next < x) {
      out[c + p0 + e] = uint16_t(next);
      ++c;
      next = c < tail ? tail_keys[c] : 0x10000u;
    }
    out[p0 + e + c] = uint16_t(x);
  }
  const uint32_t bound = p0 + kWords < head ? s[p0 + kWords] : 0x10000u;
  while (next < bound) {
    out[c + p0 + kWords] = uint16_t(next);
    ++c;
    next = c < tail ? tail_keys[c] : 0x10000u;
  }
}

// Rows of W windows at k <= kMaxPairK with head < W <= head + tail, head
// a power of two in [kMinSplitHead, kMaxSplitHead] and tail a power of
// two, tail <= kTailWords * head / kSplitWords: reads 2g and 2g + 1 of a
// block share threads [g * threads, (g + 1) * threads), threads =
// head / kSplitWords, read 2g in the low lanes of their words, read
// 2g + 1 in the high lanes; 2 * kRegThreads / threads reads a block.
// Thread t holds head words [t * kSplitWords, (t + 1) * kSplitWords) and
// tail words [t * kTailWords, (t + 1) * kTailWords) where these are
// below `tail`.  Shared memory: each read's sorted head and tail
// (`cells` = head + tail), then each read's merged row, then the packed
// codes.  The variants are rowsort_rle_pairs'.
template <int kVariant, int kTailWords, bool kChecksum = false>
__global__ void __launch_bounds__(kRegThreads, 8)
    rowsort_rle_split(const int8_t* __restrict__ codes,
                      int32_t* __restrict__ key_out,
                      int32_t* __restrict__ cnt_out,
                      int64_t* __restrict__ chk, int B, int L, int W, int n,
                      int head, int tail, int k, bool canonical) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = head / kSplitWords;  // of one pair of reads
  const int rows = 2 * kRegThreads / threads;
  const int cells = head + tail;
  const int upr = units_of((cells + 31) & ~31);
  uint16_t* s = reinterpret_cast<uint16_t*>(smem_raw);
  uint32_t* units = reinterpret_cast<uint32_t*>(s + 2 * rows * cells);
  uint16_t* invalid = reinterpret_cast<uint16_t*>(units + rows * upr);
  const int64_t row0 = int64_t(blockIdx.x) * rows;

  // The staged codes lie where the sorted heads and tails will.
  stage_rows(codes, B, L, row0, rows, upr, reinterpret_cast<int8_t*>(s),
             units, invalid);

  const int g = int(threadIdx.x) / threads;
  const int t = int(threadIdx.x) - g * threads;
  const int ra = 2 * g;  // the low lanes' read; ra + 1 the high lanes'
  const uint32_t* ua = units + ra * upr;
  const uint32_t* ub = ua + upr;
  const uint32_t* bad_a = reinterpret_cast<const uint32_t*>(invalid + ra * upr);
  const uint32_t* bad_b = reinterpret_cast<const uint32_t*>(invalid + (ra + 1) * upr);
  uint16_t* sa = s + ra * cells;
  uint16_t* sb = sa + cells;
  uint16_t* oa = s + (rows + ra) * cells;
  uint16_t* ob = oa + cells;
  // Windows past W, and every window of a read past B, hold a code past
  // the read's end, which packs as invalid.
  const int p0 = t * kSplitWords;
  const int q0 = t * kTailWords;  // of the tail
  const bool tail_thread = q0 < tail;
  // Sorted variants sort into sa / sb and merge into oa / ob; the others
  // put the unsorted keys by window into oa / ob.  The head is built,
  // sorted and stored before the tail is built, so that the two never
  // hold registers at once.
  uint16_t* da = sorts(kVariant) ? sa : oa;
  uint16_t* db = sorts(kVariant) ? sb : ob;
  uint32_t valid;
  {
    uint32_t v[kSplitWords];
    valid = canonical ? build_words<true>(ua, bad_a, p0, ub, bad_b, p0, k, v)
                      : build_words<false>(ua, bad_a, p0, ub, bad_b, p0, k, v);
    if constexpr (sorts(kVariant)) flip_sort<true>(v, nullptr, t, head);
    uint32_t low2[kSplitWords / 2];
    uint32_t high2[kSplitWords / 2];
#pragma unroll
    for (int e = 0; e < kSplitWords; e += 2) {
      low2[e / 2] = __byte_perm(v[e], v[e + 1], 0x5410);
      high2[e / 2] = __byte_perm(v[e], v[e + 1], 0x7632);
    }
    store_keys(reinterpret_cast<uint32_t*>(da + p0), low2);
    store_keys(reinterpret_cast<uint32_t*>(db + p0), high2);
  }
  uint32_t w[kTailWords];
  if (tail_thread) {
    valid += canonical ? build_words<true>(ua, bad_a, head + q0, ub, bad_b,
                                           head + q0, k, w)
                       : build_words<false>(ua, bad_a, head + q0, ub, bad_b,
                                            head + q0, k, w);
  } else {
#pragma unroll
    for (int e = 0; e < kTailWords; ++e) w[e] = 0xFFFFFFFFu;
  }
  // Each lane's n_valid, summed over the pair's threads (one warp).
  for (int o = threads >> 1; o > 0; o >>= 1) {
    valid += __shfl_xor_sync(kFullWarp, valid, o);
  }
  if constexpr (sorts(kVariant)) flip_sort<true>(w, nullptr, t, tail);
  if (tail_thread) {
#pragma unroll
    for (int e = 0; e < kTailWords; ++e) {
      da[head + q0 + e] = uint16_t(w[e]);
      db[head + q0 + e] = uint16_t(w[e] >> 16);
    }
  }
  if constexpr (sorts(kVariant)) {
    __syncwarp();
    merge_row<kSplitWords>(sa, head, tail, p0, oa);
    merge_row<kSplitWords>(sb, head, tail, p0, ob);
  }
  __syncwarp();

  int64_t acc_a = 0;
  int64_t acc_b = 0;
  if (row0 + ra < B) {
    acc_a = finish_pairs_row<kVariant, kChecksum>(
        oa, bad_a, int(valid & 0xFFFFu), n, W, k, t, threads, (row0 + ra) * W,
        key_out, cnt_out);
  }
  if (row0 + ra + 1 < B) {
    acc_b = finish_pairs_row<kVariant, kChecksum>(
        ob, bad_b, int(valid >> 16), n, W, k, t, threads, (row0 + ra + 1) * W,
        key_out, cnt_out);
  }
  if constexpr (kVariant == kEmit && kChecksum) {
    const int64_t acc = cfrk::block_sum(acc_a + acc_b);
    if (threadIdx.x == 0) chk[blockIdx.x] = acc;
  } else if constexpr (kVariant != kEmit) {
    for (int o = threads >> 1; o > 0; o >>= 1) {
      acc_a += __shfl_xor_sync(kFullWarp, acc_a, o);
      acc_b += __shfl_xor_sync(kFullWarp, acc_b, o);
    }
    if (t == 0 && row0 + ra < B) chk[row0 + ra] = acc_a;
    if (t == 0 && row0 + ra + 1 < B) chk[row0 + ra + 1] = acc_b;
  }
}

// Rows above kMaxRegWidth keys: one block a row, the n keys and the
// whole network in shared memory.
template <bool kLarge, int kVariant, bool kChecksum = false>
__global__ void rowsort_rle_wide(const int8_t* __restrict__ codes,
                                 int32_t* __restrict__ key_out,
                                 int32_t* __restrict__ lo_out,
                                 int32_t* __restrict__ cnt_out,
                                 int64_t* __restrict__ chk, int B, int L,
                                 int W, int n, int k, bool canonical) {
  using Key = KeyOf<kLarge>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int upr = units_of(n);
  Key* s = reinterpret_cast<Key*>(smem_raw);
  uint32_t* units = reinterpret_cast<uint32_t*>(s + n);
  uint16_t* invalid = reinterpret_cast<uint16_t*>(units + upr);
  const Key sentinel = kLarge ? ~Key(0) : (Key(1) << (2 * k));

  stage_rows(codes, B, L, blockIdx.x, 1, upr, reinterpret_cast<int8_t*>(s),
             units, invalid);
  const uint32_t* bad = reinterpret_cast<const uint32_t*>(invalid);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = i < W ? key_at<Key>(units, bad, i, k, canonical, sentinel)
                 : sentinel;
  }
  __syncthreads();
  if constexpr (sorts(kVariant)) bitonic_sort(s, n);

  int64_t acc = finish_row<kLarge, kVariant, kChecksum>(
      s, n, W, int(threadIdx.x), int(blockDim.x), int64_t(blockIdx.x) * W,
      key_out, lo_out, cnt_out, sentinel);
  if constexpr (kVariant != kEmit || kChecksum) {
    acc = cfrk::block_sum(acc);
    if (threadIdx.x == 0) chk[blockIdx.x] = acc;
  }
}

// The power of two n >= W over which a row's searches run, and the
// register path's row width for it.
int search_width(int W) {
  int n = 1;
  while (n < W) n <<= 1;
  return n;
}

int row_width(int n) { return n < kMinWidth ? kMinWidth : n; }

// The head of B rows of W windows split by rowsort_rle_split (the power
// of two below W), or 0 where the rows are not split: the split's grid,
// 2 * kRegThreads * kSplitWords / head reads a block, would hold fewer
// than kMinSplitBlocks blocks.
int split_head(int B, int W, int k) {
  const int head = search_width(W) >> 1;
  const bool split =
      k <= kMaxPairK && head >= kMinSplitHead && head <= kMaxSplitHead &&
      W - head <= (head >> kSplitShift) &&
      B >= kMinSplitBlocks * (2 * kRegThreads * kSplitWords / head);
  return split ? head : 0;
}

// The split's launch: the tail the power of two >= max(W - head,
// kMinTail), held by the pair's threads one or two words each.
template <int kVariant, bool kChecksum = false>
int launch_split(const int8_t* codes, int32_t* key_out, int32_t* cnt_out,
                 int64_t* chk, int B, int L, int W, int n, int head, int k,
                 int canonical, cudaStream_t stream) {
  int tail = kMinTail;
  while (tail < W - head) tail <<= 1;
  const int threads = head / kSplitWords;
  const int rows = 2 * kRegThreads / threads;
  const int cells = head + tail;
  const size_t smem = size_t(rows) * (2 * cells * sizeof(uint16_t) +
                                      units_of((cells + 31) & ~31) * 6);
  const auto kernel = tail <= threads ? rowsort_rle_split<kVariant, 1, kChecksum>
                                      : rowsort_rle_split<kVariant, 2, kChecksum>;
  kernel<<<(B + rows - 1) / rows, kRegThreads, smem, stream>>>(
      codes, key_out, cnt_out, chk, B, L, W, n, head, tail, k, canonical != 0);
  return int(cudaGetLastError());
}

// The prefix path's launch: rows of `width` <= kMaxPrefixWidth uint64
// keys, kRegThreads * kKeys / width rows a block.
template <int kVariant, bool kChecksum = false>
int launch_prefix(const int8_t* codes, int32_t* key_out, int32_t* lo_out,
                  int32_t* cnt_out, int64_t* chk, int B, int L, int W, int n,
                  int width, int k, int canonical, cudaStream_t stream) {
  const int rows = (kRegThreads << kLogKeys) / width;
  const size_t smem = size_t(rows) * width * sizeof(uint64_t) +
                      size_t(rows) * units_of(width) * 6;
  rowsort_rle_prefix<kVariant, 1 << kLogKeys, kChecksum>
      <<<(B + rows - 1) / rows, kRegThreads, smem, stream>>>(
          codes, key_out, lo_out, cnt_out, chk, B, L, W, n, width, k,
          canonical != 0);
  return int(cudaGetLastError());
}

template <bool kLarge, int kVariant, bool kChecksum = false>
int launch(const int8_t* codes, int32_t* key_out, int32_t* lo_out,
           int32_t* cnt_out, int64_t* chk, int B, int L, int W, int k,
           int canonical, cudaStream_t stream) {
  using Key = KeyOf<kLarge>;
  const int n = search_width(W);
  if (n <= kMaxRegWidth) {
    const int width = row_width(n);
    if constexpr (kLarge) {
      if (width <= kMaxPrefixWidth) {
        return launch_prefix<kVariant, kChecksum>(codes, key_out, lo_out,
                                                  cnt_out, chk, B, L, W, n,
                                                  width, k, canonical, stream);
      }
    }
    const bool wide_keys = width > (kRegThreads << kLogKeys) ||
                           (!kLarge && width >= kWideFrom32);
    const int rows = (kRegThreads << (wide_keys ? kLogKeysWide : kLogKeys)) / width;
    if constexpr (!kLarge) {
      if (const int head = split_head(B, W, k)) {
        return launch_split<kVariant, kChecksum>(codes, key_out, cnt_out, chk,
                                                 B, L, W, n, head, k,
                                                 canonical, stream);
      }
      if (k <= kMaxPairK) {
        const size_t smem = size_t(rows) * width * sizeof(uint16_t) +
                            size_t(rows) * units_of(width) * 6;
        const auto kernel =
            wide_keys
                ? rowsort_rle_pairs<kVariant, 1 << (kLogKeysWide - 1), kChecksum>
                : rowsort_rle_pairs<kVariant, 1 << (kLogKeys - 1), kChecksum>;
        kernel<<<(B + rows - 1) / rows, kRegThreads, smem, stream>>>(
            codes, key_out, cnt_out, chk, B, L, W, n, width, k,
            canonical != 0);
        return int(cudaGetLastError());
      }
    }
    const size_t smem = size_t(rows) * width * sizeof(Key) +
                        size_t(rows) * units_of(width) * 6;
    const auto kernel =
        wide_keys
            ? rowsort_rle_regs<kLarge, kVariant, 1 << kLogKeysWide, kChecksum>
            : rowsort_rle_regs<kLarge, kVariant, 1 << kLogKeys, kChecksum>;
    kernel<<<(B + rows - 1) / rows, kRegThreads, smem, stream>>>(
        codes, key_out, lo_out, cnt_out, chk, B, L, W, n, width, k,
        canonical != 0);
    return int(cudaGetLastError());
  }
  const size_t smem = size_t(n) * sizeof(Key) + size_t(units_of(n)) * 6;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rowsort_rle_wide<kLarge, kVariant, kChecksum>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  rowsort_rle_wide<kLarge, kVariant, kChecksum>
      <<<B, kMaxThreads, smem, stream>>>(
      codes, key_out, lo_out, cnt_out, chk, B, L, W, n, k, canonical != 0);
  return int(cudaGetLastError());
}

template <int kVariant>
int launch_probe(const void* codes, void* chk, int B, int L, int W, int k,
                 int canonical, int keys64, void* stream) {
  const auto* c = static_cast<const int8_t*>(codes);
  auto* out = static_cast<int64_t*>(chk);
  const auto s = static_cast<cudaStream_t>(stream);
  return keys64 ? launch<true, kVariant>(c, nullptr, nullptr, nullptr, out, B,
                                         L, W, k, canonical, s)
                : launch<false, kVariant>(c, nullptr, nullptr, nullptr, out,
                                          B, L, W, k, canonical, s);
}

// The probe's kFallbacks variant: uint64 keys on the prefix path only.
int launch_fallbacks(const void* codes, void* chk, int B, int L, int W, int k,
                     int canonical, int keys64, void* stream) {
  const int n = search_width(W);
  const int width = row_width(n);
  if (!keys64 || width > kMaxPrefixWidth) return int(cudaErrorInvalidValue);
  return launch_prefix<kFallbacks>(
      static_cast<const int8_t*>(codes), nullptr, nullptr, nullptr,
      static_cast<int64_t*>(chk), B, L, W, n, width, k, canonical,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// codes [B, L] int8 → idx, counts [B, W] int32 (W = L-k+1, 1 <= k <= 15);
// with chk not null also chk[grid blocks] int64 (see the file header).
int cfrk_rowsort_rle(const void* codes, void* idx_out, void* cnt_out,
                     void* chk, int B, int L, int W, int k, int canonical,
                     void* stream) {
  const auto c = static_cast<const int8_t*>(codes);
  const auto idx = static_cast<int32_t*>(idx_out);
  const auto cnt = static_cast<int32_t*>(cnt_out);
  const auto out = static_cast<int64_t*>(chk);
  const auto s = static_cast<cudaStream_t>(stream);
  return chk ? launch<false, kEmit, true>(c, idx, nullptr, cnt, out, B, L, W,
                                          k, canonical, s)
             : launch<false, kEmit>(c, idx, nullptr, cnt, nullptr, B, L, W, k,
                                    canonical, s);
}

// codes [B, L] int8 → hi, lo (uint32 bit patterns), counts [B, W] int32
// (W = L-k+1, 16 <= k <= 31); chk as for cfrk_rowsort_rle.
int cfrk_rowsort_rle_large(const void* codes, void* hi_out, void* lo_out,
                           void* cnt_out, void* chk, int B, int L, int W,
                           int k, int canonical, void* stream) {
  const auto c = static_cast<const int8_t*>(codes);
  const auto hi = static_cast<int32_t*>(hi_out);
  const auto lo = static_cast<int32_t*>(lo_out);
  const auto cnt = static_cast<int32_t*>(cnt_out);
  const auto out = static_cast<int64_t*>(chk);
  const auto s = static_cast<cudaStream_t>(stream);
  return chk ? launch<true, kEmit, true>(c, hi, lo, cnt, out, B, L, W, k,
                                         canonical, s)
             : launch<true, kEmit>(c, hi, lo, cnt, nullptr, B, L, W, k,
                                   canonical, s);
}

// Probe variant `variant` (1 full, 2 sortonly, 3 rleonly, 4 noop) of the
// kernel: codes [B, L] int8 → chk [B] int64, one checksum per row.
// keys64 = 0 sorts uint32 keys (k <= 15), 1 uint64 keys (k > 15).
// Variant 5 (kFallbacks, keys64 = 1 and rows of up to kMaxPrefixWidth
// keys) writes each row's repair flag instead (register_rows).
int cfrk_rowsort_probe(const void* codes, void* chk, int B, int L, int W,
                       int k, int canonical, int keys64, int variant,
                       void* stream) {
  switch (variant) {
    case kFull:
      return launch_probe<kFull>(codes, chk, B, L, W, k, canonical, keys64,
                                 stream);
    case kSortOnly:
      return launch_probe<kSortOnly>(codes, chk, B, L, W, k, canonical,
                                     keys64, stream);
    case kRleOnly:
      return launch_probe<kRleOnly>(codes, chk, B, L, W, k, canonical, keys64,
                                    stream);
    case kNoop:
      return launch_probe<kNoop>(codes, chk, B, L, W, k, canonical, keys64,
                                 stream);
    case kFallbacks:
      return launch_fallbacks(codes, chk, B, L, W, k, canonical, keys64,
                              stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
