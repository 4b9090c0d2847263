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
//    memory, up to the ceilings below.
// 4. Run lengths and emit.  The sorted keys go to shared memory once;
//    each run start looks at the next key and, only if that repeats
//    it, finds its run end by binary search for the first larger key;
//    the row is written with coalesced int32 stores.
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

static_assert((1 << kLogKeysWide) <= cfrk::kUnitBases &&
                  kLogKeys <= kLogKeysWide,
              "a thread's windows must start in one packed unit");

template <bool kLarge>
using KeyOf = typename std::conditional<kLarge, uint64_t, uint32_t>::type;

// The kernel's variants (see the file header); the C entry point of the
// probe takes their numbers.
enum Variant : int {
  kEmit = 0,
  kFull = 1,
  kSortOnly = 2,
  kRleOnly = 3,
  kNoop = 4
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
// at a time (`p` is aligned to kKeys keys).
template <typename Key, int kKeys>
__device__ __forceinline__ void store_keys(Key* p, const Key (&v)[kKeys]) {
#pragma unroll
  for (int e = 0; e < kKeys; e += 16 / int(sizeof(Key))) {
    if constexpr (sizeof(Key) == 4) {
      *reinterpret_cast<uint4*>(p + e) =
          make_uint4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    } else {
      *reinterpret_cast<ulonglong2*>(p + e) = make_ulonglong2(v[e], v[e + 1]);
    }
  }
}

template <typename Key, int kKeys>
__device__ __forceinline__ void load_keys(Key (&v)[kKeys], const Key* p) {
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

// Rows of up to kMaxRegWidth keys: `width` (a power of two in
// [kMinWidth, kRegThreads * kKeys], >= n) keys a row, width / kKeys
// threads a row, kRegThreads * kKeys / width rows a block.
template <bool kLarge, int kVariant, int kKeys, bool kChecksum = false>
__global__ void __launch_bounds__(kRegThreads)
    rowsort_rle_regs(const int8_t* __restrict__ codes,
                     int32_t* __restrict__ key_out,
                     int32_t* __restrict__ lo_out,
                     int32_t* __restrict__ cnt_out, int64_t* __restrict__ chk,
                     int B, int L, int W, int n, int width, int k,
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
  if constexpr (sorts(kVariant)) sort_in_registers(v, srow, t, width);
  store_keys(srow + p0, v);
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

template <bool kLarge, int kVariant, bool kChecksum = false>
int launch(const int8_t* codes, int32_t* key_out, int32_t* lo_out,
           int32_t* cnt_out, int64_t* chk, int B, int L, int W, int k,
           int canonical, cudaStream_t stream) {
  using Key = KeyOf<kLarge>;
  int n = 1;
  while (n < W) n <<= 1;
  if (n <= kMaxRegWidth) {
    const int width = n < kMinWidth ? kMinWidth : n;
    const bool wide_keys = width > (kRegThreads << kLogKeys) ||
                           (!kLarge && width >= kWideFrom32);
    const int rows = (kRegThreads << (wide_keys ? kLogKeysWide : kLogKeys)) / width;
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
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
