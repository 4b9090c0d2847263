// Fused per-read k-mer key build + bitonic row sort + run-length encode.
//
// Replaces the Pallas TPU kernels rowsort_rle_pallas (k <= 15) and
// rowsort_rle_pallas_large (16 <= k <= 31) of
// cfrk_tpu/ops/pallas/rowsort.py.  Output is array-equal to the plain
// route of cfrk_tpu_torch/ops/perread_sparse.py: for each read, the
// window keys sorted ascending; a run start holds the key and its run
// length, every other cell the sentinel and count 0.
//
// Design: one thread block per read row.  Each thread builds the keys
// of its windows straight from the int8 codes (cfrk::window_key of
// kmer_key.cuh: a k-step loop; any code < 0 makes the window invalid;
// canonical = min(forward, revcomp)), so no [B, W] key array
// round-trips through device memory.  The keys sit
// in shared memory, padded with the sentinel to a power of two n, and
// an in-place bitonic network sorts them.  Each run start then finds
// its run end by binary search for the first larger key.
//
// Keys: k <= 15 sorts uint32 with sentinel 4**k; k > 15 sorts one
// uint64 `hi << 30 | lo` (< 4**31 for a real window) with sentinel
// all-ones, and splits back to the (hi, lo) uint32 words at emit.  A
// TPU split the key only because 64-bit integers are slow there.  The
// all-ones sentinel also settles the 16-T case at k = 31, whose real
// hi word equals the uint32 sentinel.
//
// Bounds on the H100: a block's shared memory (227 KB) caps the row at
// n = 32768 windows for uint32 keys and 16384 for uint64 keys (128 KB
// each; the next power of two would need 256 KB).  Longer rows go
// through count_perread_rows_tiled, which cuts them into tiles of that
// width.  Within the cap the sort is bound by shared-memory traffic and
// the __syncthreads of its log2(n)(log2(n)+1)/2 stages; the bytes moved
// through device memory (L int8 codes in, 8-12 bytes per window out)
// are small beside that.
//
// Step-time probe: the kernel template's Variant parameter swaps the
// emit for one int64 checksum per row and leaves out stages, so the
// probe (cfrk_tpu_torch/tools/rowsort_probe.py, the port of
// tools/rowsort_probe.py) times this production code and nothing else:
//   kFull      build + sort + run-end search, sum over run starts of
//              (count & 3) + (key & 3);
//   kSortOnly  build + sort, sum of ((key ^ i) & 3) over the W cells;
//   kRleOnly   build + the run-end search on the UNSORTED keys, with
//              kFull's checksum;
//   kNoop      build, with kSortOnly's checksum.
// kEmit is the production kernel; its instantiation is unchanged.
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

// Ascending bitonic sort of s[0..n), n a power of two, by the block.
template <typename Key>
__device__ __forceinline__ void bitonic_sort(Key* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const Key a = s[i];
        const Key b = s[j];
        const bool ascending = (i & size) == 0;
        if ((a > b) == ascending) {
          s[i] = b;
          s[j] = a;
        }
      }
      __syncthreads();
    }
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

// The kernel's variants (see the file header); the C entry point of the
// probe takes their numbers.
enum Variant : int {
  kEmit = 0,
  kFull = 1,
  kSortOnly = 2,
  kRleOnly = 3,
  kNoop = 4
};

template <bool kLarge, int kVariant>
__global__ void rowsort_rle_kernel(const int8_t* __restrict__ codes,
                                   int32_t* __restrict__ key_out,
                                   int32_t* __restrict__ lo_out,
                                   int32_t* __restrict__ cnt_out,
                                   int64_t* __restrict__ chk, int L, int W,
                                   int n, int k, bool canonical) {
  using Key = typename std::conditional<kLarge, uint64_t, uint32_t>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Key* s = reinterpret_cast<Key*>(smem_raw);
  const Key sentinel = kLarge ? ~Key(0) : (Key(1) << (2 * k));
  const int8_t* row = codes + int64_t(blockIdx.x) * L;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = i < W ? cfrk::window_key<Key>(row, i, k, canonical, sentinel)
                 : sentinel;
  }
  __syncthreads();
  if constexpr (kVariant == kEmit || kVariant == kFull ||
                kVariant == kSortOnly) {
    bitonic_sort(s, n);
  }

  if constexpr (kVariant == kEmit) {
    const int64_t base = int64_t(blockIdx.x) * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      const Key key = s[i];
      const bool first = key != sentinel && (i == 0 || s[i - 1] != key);
      cnt_out[base + i] = first ? upper_bound(s, i + 1, n, key) - i : 0;
      if constexpr (kLarge) {
        const Key lo_mask = (Key(1) << kLoBits) - 1;
        key_out[base + i] =
            first ? int32_t(uint32_t(key >> kLoBits)) : int32_t(-1);
        lo_out[base + i] =
            first ? int32_t(uint32_t(key & lo_mask)) : int32_t(-1);
      } else {
        key_out[base + i] = int32_t(first ? key : sentinel);
      }
    }
  } else {
    int64_t acc = 0;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      const Key key = s[i];
      if constexpr (kVariant == kFull || kVariant == kRleOnly) {
        const bool first = key != sentinel && (i == 0 || s[i - 1] != key);
        if (first) {
          acc += ((upper_bound(s, i + 1, n, key) - i) & 3) + int(key & 3);
        }
      } else {
        acc += int((key ^ Key(i)) & 3);
      }
    }
    acc = cfrk::block_sum(acc);
    if (threadIdx.x == 0) chk[blockIdx.x] = acc;
  }
}

template <bool kLarge, int kVariant>
int launch(const int8_t* codes, int32_t* key_out, int32_t* lo_out,
           int32_t* cnt_out, int64_t* chk, int B, int L, int W, int k,
           int canonical, cudaStream_t stream) {
  using Key = typename std::conditional<kLarge, uint64_t, uint32_t>::type;
  int n = 1;
  while (n < W) n <<= 1;
  int threads = n / 2;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = size_t(n) * sizeof(Key);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rowsort_rle_kernel<kLarge, kVariant>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  rowsort_rle_kernel<kLarge, kVariant><<<B, threads, smem, stream>>>(
      codes, key_out, lo_out, cnt_out, chk, L, W, n, k, canonical != 0);
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

// codes [B, L] int8 → idx, counts [B, W] int32 (W = L-k+1, 1 <= k <= 15).
int cfrk_rowsort_rle(const void* codes, void* idx_out, void* cnt_out, int B,
                     int L, int W, int k, int canonical, void* stream) {
  return launch<false, kEmit>(static_cast<const int8_t*>(codes),
                              static_cast<int32_t*>(idx_out), nullptr,
                              static_cast<int32_t*>(cnt_out), nullptr, B, L,
                              W, k, canonical,
                              static_cast<cudaStream_t>(stream));
}

// codes [B, L] int8 → hi, lo (uint32 bit patterns), counts [B, W] int32
// (W = L-k+1, 16 <= k <= 31).
int cfrk_rowsort_rle_large(const void* codes, void* hi_out, void* lo_out,
                           void* cnt_out, int B, int L, int W, int k,
                           int canonical, void* stream) {
  return launch<true, kEmit>(static_cast<const int8_t*>(codes),
                             static_cast<int32_t*>(hi_out),
                             static_cast<int32_t*>(lo_out),
                             static_cast<int32_t*>(cnt_out), nullptr, B, L, W,
                             k, canonical, static_cast<cudaStream_t>(stream));
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
