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
// The C entry points launch on the stream they are given, allocate
// nothing and return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

template <bool kLarge>
__global__ void rowsort_rle_kernel(const int8_t* __restrict__ codes,
                                   int32_t* __restrict__ key_out,
                                   int32_t* __restrict__ lo_out,
                                   int32_t* __restrict__ cnt_out, int L,
                                   int W, int n, int k, bool canonical) {
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
  bitonic_sort(s, n);

  const int64_t base = int64_t(blockIdx.x) * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const Key key = s[i];
    const bool first = key != sentinel && (i == 0 || s[i - 1] != key);
    cnt_out[base + i] = first ? upper_bound(s, i + 1, n, key) - i : 0;
    if constexpr (kLarge) {
      const Key lo_mask = (Key(1) << kLoBits) - 1;
      key_out[base + i] =
          first ? int32_t(uint32_t(key >> kLoBits)) : int32_t(-1);
      lo_out[base + i] = first ? int32_t(uint32_t(key & lo_mask)) : int32_t(-1);
    } else {
      key_out[base + i] = int32_t(first ? key : sentinel);
    }
  }
}

template <bool kLarge>
int launch(const int8_t* codes, int32_t* key_out, int32_t* lo_out,
           int32_t* cnt_out, int B, int L, int W, int k, int canonical,
           cudaStream_t stream) {
  using Key = typename std::conditional<kLarge, uint64_t, uint32_t>::type;
  int n = 1;
  while (n < W) n <<= 1;
  int threads = n / 2;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = size_t(n) * sizeof(Key);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rowsort_rle_kernel<kLarge>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  rowsort_rle_kernel<kLarge><<<B, threads, smem, stream>>>(
      codes, key_out, lo_out, cnt_out, L, W, n, k, canonical != 0);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes [B, L] int8 → idx, counts [B, W] int32 (W = L-k+1, 1 <= k <= 15).
int cfrk_rowsort_rle(const void* codes, void* idx_out, void* cnt_out, int B,
                     int L, int W, int k, int canonical, void* stream) {
  return launch<false>(static_cast<const int8_t*>(codes),
                       static_cast<int32_t*>(idx_out), nullptr,
                       static_cast<int32_t*>(cnt_out), B, L, W, k, canonical,
                       static_cast<cudaStream_t>(stream));
}

// codes [B, L] int8 → hi, lo (uint32 bit patterns), counts [B, W] int32
// (W = L-k+1, 16 <= k <= 31).
int cfrk_rowsort_rle_large(const void* codes, void* hi_out, void* lo_out,
                           void* cnt_out, int B, int L, int W, int k,
                           int canonical, void* stream) {
  return launch<true>(static_cast<const int8_t*>(codes),
                      static_cast<int32_t*>(hi_out),
                      static_cast<int32_t*>(lo_out),
                      static_cast<int32_t*>(cnt_out), B, L, W, k, canonical,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
