// Dense per-read k-mer histograms.
//
// Replaces the Pallas TPU kernel count_perread_pallas
// (cfrk_tpu/ops/pallas/perread.py:166, body _perread_kernel :54).  It
// computes what that kernel computes: codes [B, L] int8 → counts[b, key]
// = the number of valid windows of read b with that key, forward or
// canonical (min with the reverse complement), 1 <= k <= 8.  A window is
// valid iff none of its k codes is < 0.  With key = hi * fl + lo, the
// split of split_k (kh = ceil(k/2), fh = 4**kh, fl = 4**(k-kh)), the
// output is one of:
//   * unpacked: [B, fh, fl] int32, one count per cell;
//   * "fh":     [B_pad, fh/2, fl] int32, bin h in bits 31..16 and bin
//               h + fh/2 in bits 15..0 (every count < 2**15);
//   * "b4":     [B_pad, fh/4, fl] int32, bins h, h+q, h+2q, h+3q (q =
//               fh/4) one byte each, highest byte first (every count <
//               256);
// with B_pad = ceil(B / rb) * rb rows, the pad rows all 0.  An optional
// chk[B_pad / rb] adds sum(count & 3) over the unpacked counts of each
// block of rb reads into a zeroed int32 vector.
//
// The TPU kernel contracts one-hot hi/lo tiles of a transposed index
// matrix on the MXU into a VMEM accumulator: that is Mosaic layout, not
// the algorithm.  On Hopper this is a per-row histogram, and its cost is
// writing the output: one 8192-read batch at k = 8 is 2.15 GB unpacked,
// 1.07 GB "fh" and 0.54 GB "b4" (0.64, 0.32 and 0.16 ms at the published
// 3.35 TB/s), against 37 KB of windows a read.  So the design spends
// nothing but the write on a cell that stays 0.
//
// Design.
//
// 1. Count in the output's own layout.  A row of any emit is
//    row_words = 4**k / n words (n = 1, 2, 4 bins a word), and because
//    every factor is a power of two, bin `key` lives in word
//    key & (row_words - 1), field f = key / row_words, at bit
//    (32 / n) * (n - 1 - f).  A shared-memory image of the output words
//    takes atomicAdd(&image[word], 1u << shift) for each window; the
//    wrapper admits "b4" only below 256 windows a read and "fh" below
//    2**15, so a field never carries into its neighbour.  The image is
//    the output, byte for byte: no second pass forms the words.
// 2. Images of at most kImageWords words (64 KB).  A longer row (k = 8
//    "fh" 128 KB, unpacked 256 KB) is cut into contiguous chunks of that
//    size, one work unit each, and a unit counts the windows whose word
//    falls in its chunk; shorter rows share an image, kTileWords words
//    or kMaxTileRows of consecutive reads to a unit (their rows are
//    contiguous in the output).  Several blocks fit an SM, so one
//    block's store overlaps its neighbours' counting.
// 3. The image leaves as one bulk copy of the copy engine
//    (cp.async.bulk.global.shared::cta), started by one thread after every
//    thread has fenced its shared-memory atomics against the async proxy
//    (fence.proxy.async) and the block has met at a barrier.  No thread
//    spends instructions on stores.  A unit whose bytes or address are
//    not multiples of 16 (rows of under 16 bytes at k <= 2, in a ragged
//    last tile) is stored by the threads instead.
// 4. No zero pass.  Blocks are persistent: a block zeroes its image once,
//    and after each unit's copy has read the image
//    (cp.async.bulk.wait_group.read) it rebuilds the unit's keys and
//    clears only the words they touched.  Pad rows are a copy of the
//    clean image.
// 5. The checksum needs no pass over the counts either: atomicAdd
//    returns the word as it was, and a bin that goes from c to c + 1
//    changes sum(count & 3) by -3 when c & 3 == 3 and by +1 otherwise.
//    The deltas are summed per warp and added to chk[row / rb].
//
// Keys come from cfrk::window_key (kmer_key.cuh): a k-step loop over a
// few hundred codes a read, twice (count, clear), which is small beside
// the 64 KB a unit stores.  Counts are exact in uint32 for any row
// length in the unpacked emit.
//
// cfrk_perread_hist_scatter is the plain alternative, kept as the
// design's yardstick (tools/hist_times.py times it after a memset of the
// output): one thread a window adds 1u << shift to the zeroed output in
// device memory.  The port's paths do not call it.
//
// The C entry points launch on the stream they are given, allocate
// nothing and return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "kmer_key.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kImageWords = 16384;  // 64 KB: the largest image of a block
constexpr int kTileWords = 4096;    // rows shorter than this share an image
constexpr int kMaxTileRows = 64;    // ... this many at most
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// Where bin `key` lives in a row of row_words = 1 << log_row_words words
// with kPer bins a word: the word, and the bit its field starts at.
template <int kPer>
__device__ __forceinline__ void bin_place(uint32_t key, int log_row_words,
                                          uint32_t& word, int& shift) {
  word = key & ((1u << log_row_words) - 1u);
  shift = (32 / kPer) * (kPer - 1 - int(key >> log_row_words));
}

// One pass over the windows of a unit's reads: kCount adds each window
// to the image (and its checksum delta to chk), else clears the words
// the windows touched.  Every thread of the block calls it.
template <int kPer, bool kCount>
__device__ __forceinline__ void sweep(const int8_t* __restrict__ codes,
                                      uint32_t* image,
                                      int32_t* __restrict__ chk, int64_t row0,
                                      int n_rows, int B, int L, int W, int k,
                                      bool canonical, int log_row_words,
                                      uint32_t word_lo, uint32_t chunk_words,
                                      int rb) {
  for (int r = 0; r < n_rows && row0 + r < B; ++r) {
    const int8_t* src = codes + (row0 + r) * L;
    uint32_t* row_image = image + size_t(r) * chunk_words;
    int32_t delta = 0;
    for (int p = threadIdx.x; p < W; p += kThreads) {
      const uint32_t key =
          cfrk::window_key<uint32_t>(src, p, k, canonical, kSentinel);
      if (key == kSentinel) continue;
      uint32_t word;
      int shift;
      bin_place<kPer>(key, log_row_words, word, shift);
      word -= word_lo;
      if (word >= chunk_words) continue;  // another unit's chunk
      if constexpr (kCount) {
        const uint32_t old = atomicAdd(&row_image[word], 1u << shift);
        delta += ((old >> shift) & 3u) == 3u ? -3 : 1;
      } else {
        row_image[word] = 0u;
      }
    }
    if constexpr (kCount) {
      if (chk != nullptr) {  // the same for every thread of the block
        for (int o = 16; o > 0; o >>= 1) {
          delta += __shfl_xor_sync(kFullWarp, delta, o);
        }
        if ((threadIdx.x & 31) == 0 && delta != 0) {
          atomicAdd(&chk[(row0 + r) / rb], delta);
        }
      }
    }
  }
}

// A work unit is (tile of tile_rows consecutive rows, chunk of
// chunk_words consecutive words of each row); tile_rows is 1 when a row
// has several chunks.  rows counts the output's rows (the pad rows of a
// packed emit included), units = tiles * chunks.
template <int kPer>
__global__ void __launch_bounds__(kThreads)
    perread_hist_kernel(const int8_t* __restrict__ codes,
                        uint32_t* __restrict__ out, int32_t* __restrict__ chk,
                        int64_t rows, int B, int L, int W, int k,
                        bool canonical, int rb, int log_row_words,
                        int tile_rows, int chunk_words, int64_t units) {
  extern __shared__ __align__(128) uint32_t image[];
  const int chunks = (1 << log_row_words) / chunk_words;
  for (int i = threadIdx.x; i < tile_rows * chunk_words; i += kThreads) {
    image[i] = 0u;
  }
  __syncthreads();
  for (int64_t unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int64_t tile = unit / chunks;
    const uint32_t word_lo = uint32_t(unit - tile * chunks) * chunk_words;
    const int64_t row0 = tile * tile_rows;
    const int n_rows = int(rows - row0 < tile_rows ? rows - row0 : tile_rows);
    sweep<kPer, true>(codes, image, chk, row0, n_rows, B, L, W, k, canonical,
                      log_row_words, word_lo, chunk_words, rb);
    // The atomics above went through the generic proxy; the copy engine
    // reads through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    uint32_t* dst = out + (row0 << log_row_words) + word_lo;
    const uint32_t bytes = uint32_t(n_rows) * chunk_words * 4u;
    if ((bytes & 15u) == 0u && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      if (threadIdx.x == 0) {
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
            :
            : "l"(dst),
              "r"(uint32_t(__cvta_generic_to_shared(image))), "r"(bytes)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // The image may change once the copy has read it.
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    } else {
      for (uint32_t i = threadIdx.x; i < bytes / 4u; i += kThreads) {
        dst[i] = image[i];
      }
    }
    __syncthreads();
    sweep<kPer, false>(codes, image, nullptr, row0, n_rows, B, L, W, k,
                       canonical, log_row_words, word_lo, chunk_words, rb);
    __syncthreads();
  }
  // The block's copies must have written before its shared memory goes.
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// The yardstick: out is zeroed; one thread a window.
template <int kPer>
__global__ void __launch_bounds__(kThreads)
    perread_scatter_kernel(const int8_t* __restrict__ codes,
                           uint32_t* __restrict__ out, int L, int W,
                           int64_t n_windows, int k, bool canonical,
                           int log_row_words) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x;
       g < n_windows; g += stride) {
    const int64_t r = g / W;
    const uint32_t key = cfrk::window_key<uint32_t>(
        codes + r * L, int(g - r * W), k, canonical, kSentinel);
    if (key == kSentinel) continue;
    uint32_t word;
    int shift;
    bin_place<kPer>(key, log_row_words, word, shift);
    atomicAdd(&out[(r << log_row_words) + word], 1u << shift);
  }
}

int log2_of(int per) { return per == 4 ? 2 : per == 2 ? 1 : 0; }

template <int kPer>
int launch(const int8_t* codes, uint32_t* out, int32_t* chk, int rows, int B,
           int L, int W, int k, bool canonical, int rb, cudaStream_t stream) {
  const int log_row_words = 2 * k - log2_of(kPer);
  const int row_words = 1 << log_row_words;
  const int chunk_words = row_words < kImageWords ? row_words : kImageWords;
  int tile_rows = kTileWords / row_words;
  if (tile_rows < 1) tile_rows = 1;
  if (tile_rows > kMaxTileRows) tile_rows = kMaxTileRows;
  const int chunks = row_words / chunk_words;
  const int64_t units = (int64_t(rows) + tile_rows - 1) / tile_rows * chunks;
  const size_t smem = size_t(tile_rows) * chunk_words * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      perread_hist_kernel<kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, perread_hist_kernel<kPer>, kThreads, smem);
  }
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorLaunchOutOfResources);
  int64_t grid = int64_t(per_sm) * sms;
  if (grid > units) grid = units;
  perread_hist_kernel<kPer><<<unsigned(grid), kThreads, smem, stream>>>(
      codes, out, chk, rows, B, L, W, k, canonical, rb, log_row_words,
      tile_rows, chunk_words, units);
  return int(cudaGetLastError());
}

template <int kPer>
int launch_scatter(const int8_t* codes, uint32_t* out, int B, int L, int W,
                   int k, bool canonical, cudaStream_t stream) {
  const int64_t n_windows = int64_t(B) * W;
  int64_t grid = (n_windows + kThreads - 1) / kThreads;
  if (grid > 8192) grid = 8192;  // the rest by the grid-stride loop
  perread_scatter_kernel<kPer><<<unsigned(grid), kThreads, 0, stream>>>(
      codes, out, L, W, n_windows, k, canonical, 2 * k - log2_of(kPer));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes [B, L] int8 → out (layout by `packed`: 0 unpacked [B, 4**k],
// 1 "fh" [rows, fh/2, fl], 2 "b4" [rows, fh/4, fl]; rows = B unpacked,
// B_pad packed) and, when chk is not null, chk[B_pad / rb] += the
// per-read-block sum of (count & 3).  W = L-k+1, 1 <= k <= 8, kl =
// floor(k/2) (the layouts' split; the word arithmetic does not need it).
int cfrk_perread_hist(const void* codes, void* out, void* chk, int rows,
                      int B, int L, int W, int k, int kl, int canonical,
                      int packed, int rb, void* stream) {
  (void)kl;
  if (rows <= 0) return int(cudaSuccess);
  const auto* c = static_cast<const int8_t*>(codes);
  auto* o = static_cast<uint32_t*>(out);
  auto* s = static_cast<int32_t*>(chk);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (packed) {
    case 0:
      return launch<1>(c, o, s, rows, B, L, W, k, canonical != 0, rb, st);
    case 1:
      return launch<2>(c, o, s, rows, B, L, W, k, canonical != 0, rb, st);
    case 2:
      return launch<4>(c, o, s, rows, B, L, W, k, canonical != 0, rb, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// The yardstick of the design above: the same counts added into an `out`
// that the caller has zeroed, rows past B included.  No checksum.
int cfrk_perread_hist_scatter(const void* codes, void* out, int B, int L,
                              int W, int k, int canonical, int packed,
                              void* stream) {
  if (B <= 0 || W <= 0) return int(cudaSuccess);
  const auto* c = static_cast<const int8_t*>(codes);
  auto* o = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (packed) {
    case 0:
      return launch_scatter<1>(c, o, B, L, W, k, canonical != 0, st);
    case 1:
      return launch_scatter<2>(c, o, B, L, W, k, canonical != 0, st);
    case 2:
      return launch_scatter<4>(c, o, B, L, W, k, canonical != 0, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
