// Global k-mer spectrum: one histogram over every window of a batch.
//
// Replaces the Pallas TPU kernel spectrum_pallas
// (cfrk_tpu/ops/pallas/spectrum.py:62, body _spectrum_kernel :26).  It
// computes what that kernel computes: codes [B, L] int8 → a [4**k]
// int32 table of the counts of every valid window, forward or canonical
// (min with the reverse complement), 1 <= k <= 10.  A window is counted
// iff none of its codes is < 0; windows never cross reads.  The kernel
// ADDS into the table it is given (the wrapper passes a zeroed table or
// the running one), so a batch never needs a table of its own.
//
// The TPU kernel flattens the batch into a few long pseudo-reads with -1
// separators and contracts one-hot hi/lo tiles on the MXU into a
// resident accumulator: that is Mosaic layout, not the algorithm.  On
// Hopper this is a histogram.
//
// Design: one thread per window, grid-stride over the B*W windows
// (read r = g / W, position p = g % W); each thread builds its key with
// cfrk::window_key (kmer_key.cuh), so no [B, W] index array crosses
// device memory.
//  * k <= 8: a privatised int32 sub-histogram in shared memory.  The
//    table is cut into slabs of at most kSlabBins = 16384 bins (64 KB);
//    blockIdx.y picks the slab, so k <= 7 is one slab and k = 8 (256 KB
//    of int32, more than the 227 KB a block may hold) is four.  A block
//    counts the windows whose key falls in its slab with shared-memory
//    atomics, then adds each nonzero bin to the global table with one
//    atomicAdd.
//  * k = 9, 10: one global atomicAdd per valid window; the 1-4 MB table
//    stays in the 50 MB L2.
//
// Bounds on the H100: the key loop reads k int8 codes per window, which
// neighbouring threads share through L1, so device-memory traffic is
// about one byte per window in and the table out.  The limit is the
// atomics: shared-memory atomics per window, and for k = 9, 10 L2
// atomics per window.  A batch whose windows share one key (poly-A)
// serialises every atomic on one bin: correct, and slow.  Each block of
// the slab kernel serves ~2 windows per bin of its slab or more, so its
// flush of up to kSlabBins global atomics stays below its window count.
//
// Counts are exact while every bin stays below 2**31; the caller
// (DenseSpectrumAccumulator) keeps each table below SPILL_LIMIT windows.
//
// The C entry point launches on the stream it is given, allocates
// nothing and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "kmer_key.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSlabBins = 16384;  // 64 KB of int32 bins per block
constexpr int kMaxSmemK = 8;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
    spectrum_smem_kernel(const int8_t* __restrict__ codes,
                         int32_t* __restrict__ table, int L, int W,
                         int64_t n_windows, int k, bool canonical,
                         int slab_bins) {
  extern __shared__ int32_t hist[];
  const uint32_t slab_lo = blockIdx.y * uint32_t(slab_bins);
  for (int i = threadIdx.x; i < slab_bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       g < n_windows; g += stride) {
    const int64_t r = g / W;
    const int p = int(g - r * W);
    const uint32_t key =
        cfrk::window_key<uint32_t>(codes + r * L, p, k, canonical, kSentinel);
    const uint32_t bin = key - slab_lo;  // the sentinel lands far outside
    if (bin < uint32_t(slab_bins)) atomicAdd(&hist[bin], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < slab_bins; i += blockDim.x) {
    const int32_t c = hist[i];
    if (c) atomicAdd(&table[slab_lo + i], c);
  }
}

__global__ void __launch_bounds__(kThreads)
    spectrum_global_kernel(const int8_t* __restrict__ codes,
                           int32_t* __restrict__ table, int L, int W,
                           int64_t n_windows, int k, bool canonical) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       g < n_windows; g += stride) {
    const int64_t r = g / W;
    const int p = int(g - r * W);
    const uint32_t key =
        cfrk::window_key<uint32_t>(codes + r * L, p, k, canonical, kSentinel);
    if (key != kSentinel) atomicAdd(&table[key], 1);
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// codes [B, L] int8 → table [4**k] int32 += the counts of every valid
// window (W = L-k+1 windows per read, 1 <= k <= 10).
int cfrk_spectrum_hist(const void* codes, void* table, int B, int L, int W,
                       int k, int canonical, void* stream) {
  const int64_t n_windows = int64_t(B) * W;
  if (n_windows <= 0) return int(cudaSuccess);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return int(err);
  const auto* c = static_cast<const int8_t*>(codes);
  auto* t = static_cast<int32_t*>(table);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t by_threads = ceil_div(n_windows, kThreads);
  if (k <= kMaxSmemK) {
    const int bins = 1 << (2 * k);
    const int slab = bins < kSlabBins ? bins : kSlabBins;
    const size_t smem = size_t(slab) * sizeof(int32_t);
    err = cudaFuncSetAttribute(spectrum_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    // At least ~2 windows per bin of the slab in each block, at most two
    // blocks per SM per slab, never more blocks than windows / threads.
    int64_t gx = ceil_div(n_windows, 2 * int64_t(slab));
    if (gx > 2 * int64_t(sms)) gx = 2 * int64_t(sms);
    if (gx > by_threads) gx = by_threads;
    if (gx < 1) gx = 1;
    const dim3 grid(unsigned(gx), unsigned(bins / slab));
    spectrum_smem_kernel<<<grid, kThreads, smem, s>>>(
        c, t, L, W, n_windows, k, canonical != 0, slab);
  } else {
    int64_t gx = by_threads < 8 * int64_t(sms) ? by_threads : 8 * int64_t(sms);
    spectrum_global_kernel<<<unsigned(gx), kThreads, 0, s>>>(
        c, t, L, W, n_windows, k, canonical != 0);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
