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
// 1.07 GB "fh" and 0.54 GB "b4", against 37 KB of windows.
//
// Design: one block per (read, slab of the lo axis).  A slab holds all
// fh hi bins times slab_lo lo bins, at most kSlabBins = 16384 int32
// (64 KB) of shared memory, so k <= 7 is one slab and k = 8 (256 KB of
// int32, above the 227 KB a block may hold) is four.  Cutting the lo
// axis keeps bins h, h + fh/2 (and h + q, ...) in one block, so the
// packed words are formed at emit.  The block zeroes its slab, builds
// each window's key with cfrk::window_key (kmer_key.cuh) and counts the
// keys that fall in its slab with shared-memory atomics, then writes
// every cell of its slab exactly once, zeros included: no pre-zeroing
// pass over the output.  Consecutive threads write consecutive lo cells,
// so a warp stores 128 contiguous bytes when slab_lo >= 32 and the whole
// row is one contiguous run when it is one slab.
//
// Bounds on the H100: the output write (about 0.64 ms for 2.15 GB at the
// published 3.35 TB/s, 0.16 ms for the "b4" layout) and, beside it,
// twice as many shared-memory accesses (zero, then read at emit).  Each
// slab block rebuilds the read's keys, a few hundred int8 loads per
// 150 bp read through L1.  Counts are exact in int32 for any row length.
//
// The C entry point launches on the stream it is given, allocates
// nothing and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_sum.cuh"
#include "kmer_key.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSlabBins = 16384;  // 64 KB of int32 counts per block
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// Bins per output word: unpacked, "fh", "b4".
template <int kPer>
__global__ void __launch_bounds__(kMaxThreads)
    perread_hist_kernel(const int8_t* __restrict__ codes,
                        int32_t* __restrict__ out, int32_t* __restrict__ chk,
                        int B, int L, int W, int k, int kl, bool canonical,
                        int slab_lo, int rb) {
  extern __shared__ int32_t hist[];
  const int row = blockIdx.x;
  const int fl = 1 << (2 * kl);
  const int fh = 1 << (2 * (k - kl));
  const int lo0 = blockIdx.y * slab_lo;
  const int bins = fh * slab_lo;  // hist[h * slab_lo + (lo - lo0)]
  for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  if (row < B) {  // rows past B are the packed layout's zero pad rows
    const int8_t* r = codes + int64_t(row) * L;
    for (int p = threadIdx.x; p < W; p += blockDim.x) {
      const uint32_t key =
          cfrk::window_key<uint32_t>(r, p, k, canonical, kSentinel);
      if (key == kSentinel) continue;
      const uint32_t lo = (key & uint32_t(fl - 1)) - uint32_t(lo0);
      if (lo < uint32_t(slab_lo)) {
        atomicAdd(&hist[(key >> (2 * kl)) * uint32_t(slab_lo) + lo], 1);
      }
    }
  }
  __syncthreads();

  const int part = fh / kPer;  // hi bins per word group
  const int words = part * slab_lo;
  int32_t* dst = out + int64_t(row) * part * fl + lo0;
  int32_t sum = 0;
  for (int e = threadIdx.x; e < words; e += blockDim.x) {
    const int h = e / slab_lo;
    const int j = e - h * slab_lo;
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int32_t c = hist[(h + q * part) * slab_lo + j];
      sum += c & 3;
      if constexpr (kPer == 1) {
        word = uint32_t(c);
      } else {
        word = (word << (32 / kPer)) | uint32_t(c);
      }
    }
    dst[int64_t(h) * fl + j] = int32_t(word);
  }
  if (chk != nullptr) {  // the same for every thread of the block
    sum = cfrk::block_sum(sum);
    if (threadIdx.x == 0 && sum != 0) atomicAdd(&chk[row / rb], sum);
  }
}

template <int kPer>
int launch(const int8_t* codes, int32_t* out, int32_t* chk, int rows, int B,
           int L, int W, int k, int kl, bool canonical, int rb,
           cudaStream_t stream) {
  const int fh = 1 << (2 * (k - kl));
  const int fl = 1 << (2 * kl);
  const int slab_lo = fh * fl <= kSlabBins ? fl : kSlabBins / fh;
  const int bins = fh * slab_lo;
  int threads = (bins + 31) / 32 * 32;
  if (threads < 128) threads = 128;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = size_t(bins) * sizeof(int32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      perread_hist_kernel<kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(rows), unsigned(fl / slab_lo));
  perread_hist_kernel<kPer><<<grid, threads, smem, stream>>>(
      codes, out, chk, B, L, W, k, kl, canonical, slab_lo, rb);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes [B, L] int8 → out (layout by `packed`: 0 unpacked [B, 4**k],
// 1 "fh" [rows, fh/2, fl], 2 "b4" [rows, fh/4, fl]; rows = B unpacked,
// B_pad packed) and, when chk is not null, chk[B_pad / rb] += the
// per-read-block sum of (count & 3).  W = L-k+1, 1 <= k <= 8, kl =
// floor(k/2).
int cfrk_perread_hist(const void* codes, void* out, void* chk, int rows,
                      int B, int L, int W, int k, int kl, int canonical,
                      int packed, int rb, void* stream) {
  if (rows <= 0) return int(cudaSuccess);
  const auto* c = static_cast<const int8_t*>(codes);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<int32_t*>(chk);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (packed) {
    case 0:
      return launch<1>(c, o, s, rows, B, L, W, k, kl, canonical != 0, rb, st);
    case 1:
      return launch<2>(c, o, s, rows, B, L, W, k, kl, canonical != 0, rb, st);
    case 2:
      return launch<4>(c, o, s, rows, B, L, W, k, kl, canonical != 0, rb, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
