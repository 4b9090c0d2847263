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
// What bounds it on the H100.  The bytes are small: B*L codes in and the
// table out, 2.4 MB and 0.7 us for [8192, 256] at k = 8.  The limit is
// the atomics, one per counted window when every window has a key of its
// own (random reads), and the instructions that build the keys.  So the
// design builds each key once at a cost that does not grow with k, and
// merges equal keys before the atomic wherever that costs nothing.
//
// Design.
//
// 1. The batch is one flat run of B*L codes cut into 16-code units at
//    16-byte-aligned addresses; a block step takes one unit a thread.  A
//    thread loads its unit with one 16-byte load and packs it to 2 bits a
//    base plus one invalid bit a base (cfrk::pack_unit); units go through
//    shared memory so that a thread sees the unit after its own.  Codes
//    before the batch's first byte or past its last pack as invalid, so
//    no load leaves [0, B*L) and a batch may start off a 16-byte
//    boundary.
// 2. A thread walks the 16 consecutive windows that start in its unit:
//    each key is a funnel shift out of two units
//    (cfrk::packed_window_key), valid iff none of its codes is invalid
//    and its position in the read is below W, which is what keeps a
//    window from crossing into the next read.
// 3. Merging.  The thread keeps the last two distinct keys it met, each
//    with a run count, across all its block steps, and sends an atomic
//    only when a third key evicts one.  A homopolymer or a dinucleotide
//    repeat (two alternating keys, or one canonical key) then costs no
//    atomic while it lasts; one atomic a window would serialise the
//    whole batch on one or two bins.  At the end of the block the two held pairs of the
//    warp's lanes are grouped by key (__match_any_sync) and one lane
//    adds each group's total.  On random reads every window still costs
//    its own atomic: there is nothing to merge.
// 4. The table's home.  k <= kMaxSharedK = 7: a private int32 table in
//    the block's shared memory (at most 64 KB), persistent blocks two an
//    SM, each flushed once with one global atomic per nonzero bin.  At
//    k <= 6 a block meets each bin many times.  At k = 7 it meets about
//    as many windows as it has bins and merges little on random reads,
//    but its flush walks the table in address order, which the L2 takes
//    faster than the same number of scattered atomics on 16384 bins,
//    and a batch whose windows share a few hundred keys does not pile
//    on a few L2 addresses.  Above (k = 8 is 256 KB of int32, more than a
//    block may hold): the global table itself, resident in the 50 MB L2.
//    PERF.md has each choice beside the other, measured.
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

// Threads of a block with a private table and of one without: measured
// (tools/hist_sweep.py), 512 serve the first best and 256 the second.
constexpr int kSharedThreads = 512;
constexpr int kGlobalThreads = 256;
constexpr int kRun = cfrk::kUnitBases;  // windows a thread walks per step
constexpr int kMaxSharedK = 7;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// The unit of 16 codes at flat offset g of the batch (g is a multiple of
// 16 away from a 16-byte-aligned address), packed.  Codes outside
// [0, total) count as invalid and are not read.
__device__ __forceinline__ void load_unit(const int8_t* __restrict__ codes,
                                          int64_t total, int64_t g,
                                          uint32_t& bases, uint32_t& invalid) {
  union {
    int4 v;
    int8_t c[kRun];
  } raw;
  if (g >= 0 && g + kRun <= total) {
    raw.v = *reinterpret_cast<const int4*>(codes + g);
  } else {
#pragma unroll
    for (int b = 0; b < kRun; ++b) {
      raw.c[b] = (g + b >= 0 && g + b < total) ? codes[g + b] : int8_t(-1);
    }
  }
  cfrk::pack_unit(raw.c, kRun, bases, invalid);
}

// The two (key, run) pairs a thread holds back from the table.
struct Held {
  uint32_t key0 = kSentinel, key1 = kSentinel;
  int32_t run0 = 0, run1 = 0;

  // Count one valid window: a held key takes it; any other key evicts
  // pair 1 to the table, moves pair 0 there and starts a run of its own.
  __device__ __forceinline__ void add(uint32_t key, int32_t* bins) {
    if (key == key0) {
      ++run0;
    } else if (key == key1) {
      ++run1;
    } else {
      if (run1) atomicAdd(&bins[key1], run1);
      key1 = key0;
      run1 = run0;
      key0 = key;
      run0 = 1;
    }
  }
};

// One held pair of every lane of the warp to the table: lanes that hold
// the same key form a group, and the group's lowest lane adds its total.
// Every lane of the warp must call it.
__device__ __forceinline__ void flush_warp(uint32_t key, int32_t run,
                                           int32_t* bins) {
  const unsigned group = __match_any_sync(kFullWarp, key);
  const int32_t total = __reduce_add_sync(group, run);
  const int lane = threadIdx.x & 31;
  if (lane == __ffs(group) - 1 && total) atomicAdd(&bins[key], total);
}

// `skew` is the distance of the batch's first byte from the 16-byte
// boundary below it: unit u of step s covers the flat offsets
// [16 * (s * kThreads + u) - skew, + 16).
template <bool kShared>
__global__ void __launch_bounds__(kShared ? kSharedThreads : kGlobalThreads)
    spectrum_kernel(const int8_t* __restrict__ codes,
                    int32_t* __restrict__ table, int64_t total, int L, int W,
                    int k, bool canonical, int skew, int64_t steps) {
  constexpr int kThreads = kShared ? kSharedThreads : kGlobalThreads;
  constexpr int kStepCodes = kThreads * kRun;
  extern __shared__ int32_t hist[];  // kShared: the block's 4**k bins
  __shared__ uint32_t units[kThreads + 1];
  __shared__ uint32_t invalid[kThreads + 1];
  const int t = threadIdx.x;
  int32_t* bins = kShared ? hist : table;
  if constexpr (kShared) {
    for (int i = t; i < (1 << (2 * k)); i += kThreads) hist[i] = 0;
  }
  Held held;
  for (int64_t s = blockIdx.x; s < steps; s += gridDim.x) {
    const int64_t base = s * kStepCodes - skew;
    // One unit a thread, and thread 0 the unit after the last.
    for (int u = t; u <= kThreads; u += kThreads) {
      load_unit(codes, total, base + int64_t(kRun) * u, units[u], invalid[u]);
    }
    __syncthreads();  // also orders the zeroing of hist before its use
    const uint32_t u0 = units[t];
    const uint32_t u1 = units[t + 1];
    const uint32_t bad = invalid[t] | (invalid[t + 1] << kRun);
    __syncthreads();  // units are free for the next step
    if ((bad & 0xFFFFu) == 0xFFFFu) continue;  // no window starts here
    // Position in its read of the thread's first window (where the
    // offset is negative the codes are invalid; p must be 0 at offset 0).
    const int64_t g0 = base + int64_t(kRun) * t;
    int p = int(g0 % L);
    if (p < 0) p += L;
#pragma unroll
    for (int e = 0; e < kRun; ++e) {
      if (p < W) {
        const uint32_t key = cfrk::packed_window_key<uint32_t>(
            u0, u1, 0u, bad >> e, e, k, canonical, kSentinel);
        if (key != kSentinel) held.add(key, bins);
      }
      if (++p == L) p = 0;
    }
  }
  flush_warp(held.key0, held.run0, bins);
  flush_warp(held.key1, held.run1, bins);
  if constexpr (kShared) {
    __syncthreads();
    for (int i = t; i < (1 << (2 * k)); i += kThreads) {
      const int32_t c = hist[i];
      if (c) atomicAdd(&table[i], c);
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// codes [B, L] int8 → table [4**k] int32 += the counts of every valid
// window (W = L-k+1 windows per read, 1 <= k <= 10).
int cfrk_spectrum_hist(const void* codes, void* table, int B, int L, int W,
                       int k, int canonical, void* stream) {
  const int64_t total = int64_t(B) * L;
  if (total <= 0 || W <= 0) return int(cudaSuccess);
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
  const int skew = int(reinterpret_cast<uintptr_t>(c) & 15);
  if (k <= kMaxSharedK) {
    const int64_t steps = ceil_div(total + skew, kSharedThreads * kRun);
    // Persistent blocks, two an SM: each flushes its table once, and the
    // flush of consecutive bins by consecutive threads is cheap beside
    // an SM left idle.
    const int64_t bins = int64_t(1) << (2 * k);
    int64_t grid = 2 * int64_t(sms);
    if (grid > steps) grid = steps;
    const size_t smem = size_t(bins) * sizeof(int32_t);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(spectrum_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(smem));
      if (err != cudaSuccess) return int(err);
    }
    spectrum_kernel<true><<<unsigned(grid), kSharedThreads, smem, s>>>(
        c, t, total, L, W, k, canonical != 0, skew, steps);
  } else {
    const int64_t steps = ceil_div(total + skew, kGlobalThreads * kRun);
    const int64_t grid = steps < 8 * int64_t(sms) ? steps : 8 * int64_t(sms);
    spectrum_kernel<false><<<unsigned(grid), kGlobalThreads, 0, s>>>(
        c, t, total, L, W, k, canonical != 0, skew, steps);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
