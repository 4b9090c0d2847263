// Window keys of an int8 code batch, shared by the kernels of csrc/.
//
// Codes are 0..3 for A, C, G, T and -1 for N or padding.  The key of the
// k-window at position p of a read is base-4 with the first base most
// significant; canonical keys are min(forward, reverse complement).  A
// window is valid iff all k of its codes are >= 0: padding with -1
// makes validity local, so no kernel needs a separate length mask and
// no window crosses from one read into the next.
//
// Two helpers, for two kinds of kernel:
//
//   window_key         spectrum.cu (spectrum_hist) and perread.cu
//                      (perread_hist): a k-step loop over codes in
//                      device memory, one window per call.
//   pack_unit +        rowsort.cu (rowsort_rle, rowsort_rle_large and
//   packed_window_key  the probe variants): a row is packed once into
//                      16-base units, and a window's key is then a
//                      funnel shift out of two or three units, at a
//                      cost that does not grow with k.
//                      ops/cuda/rowsort.py keeps a numpy model of these
//                      two functions, line for line, which the CPU
//                      tests hold against the plain key functions.

#pragma once

#include <cstdint>

namespace cfrk {

// Key of the window row[p .. p+k), or `sentinel` when any of its codes
// is < 0.  A k-step loop over the codes: each thread builds its own
// window's key, so no [B, W] key array crosses device memory.
template <typename Key>
__device__ __forceinline__ Key window_key(const int8_t* __restrict__ row,
                                          int p, int k, bool canonical,
                                          Key sentinel) {
  Key fwd = 0;
  Key rc = 0;
  for (int j = 0; j < k; ++j) {
    const int c = row[p + j];
    if (c < 0) return sentinel;
    fwd = (fwd << 2) | Key(c);
    rc |= Key(3 - c) << (2 * j);  // base j of the window is rc's base k-1-j
  }
  return (canonical && rc < fwd) ? rc : fwd;
}

// ---- packed rows ----------------------------------------------------

constexpr int kUnitBases = 16;  // bases in one packed 32-bit unit

// Pack the 16 codes c[0 .. 16) of one unit, of which only the first
// `avail` exist (the rest lie past the row's end and count as invalid):
// `bases` holds 2 bits a base, base 0 in the two most significant bits
// (an invalid base packs as 0); bit b of `invalid` is set iff code b is
// < 0.  Reads c[b] only for b < avail.
__device__ __forceinline__ void pack_unit(const int8_t* c, int avail,
                                          uint32_t& bases,
                                          uint32_t& invalid) {
  bases = 0;
  invalid = 0;
#pragma unroll
  for (int b = 0; b < kUnitBases; ++b) {
    const int code = b < avail ? int(c[b]) : -1;
    bases = (bases << 2) | (code < 0 ? 0u : uint32_t(code) & 3u);
    invalid |= uint32_t(code < 0) << b;
  }
}

// Swap the two bits of every 2-bit group.
__device__ __forceinline__ uint32_t swap_pairs(uint32_t x) {
  return ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
}
__device__ __forceinline__ uint64_t swap_pairs(uint64_t x) {
  return ((x & 0x5555555555555555ull) << 1) |
         ((x >> 1) & 0x5555555555555555ull);
}

// Key of the k-window that starts at base `o` (0..15) of unit u0; u1
// and u2 are the units that follow (u2 is read for 64-bit keys only: a
// window of up to 31 bases at offset up to 15 spans three units).
// `invalid_from_p` holds the row's invalid bits from the window's first
// base on, bit 0 first.  Key is uint32_t for k <= 15, uint64_t for
// k <= 31.
//
// The window is shifted to the top of the word (x); the forward key is
// x >> (bits - 2k).  The reverse complement is the complement of the
// 2-bit-group reversal: ~x bit-reversed puts the window's last base in
// the lowest group with the bits of each group swapped, so one pair
// swap and a mask to 2k bits finish it.
template <typename Key>
__device__ __forceinline__ Key packed_window_key(uint32_t u0, uint32_t u1,
                                                 uint32_t u2,
                                                 uint32_t invalid_from_p,
                                                 int o, int k,
                                                 bool canonical,
                                                 Key sentinel) {
  if (invalid_from_p & ((1u << k) - 1u)) return sentinel;
  constexpr int kBits = 8 * int(sizeof(Key));
  Key x;
  Key reversed;
  if constexpr (sizeof(Key) == 4) {
    x = __funnelshift_l(u1, u0, 2 * o);
    reversed = __brev(~x);
  } else {
    x = (Key(__funnelshift_l(u1, u0, 2 * o)) << 32) |
        Key(__funnelshift_l(u2, u1, 2 * o));
    reversed = Key(__brevll(~x));
  }
  const Key fwd = x >> (kBits - 2 * k);
  if (!canonical) return fwd;
  const Key rc = swap_pairs(reversed) & ((Key(1) << (2 * k)) - 1);
  return rc < fwd ? rc : fwd;
}

}  // namespace cfrk
