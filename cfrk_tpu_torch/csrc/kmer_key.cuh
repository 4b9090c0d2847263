// Window keys of an int8 code batch, shared by the kernels of csrc/.
//
// Codes are 0..3 for A, C, G, T and -1 for N or padding.  The key of the
// k-window at position p of a read is base-4 with the first base most
// significant; canonical keys are min(forward, reverse complement).  A
// window is valid iff all k of its codes are >= 0: padding with -1
// makes validity local, so no kernel needs a separate length mask and
// no window crosses from one read into the next.

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

}  // namespace cfrk
