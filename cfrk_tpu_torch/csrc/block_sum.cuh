// Sum of one value per thread over a thread block, shared by the
// checksums of csrc/.
//
// Warp shuffles, then one shared-memory slot per warp.  Every thread of
// the block must call it (it synchronises the block), blockDim.x must be
// a multiple of 32, and a kernel calls it at most once.  The total is
// returned to thread 0; other threads get partial sums.

#pragma once

namespace cfrk {

template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < int(blockDim.x >> 5) ? warp_sums[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

}  // namespace cfrk
