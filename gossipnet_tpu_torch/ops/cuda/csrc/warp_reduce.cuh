// Deterministic warp reductions of the unfolded pair-pool backward, K6
// (pairwise_bwd.cu).

#pragma once

#include <cuda_runtime.h>

namespace gnet {

constexpr unsigned FULL = 0xffffffffu;

// Reduce-scatter of v[P] over the 32 lanes of a warp, recursive halving
// (S = 16, 8, ..., 1): afterwards lane l holds, in v[0 .. rs_count<P>()),
// the warp sums of p = rs_index<P>(l, r). For P < 32 a sum sits on 32/P
// lanes and rs_writer picks one. Fixed order: the result is the same on
// every launch.
template <int P, int N, int S>
__device__ __forceinline__ void reduce_scatter(float (&v)[P], int lane) {
  if constexpr (N >= 2) {
    constexpr int H = N / 2;
    const bool upper = (lane & S) != 0;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float send = upper ? v[k] : v[k + H];
      const float keep = upper ? v[k + H] : v[k];
      v[k] = keep + __shfl_xor_sync(FULL, send, S);
    }
  } else {
    v[0] += __shfl_xor_sync(FULL, v[0], S);
  }
  if constexpr (S > 1) reduce_scatter<P, (N >= 2 ? N / 2 : 1), S / 2>(v, lane);
}

template <int P>
__host__ __device__ constexpr int rs_count() { return P >= 32 ? P / 32 : 1; }

template <int P>
__device__ __forceinline__ int rs_index(int lane, int r) {
  if constexpr (P >= 32) return lane * (P / 32) + r;
  else return lane / (32 / P);
}

template <int P>
__device__ __forceinline__ bool rs_writer(int lane) {
  if constexpr (P >= 32) return true;
  else return lane % (32 / P) == 0;
}

}  // namespace gnet
