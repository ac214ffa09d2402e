// Per-pair arithmetic of the GossipNet pair stage, shared by K1
// (pairwise2_fwd.cu) and K2 (pairwise2_bwd.cu).
//
// K2 finds the max winners of K1 by exact float equality (pre2 == m), so
// both kernels must compute every pair's IoU, features, h1 and pre2 with
// the same operations in the same order and the same rounding points.
// Keeping that code here, once, is what makes the equality hold: a change
// to it changes both kernels together (and the library hash of both, see
// ops/cuda/build.py).
//
// Numerics: the IoU and the neighbour predicate use explicitly rounded
// operations (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so no FMA
// contraction can move a pair across the threshold; the two products are
// explicit fmaf chains in a fixed order. BF16 mode rounds what the TPU
// kernel feeds its bf16 dots (features g, b', Wg_k, h1, W2) and
// accumulates in f32; a' and b2 stay f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace gnet {

constexpr int TILE_I = 32;  // rows per block: one per lane
constexpr int TILE_J = 64;  // columns staged per step
constexpr int NWARPS = 4;   // warps sharing one column tile
constexpr int NTHREADS = 32 * NWARPS;
constexpr int KMAX = 4;     // pair features kept in the kernel
constexpr int CMAX = 9;     // fields per detection column (8, +1 class)
constexpr float EPS = 1e-6f;

// Row fields: x1 y1 x2 y2 area inv_w inv_h valid [cls]
// Col fields: x1 y1 x2 y2 area cx   cy    valid [cls]

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// IoU of row detection `ri` and staged column j (cs is [CMAX][TILE_J]).
__device__ __forceinline__ float pair_iou(const float (&ri)[CMAX],
                                          const float* cs, int j) {
  const float iw = fmaxf(__fsub_rn(fminf(ri[2], cs[2 * TILE_J + j]),
                                   fmaxf(ri[0], cs[0 * TILE_J + j])), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(ri[3], cs[3 * TILE_J + j]),
                                   fmaxf(ri[1], cs[1 * TILE_J + j])), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ri[4], cs[4 * TILE_J + j]), inter);
  return __fdiv_rn(inter, fmaxf(uni, EPS));
}

// The in-kernel pair features g = [iou, cx_j * inv_w_i, cy_j * inv_h_i,
// cls_i == cls_j], rounded to bf16 in BF16 mode (the class match is 0/1).
template <bool BF16>
__device__ __forceinline__ void pair_features(const float (&ri)[CMAX],
                                              const float* cs, int j, int K,
                                              float iou, float (&g)[KMAX]) {
  g[0] = iou;
  g[1] = __fmul_rn(cs[5 * TILE_J + j], ri[5]);
  g[2] = __fmul_rn(cs[6 * TILE_J + j], ri[6]);
  g[3] = (K == 4 && ri[8] == cs[8 * TILE_J + j]) ? 1.f : 0.f;
  if (BF16) {
    g[0] = round_bf16(g[0]);
    g[1] = round_bf16(g[1]);
    g[2] = round_bf16(g[2]);
  }
}

// h1_p = relu(a'_p + b'_p + Wg_k[:, p] . g), rounded to bf16 in BF16 mode.
// wgs is [KMAX][P] with zero rows beyond K; bj is the staged b'_j row.
template <int P, bool BF16>
__device__ __forceinline__ float pair_h1(float a_p, const float* bj,
                                         const float* wgs,
                                         const float (&g)[KMAX], int p) {
  float h = bj[p];
  h = fmaf(wgs[0 * P + p], g[0], h);
  h = fmaf(wgs[1 * P + p], g[1], h);
  h = fmaf(wgs[2 * P + p], g[2], h);
  h = fmaf(wgs[3 * P + p], g[3], h);  // row 3 is zero when K == 3
  h = fmaxf(a_p + h, 0.f);
  if (BF16) h = round_bf16(h);
  return h;
}

// pre2 += h1_p * W2[p, :] (w2s is [P][P], (in, out), 16-byte aligned).
template <int P>
__device__ __forceinline__ void fc2_accumulate(float h, const float* w2s,
                                               int p, float (&pre)[P]) {
  const float4* w2row = reinterpret_cast<const float4*>(w2s + p * P);
#pragma unroll
  for (int q4 = 0; q4 < P / 4; ++q4) {
    const float4 w = w2row[q4];
    pre[4 * q4 + 0] = fmaf(h, w.x, pre[4 * q4 + 0]);
    pre[4 * q4 + 1] = fmaf(h, w.y, pre[4 * q4 + 1]);
    pre[4 * q4 + 2] = fmaf(h, w.z, pre[4 * q4 + 2]);
    pre[4 * q4 + 3] = fmaf(h, w.w, pre[4 * q4 + 3]);
  }
}

// pre2 = W2^T h1 + b2 for one pair, h1 computed on the fly (K1's order:
// p ascending, each h1_p consumed as soon as it is made). `as_col` points
// at a'[p = 0] of this lane's row in the [P][TILE_I + 1] tile; h1_out, when
// given, receives every h1_p (K2 needs them).
template <int P, bool BF16, bool KEEP_H1>
__device__ __forceinline__ void pair_pre2(const float* as_col,
                                          const float* bj, const float* wgs,
                                          const float* w2s, const float* b2s,
                                          const float (&g)[KMAX],
                                          float (&pre)[P], float (&h1)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) pre[q] = b2s[q];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float h =
        pair_h1<P, BF16>(as_col[p * (TILE_I + 1)], bj, wgs, g, p);
    if (KEEP_H1) h1[p] = h;
    fc2_accumulate<P>(h, w2s, p, pre);
  }
}

}  // namespace gnet
