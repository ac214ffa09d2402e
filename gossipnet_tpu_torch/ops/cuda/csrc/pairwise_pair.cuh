// Per-pair arithmetic of the unfolded GossipNet pair stage, shared by K5
// (pairwise_fwd.cu) and K6 (pairwise_bwd.cu).
//
// K6 finds the max winners of K5 by exact float equality (pre2 == m), so
// both kernels compute every pair's IoU, features, h1 and pre2 here, once,
// with the same operations in the same order and the same rounding
// points.
//
// Unlike K1 (pairwise2_pair.cuh), nothing is folded: a = r Wa + b1 and
// b = r Wb arrive as they are, and all 8 pair features of
// ops/pair_features.py (9 with the class match) are computed per pair, in
// its order: iou, (cx_j - cx_i) / w_i, (cy_j - cy_i) / h_i, the
// differences of log_w, log_h and log_aspect, s_i, s_j [, cls_i == cls_j].
// The IoU, the feature subtractions and divisions are explicitly rounded
// IEEE operations (__fsub_rn, __fdiv_rn, ...), so no FMA contraction moves
// a pair across the threshold or a feature off the plain version's bits.
//
// BF16 mode rounds what gossipnet_tpu/ops/pallas/pairwise.py feeds its bf16
// dots (:194-213): the features g, Wg, h1 and W2. a, b and b2 stay f32, as
// the TPU adds them in f32 -- unlike K1, whose b' rides the bf16 dot. So
// bf16 K5 and bf16 K1 differ; they compute the same function in f32.

#pragma once

#include "pairwise2_pair.cuh"  // TILE_I, TILE_J, NWARPS, round_bf16, fc2_accumulate

namespace gnet::unfolded {

constexpr int GMAX = 9;   // pair features: 8, +1 class match
constexpr int FMAX = 15;  // detection fields: the 14 DetColumns, +1 class

// Field order of the stacked DetColumns (ops/pair_features.py).
enum Field {
  X1, Y1, X2, Y2, CX, CY, W, H, LOG_W, LOG_H, LOG_ASPECT, AREA, SCORE, VALID,
  CLS
};

// What det_columns gives a zero box (w, h clamped to 1e-3, invalid): the
// pad of a ragged tile edge, as gossipnet_tpu's _safe_pad_cols pads, so no
// w = 0 ever reaches a division.
__device__ __forceinline__ float safe_pad(int f) {
  switch (f) {
    case CX: case CY: return 5e-4f;
    case W: case H: return 1e-3f;
    case LOG_W: case LOG_H: return -6.9077554f;
    case AREA: return 1e-6f;
    default: return 0.f;
  }
}

// Row fields are staged as rs[FMAX][TILE_I], column fields as
// cs[FMAX][TILE_J]; i and j index the tiles.
__device__ __forceinline__ float row(const float* rs, int f, int i) {
  return rs[f * TILE_I + i];
}
__device__ __forceinline__ float col(const float* cs, int f, int j) {
  return cs[f * TILE_J + j];
}

__device__ __forceinline__ float pair_iou(const float* rs, int i,
                                          const float* cs, int j) {
  const float iw = fmaxf(__fsub_rn(fminf(row(rs, X2, i), col(cs, X2, j)),
                                   fmaxf(row(rs, X1, i), col(cs, X1, j))),
                         0.f);
  const float ih = fmaxf(__fsub_rn(fminf(row(rs, Y2, i), col(cs, Y2, j)),
                                   fmaxf(row(rs, Y1, i), col(cs, Y1, j))),
                         0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni =
      __fsub_rn(__fadd_rn(row(rs, AREA, i), col(cs, AREA, j)), inter);
  return __fdiv_rn(inter, fmaxf(uni, EPS));
}

// The G pair features (G = 8, or 9 with the class match; g[8] = 0 when
// G = 8), rounded to bf16 in BF16 mode (the class match is 0/1).
template <bool BF16>
__device__ __forceinline__ void pair_features(const float* rs, int i,
                                              const float* cs, int j, int G,
                                              float iou, float (&g)[GMAX]) {
  g[0] = iou;
  g[1] = __fdiv_rn(__fsub_rn(col(cs, CX, j), row(rs, CX, i)), row(rs, W, i));
  g[2] = __fdiv_rn(__fsub_rn(col(cs, CY, j), row(rs, CY, i)), row(rs, H, i));
  g[3] = __fsub_rn(col(cs, LOG_W, j), row(rs, LOG_W, i));
  g[4] = __fsub_rn(col(cs, LOG_H, j), row(rs, LOG_H, i));
  g[5] = __fsub_rn(col(cs, LOG_ASPECT, j), row(rs, LOG_ASPECT, i));
  g[6] = row(rs, SCORE, i);
  g[7] = col(cs, SCORE, j);
  g[8] = (G == GMAX && row(rs, CLS, i) == col(cs, CLS, j)) ? 1.f : 0.f;
  if (BF16) {
#pragma unroll
    for (int k = 0; k < GMAX - 1; ++k) g[k] = round_bf16(g[k]);
  }
}

// h1_p = relu(a_p + (b_p + Wg[:, p] . g)), the dot an fmaf chain in
// feature order; rounded to bf16 in BF16 mode (the FC2 operand). wgs is
// [GMAX][P] with a zero row 8 when G = 8.
template <int P, bool BF16>
__device__ __forceinline__ float pair_h1(float a_p, float b_p,
                                         const float* wgs,
                                         const float (&g)[GMAX], int p) {
  float h = b_p;
#pragma unroll
  for (int k = 0; k < GMAX; ++k) h = fmaf(wgs[k * P + p], g[k], h);
  h = fmaxf(a_p + h, 0.f);
  if (BF16) h = round_bf16(h);
  return h;
}

// pre2 = W2^T h1 + b2 for one pair, h1 made on the fly (p ascending).
// `as_col` points at a[p = 0] of this lane's row in the [P][TILE_I + 1]
// tile, `bj` at the staged b row of column j; h1_out, when kept, receives
// every h1_p (K6 needs them).
template <int P, bool BF16, bool KEEP_H1>
__device__ __forceinline__ void pair_pre2(const float* as_col,
                                          const float* bj, const float* wgs,
                                          const float* w2s, const float* b2s,
                                          const float (&g)[GMAX],
                                          float (&pre)[P], float (&h1)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) pre[q] = b2s[q];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float h =
        pair_h1<P, BF16>(as_col[p * (TILE_I + 1)], bj[p], wgs, g, p);
    if (KEEP_H1) h1[p] = h;
    fc2_accumulate<P>(h, w2s, p, pre);
  }
}

// Stage the detection fields of `n` of the `n_all` detections from
// `first` (stacked [C][n_all] of one image) into s[FMAX][T]; the ragged
// edge takes the safe pad, absent fields (no class) zero.
template <int T>
__device__ __forceinline__ void stage_fields(float* s, const float* fields,
                                             int C, int n_all, int first,
                                             int n, int tid, int nthreads) {
  for (int x = tid; x < FMAX * T; x += nthreads) {
    const int f = x / T, t = x - f * T;
    s[x] = f >= C ? 0.f
                  : t < n ? fields[(size_t)f * n_all + first + t]
                          : safe_pad(f);
  }
}

}  // namespace gnet::unfolded
