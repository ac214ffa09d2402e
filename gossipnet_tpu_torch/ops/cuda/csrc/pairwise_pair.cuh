// Per-pair arithmetic of the unfolded GossipNet pair stage: the fields,
// the neighbour test and the features of K5 (pairwise_fwd.cu) and K6
// (pairwise_bwd.cu) on detections held in registers, and the same on
// fields staged in shared memory for K7 (pair_ablate.cu).
//
// K6 finds the max winners of K5 by exact float equality (pre2 == m), so
// both kernels compute every pair's IoU and features here, once, with the
// same operations in the same order and the same rounding points; FC1 and
// FC2 are K1's (h1_value, fc2_mma, pair_pre2 over nine features).
//
// Unlike K1 (pairwise2_pair.cuh), nothing is folded: a = r Wa + b1 and
// b = r Wb arrive as they are, and all 8 pair features of
// ops/pair_features.py (9 with the class match) are computed per pair, in
// its order: iou, (cx_j - cx_i) / w_i, (cy_j - cy_i) / h_i, the
// differences of log_w, log_h and log_aspect, s_i, s_j [, cls_i == cls_j].
// They are not symmetric in the two detections: a kernel whose lane owns a
// column (K6's column pass) passes the row detection as the row all the
// same. The IoU, the feature subtractions and divisions are explicitly
// rounded IEEE operations (__fsub_rn, __fdiv_rn, ...), so no FMA
// contraction moves a pair across the threshold or a feature off the plain
// version's bits.
//
// BF16 mode rounds what gossipnet_tpu/ops/pallas/pairwise.py feeds its bf16
// dots (:194-213): the features g, Wg, h1 and W2. a, b and b2 stay f32, as
// the TPU adds them in f32 -- unlike K1, whose b' rides the bf16 dot. So
// bf16 K5 and bf16 K1 differ; they compute the same function in f32.

#pragma once

#include "pairwise2_pair.cuh"  // tiles, queue stages, FC1, FC2, round_bf16

namespace gnet::unfolded {

constexpr int GMAX = 9;   // pair features: 8, +1 class match
constexpr int FMAX = 15;  // detection fields: the 14 DetColumns, +1 class

// Field order of the stacked DetColumns (ops/pair_features.py).
enum Field {
  X1, Y1, X2, Y2, CX, CY, W, H, LOG_W, LOG_H, LOG_ASPECT, AREA, SCORE, VALID,
  CLS
};

// ---------------------------------------------------------------------------
// K5 and K6: one detection's fields in registers
// ---------------------------------------------------------------------------

// Detection idx (stacked fields [C, N] of one image) into registers, zeros
// beyond N and beyond C; whether it exists and is valid. Fields a kernel
// never reads are never loaded (the compiler drops the loads).
__device__ __forceinline__ bool load_fields(const float* __restrict__ fields,
                                            int C, int N, int idx,
                                            float (&f)[FMAX]) {
#pragma unroll
  for (int c = 0; c < FMAX; ++c) f[c] = 0.f;
  if (idx < N) {
#pragma unroll
    for (int c = 0; c < FMAX; ++c)  // unrolled: f stays in registers
      if (c < C) f[c] = __ldg(fields + (size_t)c * N + idx);
  }
  return idx < N && f[VALID] > 0.f;
}

// Whether row detection ri and column detection cj are neighbours (IoU >=
// thr), and the IoU where the division ran: K1's pair_test
// (pairwise2_pair.cuh) on the DetColumns fields. A pair that passes has the
// IoU of pair_iou below, bit for bit (the same operations); the division
// is skipped only where inter < thr_lo * uni puts the pair clearly below
// thr, as K1 skips it.
__device__ __forceinline__ bool neighbour_test(const float (&ri)[FMAX],
                                               const float (&cj)[FMAX],
                                               float thr, float thr_lo,
                                               float& iou) {
  const float iw =
      fmaxf(__fsub_rn(fminf(ri[X2], cj[X2]), fmaxf(ri[X1], cj[X1])), 0.f);
  const float ih =
      fmaxf(__fsub_rn(fminf(ri[Y2], cj[Y2]), fmaxf(ri[Y1], cj[Y1])), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni =
      fmaxf(__fsub_rn(__fadd_rn(ri[AREA], cj[AREA]), inter), EPS);
  iou = 0.f;
  if (!(inter >= __fmul_rn(thr_lo, uni))) return false;
  iou = __fdiv_rn(inter, uni);
  return iou >= thr;
}

// The G pair features of row ri and column cj (g[8] = 0 when G = 8), the
// operations of pair_features below, rounded to bf16 in BF16 mode.
template <bool BF16>
__device__ __forceinline__ void det_features(const float (&ri)[FMAX],
                                             const float (&cj)[FMAX], int G,
                                             float iou, float (&g)[GMAX]) {
  g[0] = iou;
  g[1] = __fdiv_rn(__fsub_rn(cj[CX], ri[CX]), ri[W]);
  g[2] = __fdiv_rn(__fsub_rn(cj[CY], ri[CY]), ri[H]);
  g[3] = __fsub_rn(cj[LOG_W], ri[LOG_W]);
  g[4] = __fsub_rn(cj[LOG_H], ri[LOG_H]);
  g[5] = __fsub_rn(cj[LOG_ASPECT], ri[LOG_ASPECT]);
  g[6] = ri[SCORE];
  g[7] = cj[SCORE];
  g[8] = (G == GMAX && ri[CLS] == cj[CLS]) ? 1.f : 0.f;
  if (BF16) {
#pragma unroll
    for (int k = 0; k < GMAX - 1; ++k) g[k] = round_bf16(g[k]);
  }
}

// ---------------------------------------------------------------------------
// K7: fields staged in shared memory
// ---------------------------------------------------------------------------

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
