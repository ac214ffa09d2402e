// Per-pair arithmetic of the GossipNet pair stage, shared by K1
// (pairwise2_fwd.cu) and K2 (pairwise2_bwd.cu): the IoU test and the pair
// features (stage A of both kernels), FC1 in the layouts stage B wants, and
// FC2 of f32 mode. The queue between the stages and FC2 of bf16 mode (the
// tensor-core product of a group) live in pair_group.cuh. The stage loop,
// FC1 and FC2 take the number of features per pair as a template argument,
// so K5 and K6 (pairwise_fwd.cu, pairwise_bwd.cu) run on them too with
// their own fields, test and nine features (pairwise_pair.cuh).
//
// K2 finds the max winners of K1 by exact float equality (pre2 == m), so
// both kernels must compute every pair's IoU, features, h1 and pre2 with
// the same operations in the same order and the same rounding points, and
// a pair's pre2 must not depend on where it sits in a group. Keeping that
// code here and in pair_group.cuh, once, is what makes the equality hold:
// a change changes both kernels together (and the library hash of both,
// see ops/cuda/build.py).
//
// Numerics: the IoU and the neighbour predicate use explicitly rounded
// operations (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so no FMA
// contraction can move a pair across the threshold, and every one of them
// is commutative in the two detections, so the test gives the same bits
// whichever detection the lane owns (K2's second pass owns the column).
// FC1 is an explicit fmaf chain in a fixed order. BF16 mode rounds what
// the TPU kernel feeds its bf16 dots (features g, b', Wg_k, h1, W2) and
// accumulates in f32 (on the tensor cores); a' and b2 stay f32. f32 mode
// is IEEE f32 on CUDA cores, FC2 an fmaf chain over p ascending: no TF32.
// EW, K1/K2's bf16 stream (elementwise_dtype=bfloat16, BF16 only), also
// rounds a', the FC1 sum and their sum (h1_value) and the FC2 output and
// b2 (fc2_mma), where the TPU kernel's bf16 scratch rounds them.

#pragma once

#include "pair_group.cuh"

#include <cstddef>

namespace gnet {

constexpr int TILE_I = 32;  // detections a block owns: one per lane
constexpr int NWARPS = 4;   // warps sharing a tile of the other side
constexpr int NTHREADS = 32 * NWARPS;
constexpr int KMAX = QFEAT; // pair features kept in the kernel
constexpr int CMAX = 9;     // fields per detection (8, +1 class)
constexpr float EPS = 1e-6f;

// The skip tile, a launch argument (ops/cuda/launch.py TILES): the flags
// of tile_activity (ops/cuda/pairwise2.py) hold one int per cell of FI
// rows x TJ columns of the pair matrix, FI in {32, 64}, TJ in {16, 32, 64,
// 128}. A block's own 32 detections lie in one flag row of FI (row0 / FI),
// and stage A walks the other side in tiles of TJ. Every size is a power of
// two, so the tile travels as two shifts and costs no instantiation.
struct Tile {
  int fi_shift, tj_shift;  // log2 FI, log2 TJ
  __host__ __device__ int rows(int n) const {  // flag rows over n rows
    return (n + (1 << fi_shift) - 1) >> fi_shift;
  }
  __host__ __device__ int cols(int n) const {  // flag columns over n columns
    return (n + (1 << tj_shift) - 1) >> tj_shift;
  }
};

// The Tile of (FI, TJ), or false where the kernels do not take the shape.
inline bool make_tile(int fi, int tj, Tile& t) {
  if ((fi != 32 && fi != 64) || (tj != 16 && tj != 32 && tj != 64 &&
                                 tj != 128))
    return false;
  t.fi_shift = fi == 32 ? 5 : 6;
  for (t.tj_shift = 4; (1 << t.tj_shift) < tj; ++t.tj_shift) {
  }
  return true;
}

// The backwards' column pass: a block owns columns [c0, c0 + 32) and
// walks the rows in tiles of TJ. Tile t can hold a neighbour when a flag
// is set in any cell that overlaps rows [t TJ, (t + 1) TJ) x the own
// columns: up to TJ / FI flag rows (four at 32 x 128) by up to 32 / TJ
// flag columns (two at TJ = 16). The block finds that once for all its
// tiles, one bit a tile, into `bits` in shared memory (ACT_WORDS words:
// MAX_DETS rows at TJ = 16), so the stage loop reads one bit an item.
// `fl` is one image's flags, nfr x nfc; `nrows` the rows walked. The
// caller synchronises the block before the bits are read.
constexpr int ACT_WORDS = MAX_DETS / 16 / 32;

__device__ __forceinline__ void stage_column_activity(
    const int* __restrict__ fl, int nfr, int nfc, Tile tile, int c0,
    int nrows, unsigned* bits, int lane, int warp) {
  const int fc0 = c0 >> tile.tj_shift;
  const int fc1 = min((c0 + 31) >> tile.tj_shift, nfc - 1);
  const int ntiles = (nrows + (1 << tile.tj_shift) - 1) >> tile.tj_shift;
  for (int base = warp * 32; base < ntiles; base += NWARPS * 32) {
    const int t = base + lane;
    bool on = false;
    if (t < ntiles) {
      const int fr1 =
          min((((t + 1) << tile.tj_shift) - 1) >> tile.fi_shift, nfr - 1);
      for (int fr = (t << tile.tj_shift) >> tile.fi_shift; fr <= fr1; ++fr)
        for (int fc = fc0; fc <= fc1; ++fc)
          on = on || fl[(size_t)fr * nfc + fc] != 0;
    }
    const unsigned m = __ballot_sync(ALL_LANES, on);
    if (lane == 0) bits[base >> 5] = m;
  }
}

// Pairs stage B takes at once: the 16 rows of an mma tile, or one per lane.
template <bool BF16>
__host__ __device__ constexpr int group_size() { return BF16 ? 16 : 32; }

// Row fields: x1 y1 x2 y2 area inv_w inv_h valid [cls]
// Col fields: x1 y1 x2 y2 area cx   cy    valid [cls]

// The neighbour test of the lane's own detection `ri` and detection `cj`
// of the other side: whether IoU >= thr, and the IoU where it is. The
// test is the correctly rounded quotient against thr, as the plain version
// makes it; the division is only run where the pair is not clearly below:
// inter < thr (1 - 1e-6) uni puts the exact quotient more than 30 half-ulps
// under thr, so its rounding cannot reach thr, and the product's own
// rounding (6e-8 relative, twice) cannot close that gap. Most tested pairs
// do not overlap at all and skip the division.
__device__ __forceinline__ bool pair_test(const float (&ri)[CMAX],
                                          const float (&cj)[CMAX], float thr,
                                          float thr_lo, float& iou) {
  const float iw =
      fmaxf(__fsub_rn(fminf(ri[2], cj[2]), fmaxf(ri[0], cj[0])), 0.f);
  const float ih =
      fmaxf(__fsub_rn(fminf(ri[3], cj[3]), fmaxf(ri[1], cj[1])), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni =
      fmaxf(__fsub_rn(__fadd_rn(ri[4], cj[4]), inter), EPS);
  iou = 0.f;
  if (!(inter >= __fmul_rn(thr_lo, uni))) return false;
  iou = __fdiv_rn(inter, uni);
  return iou >= thr;
}

// The in-kernel pair features g = [iou, cx_j * inv_w_i, cy_j * inv_h_i,
// cls_i == cls_j], rounded to bf16 in BF16 mode (the class match is 0/1).
// Fields 5 and 6 hold inv_w, inv_h on the row side and cx, cy on the
// column side, so the same two products serve a lane that owns the row
// and one that owns the column.
template <bool BF16>
__device__ __forceinline__ void pair_features(const float (&ri)[CMAX],
                                              const float (&cj)[CMAX], int K,
                                              float iou, float (&g)[KMAX]) {
  g[0] = iou;
  g[1] = __fmul_rn(cj[5], ri[5]);
  g[2] = __fmul_rn(cj[6], ri[6]);
  g[3] = (K == 4 && ri[8] == cj[8]) ? 1.f : 0.f;
  if (BF16) {
    g[0] = round_bf16(g[0]);
    g[1] = round_bf16(g[1]);
    g[2] = round_bf16(g[2]);
  }
}

// Detection idx (fields [C, N] of one image) into registers, zeros beyond
// N; returns whether it exists and is valid.
__device__ __forceinline__ bool load_det(const float* __restrict__ fields,
                                         int C, int N, int idx,
                                         float (&ri)[CMAX]) {
#pragma unroll
  for (int c = 0; c < CMAX; ++c) ri[c] = 0.f;
  if (idx < N) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c)  // unrolled: ri stays in registers
      if (c < C) ri[c] = __ldg(fields + (size_t)c * N + idx);
  }
  return idx < N && ri[7] > 0.f;
}

// The two stages for one warp. Lane l owns one detection. Stage A tests
// it against the warp's TJ / NWARPS detections of every active tile of
// TJ = 1 << tj_shift detections of the other side, STEP at a time so
// that their loads and IoU chains overlap (the whole warp reads the same
// detection: a broadcast from L1, no staging and no block-wide barrier),
// and pushes the neighbours in detection order. After every STEP pushes, and once more at the end for
// the short last group, `consume(head, n)` (stage B) pops the queue in
// groups of GROUP. Stage B is instantiated at this one place: its code is
// long, and a warp that met it at several places would wait for
// instructions more than for data.
// `test(d, g)`: whether the own detection and detection d of the other
// side are neighbours, and then their NF features in g (zero on entry);
// `active(t)`: whether tile t (detections [t TJ, (t + 1) TJ) of the other
// side) can hold a neighbour; `split` of `splits`:
// this block's share of the work on its own detections; `ij_own`: the own
// index already shifted to its half of the packed entry; `other_shift`:
// the other half's shift.
constexpr int STEP = 2;
static_assert(32 + STEP * 32 <= QCAP, "a group and STEP pushes fit the ring");
static_assert(NWARPS * STEP == 8, "a tile of TJ is TJ / 8 steps of a warp");

template <int GROUP, int NF, class Active, class Test, class Consume>
__device__ __forceinline__ void stage_loop(
    bool live, int N, int split, int splits, int tj_shift, Active& active,
    int ij_own, int other_shift, int* q_ij, float* q_g, int lane, int warp,
    Test& test, Consume& consume) {
  if (!__any_sync(ALL_LANES, live)) return;
  const int steps_shift = tj_shift - 3;  // TJ / (NWARPS STEP) steps a tile
  const int n_items = ((N + (1 << tj_shift) - 1) >> tj_shift) << steps_shift;
  int head = 0, count = 0;
  // Item w is step w % STEPS of tile w / STEPS; the blocks that share the
  // own detections take the items round robin, so a crowded tile is
  // spread over all of them.
  for (int w = split;; w += splits) {
    const bool flush = w >= n_items;
    if (!flush && active(w >> steps_shift)) {
      const int d0 = ((w >> steps_shift) << tj_shift) +
                     (warp << (tj_shift - 2)) +
                     (w & ((1 << steps_shift) - 1)) * STEP;
      bool pass[STEP];
      float g[STEP][NF];
#pragma unroll
      for (int v = 0; v < STEP; ++v) {
#pragma unroll
        for (int k = 0; k < NF; ++k) g[v][k] = 0.f;
        pass[v] = test(d0 + v, g[v]);
      }
#pragma unroll
      for (int v = 0; v < STEP; ++v)
        queue_push(q_ij, q_g, head, count, pass[v],
                   ij_own | ((d0 + v) << other_shift), g[v], lane);
    }
    while (count >= GROUP || (flush && count > 0)) {
      const int n = min(count, GROUP);
      consume(head, n);
      head = (head + n) & (QCAP - 1);
      count -= n;
    }
    if (flush) break;
  }
}

// K1's and K2's stages: lane l owns detection `ri` (fields [C, N] of the
// other side in `fields`), K1's test and its 3-4 features.
template <bool BF16, int GROUP, class Active, class Consume>
__device__ __forceinline__ void run_stages(
    const float (&ri)[CMAX], bool live, const float* __restrict__ fields,
    int C, int N, int split, int splits, int tj_shift, Active& active, int K,
    float thr, int ij_own, int other_shift, int* q_ij, float* q_g, int lane,
    int warp, Consume& consume) {
  const float thr_lo = __fmul_rn(thr, 1.f - 1e-6f);
  auto test = [&](int d, float (&g)[KMAX]) {
    float cj[CMAX];
    const bool valid = load_det(fields, C, N, d, cj);
    float iou;
    if (live && valid && pair_test(ri, cj, thr, thr_lo, iou)) {
      pair_features<BF16>(ri, cj, K, iou, g);
      return true;
    }
    return false;
  };
  stage_loop<GROUP, KMAX>(live, N, split, splits, tj_shift, active, ij_own,
                          other_shift, q_ij, q_g, lane, warp, test, consume);
}

// Weights into shared memory: wgs [NF][P] (rows >= K zero, bf16-rounded
// in BF16 mode) and b2s [P]. Whole block.
template <int P, bool BF16, int NF = KMAX>
__device__ __forceinline__ void stage_small_weights(
    const float* __restrict__ wg, const float* __restrict__ b2, int K,
    float* wgs, float* b2s, int tid) {
  for (int x = tid; x < NF * P; x += NTHREADS) {
    const float v = x < K * P ? wg[x] : 0.f;
    wgs[x] = BF16 ? round_bf16(v) : v;
  }
  for (int x = tid; x < P; x += NTHREADS) b2s[x] = b2[x];
}

// h1_p = relu(a'_p + (b'_p + Wg_k[:, p] . g)), the dot an fmaf chain in
// feature order, rounded to bf16 in BF16 mode. wgs is [NF][P] with zero
// rows beyond the kernel's feature count (K1's row 3 when K == 3, K5's row
// 8 when G == 8); K1's b_p is already rounded in BF16 mode, K5's is not.
// EW (the bf16 stream): the dot and a'_p are rounded before the add, the
// sum after it, as the TPU kernel adds its bf16 scratch a' and the dot's
// output cast to bf16.
template <int P, bool BF16, bool EW = false, int NF>
__device__ __forceinline__ float h1_value(float a_p, float b_p,
                                          const float* wgs,
                                          const float (&g)[NF], int p) {
  static_assert(!EW || BF16, "a bf16 stream needs bf16 operands");
  float h = b_p;
#pragma unroll
  for (int k = 0; k < NF; ++k) h = fmaf(wgs[k * P + p], g[k], h);
  if (EW) return fmaxf(round_bf16(__fadd_rn(round_bf16(a_p), round_bf16(h))),
                       0.f);
  h = fmaxf(a_p + h, 0.f);
  if (BF16) h = round_bf16(h);
  return h;
}

// FC1 of a group of up to 16 queued pairs (ring slots head ..), straight
// into the A fragments of fc2_mma. Slots beyond nvalid compute on
// detection 0 and are ignored by the caller. ij2 receives the packed
// (row, column) of the lane's two slots, gid and gid + 8. NF features per
// entry; ROUND_B: b_p goes into the bf16 dot rounded (K1's b'), or stays
// f32 (K5's b); EW: K1/K2's bf16 stream (h1_value).
template <int P, int NF = KMAX, bool ROUND_B = true, bool EW = false>
__device__ __forceinline__ void group_h1_frags(
    const float* __restrict__ a_img, const float* __restrict__ b_img,
    const float* wgs, const int* q_ij, const float* q_g, int head, int nvalid,
    int lane, uint32_t (&afr)[Frag<P>::KB][4], int (&ij2)[2]) {
  using F = Frag<P>;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int slot = gid + 8 * h;
    const int qi = (head + slot) & (QCAP - 1);
    const int ij = slot < nvalid ? q_ij[qi] : 0;
    ij2[h] = ij;
    float g[NF];
#pragma unroll
    for (int k = 0; k < NF; ++k) g[k] = q_g[k * QCAP + qi];
#ifdef GNET_ABLATE_LOADS  // a timing switch of pairwise2_fwd.cu
    const float* ar = a_img + (size_t)(ij >> 30) * P;
    const float* br = b_img + (size_t)(ij >> 30) * P;
#else
    const float* ar = a_img + (size_t)(ij >> 16) * P;
    const float* br = b_img + (size_t)(ij & 0xffff) * P;
#endif
#pragma unroll
    for (int kb = 0; kb < F::KB; ++kb) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int p = kb * 16 + tig * 2 + 8 * c;
        float lo = 0.f, hi = 0.f;
        if (p < P) {  // compile-time after unrolling, but for tig
          const float2 av = __ldg(reinterpret_cast<const float2*>(ar + p));
          const float2 bv = __ldg(reinterpret_cast<const float2*>(br + p));
          lo = h1_value<P, true, EW>(av.x,
                                     ROUND_B ? round_bf16(bv.x) : bv.x, wgs,
                                     g, p);
          hi = h1_value<P, true, EW>(av.y,
                                     ROUND_B ? round_bf16(bv.y) : bv.y, wgs,
                                     g, p + 1);
        }
        afr[kb][h + 2 * c] = pack_bf16(lo, hi);
      }
    }
  }
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

// f32 mode: pre2 = W2^T h1 + b2 for this lane's pair on CUDA cores, h1
// computed on the fly: p ascending, each h1_p consumed as soon as it is
// made. ar / br point at a'_i and b'_j in device memory (16-byte aligned
// rows).
template <int P, int NF>
__device__ __forceinline__ void pair_pre2(const float* __restrict__ ar,
                                          const float* __restrict__ br,
                                          const float* wgs, const float* w2s,
                                          const float* b2s,
                                          const float (&g)[NF],
                                          float (&pre)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) pre[q] = b2s[q];
#pragma unroll
  for (int p4 = 0; p4 < P / 4; ++p4) {
    const float4 av = __ldg(reinterpret_cast<const float4*>(ar) + p4);
    const float4 bv = __ldg(reinterpret_cast<const float4*>(br) + p4);
    const float a4[4] = {av.x, av.y, av.z, av.w};
    const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * p4 + e;
      const float h = h1_value<P, false>(a4[e], b4[e], wgs, g, p);
      fc2_accumulate<P>(h, w2s, p, pre);
    }
  }
}

// This lane's queued pair (ring slot head + lane) for the CUDA-core path:
// its packed (row, column), 0 beyond nvalid, and its features.
template <int NF>
__device__ __forceinline__ int lane_pair(const int* q_ij, const float* q_g,
                                         int head, int nvalid, int lane,
                                         float (&g)[NF]) {
  const int qi = (head + lane) & (QCAP - 1);
#pragma unroll
  for (int k = 0; k < NF; ++k) g[k] = q_g[k * QCAP + qi];
  return lane < nvalid ? q_ij[qi] : 0;
}

// out[i] = part[0][i] + part[1][i] + ... in that order, for d_a (the
// first na elements of the index space) and d_b (the next nb) at once: the
// last step of K2 and K6, whose splits each sum into a slice of their own.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
sum_slices_kernel(const float* __restrict__ da_part,
                  const float* __restrict__ db_part, float* __restrict__ da,
                  float* __restrict__ db, int splits, size_t na, size_t nb) {
  size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const bool first = i < na;
  if (!first) i -= na;
  const size_t n = first ? na : nb;
  if (i >= n) return;
  const float* part = first ? da_part : db_part;
  float v = part[i];
  for (int s = 1; s < splits; ++s) v += part[(size_t)s * n + i];
  (first ? da : db)[i] = v;
}

template <int THREADS = 256>
int sum_slices(const float* da_part, const float* db_part, float* da,
               float* db, int splits, size_t na, size_t nb,
               cudaStream_t stream) {
  if (na + nb == 0) return 0;
  sum_slices_kernel<THREADS>
      <<<(unsigned)((na + nb + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          da_part, db_part, da, db, splits, na, nb);
  return (int)cudaGetLastError();
}

}  // namespace gnet
