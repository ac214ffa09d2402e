// K6: the unfolded GossipNet pair-pool backward for Hopper (sm_90a), CUDA
// cores.
//
// Replaces the TPU kernel gossipnet_tpu/ops/pallas/pairwise.py::
// _bwd_row_kernel (:492; recompute _tile_backward_core:436, launcher
// _backward:572, VJP _pair_pool_p:656-676).
//
// Function: the VJP of K5 (pairwise_fwd.cu) from its saved output m and
// the cotangent dm, recomputing every neighbour pair:
//   pre2_ij = W2^T h1_ij + b2,  h1_ij = relu(a_i + b_j + Wg^T g_ij)
//   dpre2_ij[q] = dm_i[q] if pre2_ij[q] == m_i[q] and m_i[q] > 0, else 0
// so EACH exact tie of the max gets the full dm (the TPU kernel's win
// mask h2 == m, with its relu factor h2 > 0),
//   dpre1_ij = (W2 dpre2_ij) where h1_ij > 0
//   d_a_i = sum_j dpre1_ij          d_b_j = sum_i dpre1_ij
//   dWg   = sum_ij g_ij dpre1_ij^T  (all G = 8 or 9 rows)
//   dW2   = sum_ij h1_ij dpre2_ij^T db2 = sum_ij dpre2_ij
// The winner test is exact float equality against K5's m, so pre2 is
// recomputed with K5's own code (pairwise_pair.cuh).
//
// Bound at the training shapes: compute, like K5. Per neighbour pair it
// recomputes K5's ~P^2 + (G + 2)P FMAs and then, where the pair wins some
// q, the sparse W2 dpre2 product, the d_b / dWg warp reductions (1 + G
// reduce-scatters) and the rank-32 dW2 update. This first version stays
// on CUDA cores; a warp whose 32 pairs win nothing skips all gradient work
// (one ballot), which is most of the skipped work since winners are about
// one per (row, q).
//
// Layout: K5's grid, one block per (row tile of TILE_I = 32 rows, image),
// four warps; lane l owns row row0 + l, the warps split each staged column
// tile and skip inactive tiles through the same flags. The row fields sit
// in shared memory, not in registers: K2 (pairwise2_bwd.cu), which this
// follows, already needs 228-255 registers at P = 32, and K6 carries 9
// features instead of 4.
//
// Deterministic, with no float atomics:
// - d_a_i sums in registers per warp, then over the warps in order;
// - d_b_j of one (row tile, column) is a reduce-scatter over the 32 lanes
//   by warp shuffles in a fixed order, written to a per-row-tile partial
//   [B, NI, NC, P] that the wrapper sums. At config 4 (B = 2, N = 4096,
//   P = 32) the partial is 2 * 128 * 4096 * 32 * 4 B = 134 MB, as the TPU
//   kernel's own per-row-tile partial is: acceptable on an 80 GB card;
// - dWg, dW2 and db2 accumulate per warp in shared memory, each entry
//   owned by one lane, and leave as per-block partials summed over the
//   warps in order; the wrapper sums the blocks.
// Two launches on the same inputs give bit-identical gradients.
//
// BF16 mode rounds the operands of the TPU backward's three bf16 dots
// (pairwise.py:462-467, :545-563): dpre2 and W2 for dh1, dpre1 and g for
// dWg, h1 and dpre2 for dW2. d_a, d_b and db2 sum unrounded f32, as the
// TPU kernel sums them. Non-BF16 mode is IEEE f32.

#include "pairwise_pair.cuh"
#include "warp_reduce.cuh"

namespace {

using namespace gnet::unfolded;
using gnet::FULL;
using gnet::NTHREADS;
using gnet::NWARPS;
using gnet::reduce_scatter;
using gnet::round_bf16;
using gnet::rs_count;
using gnet::rs_index;
using gnet::rs_writer;
using gnet::TILE_I;
using gnet::TILE_J;

template <int P>
constexpr size_t smem_floats() {
  return P * P + GMAX * P + P               // w2s, wgs, b2s
         + 3 * P * (TILE_I + 1)             // as, ms, dms (row tile)
         + FMAX * TILE_I                    // rs (row fields)
         + TILE_J * P + FMAX * TILE_J       // bs, cs (column tile)
         + 2 * NWARPS * 32 * (P + 1)        // per-warp h1, dpre2 rows
         + NWARPS * (P * P + GMAX * P + P);  // per-warp dW2, dWg, db2
}

template <int P, bool BF16>
__global__ void __launch_bounds__(NTHREADS)
pair_pool_bwd_kernel(const float* __restrict__ row_cols,  // [B, C, NR]
                     const float* __restrict__ col_cols,  // [B, C, NC]
                     const float* __restrict__ a,         // [B, NR, P]
                     const float* __restrict__ b,         // [B, NC, P]
                     const float* __restrict__ wg,        // [G, P]
                     const float* __restrict__ w2,        // [P, P] (in, out)
                     const float* __restrict__ b2,        // [P]
                     const int* __restrict__ flags,       // [B, NI, NJ]
                     const float* __restrict__ m,         // [B, NR, P]
                     const float* __restrict__ dm,        // [B, NR, P]
                     float* __restrict__ da,              // [B, NR, P]
                     float* __restrict__ db_part,         // [B, NI, NC, P]
                     float* __restrict__ dwg_part,        // [B*NI, G, P]
                     float* __restrict__ dw2_part,        // [B*NI, P, P]
                     float* __restrict__ db2_part,        // [B*NI, P]
                     int NR, int NC, int G, float thr) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = TILE_I + 1;            // row-tile leading dimension
  constexpr int RW = P + 1;                 // per-warp row stride
  float* w2s = smem;                        // [P][P]
  float* wgs = w2s + P * P;                 // [GMAX][P], rows >= G zero
  float* b2s = wgs + GMAX * P;              // [P]
  float* as = b2s + P;                      // [P][LD]
  float* ms = as + P * LD;                  // [P][LD]
  float* dms = ms + P * LD;                 // [P][LD]  dm where m > 0
  float* rs = dms + P * LD;                 // [FMAX][TILE_I] row fields
  float* bs = rs + FMAX * TILE_I;           // [TILE_J][P] column tile
  float* cs = bs + TILE_J * P;              // [FMAX][TILE_J]
  float* h1w = cs + FMAX * TILE_J;          // [NWARPS][32][RW]
  float* dp2w = h1w + NWARPS * 32 * RW;     // [NWARPS][32][RW]
  float* dw2w = dp2w + NWARPS * 32 * RW;    // [NWARPS][P][P]
  float* dwgw = dw2w + NWARPS * P * P;      // [NWARPS][GMAX][P]
  float* db2w = dwgw + NWARPS * GMAX * P;   // [NWARPS][P]

  const int C = G == GMAX ? FMAX : FMAX - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int img = blockIdx.y;
  const int tile_i = blockIdx.x;
  const int NI = (NR + TILE_I - 1) / TILE_I;
  const int NJ = (NC + TILE_J - 1) / TILE_J;
  const int row0 = tile_i * TILE_I;
  const int nrow = min(TILE_I, NR - row0);

  for (int x = tid; x < P * P; x += NTHREADS)
    w2s[x] = BF16 ? round_bf16(w2[x]) : w2[x];
  for (int x = tid; x < GMAX * P; x += NTHREADS) {
    const float v = x < G * P ? wg[x] : 0.f;
    wgs[x] = BF16 ? round_bf16(v) : v;
  }
  for (int x = tid; x < P; x += NTHREADS) b2s[x] = b2[x];
  for (int x = tid; x < TILE_I * P; x += NTHREADS) {
    const int r = x / P, p = x - r * P;
    const bool in = r < nrow;
    const size_t idx = ((size_t)img * NR + row0 + r) * P + p;
    const float mv = in ? m[idx] : 0.f;
    as[p * LD + r] = in ? a[idx] : 0.f;
    ms[p * LD + r] = mv;
    dms[p * LD + r] = in && mv > 0.f ? dm[idx] : 0.f;
  }
  stage_fields<TILE_I>(rs, row_cols + (size_t)img * C * NR, C, NR, row0,
                       nrow, tid, NTHREADS);
  for (int x = tid; x < NWARPS * (P * P + GMAX * P + P); x += NTHREADS)
    dw2w[x] = 0.f;  // dw2w, dwgw, db2w are contiguous
  __syncthreads();
  const bool live = lane < nrow && row(rs, VALID, lane) > 0.f;

  float da_acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) da_acc[p] = 0.f;

  float* h1s = h1w + warp * 32 * RW;
  float* dp2s = dp2w + warp * 32 * RW;
  float* dw2s = dw2w + warp * P * P;
  float* dwgs = dwgw + warp * GMAX * P;
  float* db2a = db2w + warp * P;
  const float* cc = col_cols + (size_t)img * C * NC;
  const float* b_img = b + (size_t)img * NC * P;
  const int* fl = flags + ((size_t)img * NI + tile_i) * NJ;
  float* dbp = db_part + ((size_t)img * NI + tile_i) * NC * P;

  for (int tj = 0; tj < NJ; ++tj) {
    if (fl[tj] == 0) continue;  // the same for the whole block
    const int col0 = tj * TILE_J;
    const int ncol = min(TILE_J, NC - col0);
    __syncthreads();  // the previous tile's readers are done
    for (int x = tid; x < TILE_J * P; x += NTHREADS)
      bs[x] = x < ncol * P ? b_img[(size_t)col0 * P + x] : 0.f;
    stage_fields<TILE_J>(cs, cc, C, NC, col0, ncol, tid, NTHREADS);
    __syncthreads();

    // Every lane walks the warp's columns (warp-uniform loop): the
    // ballot and the shuffles below need the whole warp.
    for (int j = warp; j < ncol; j += NWARPS) {
      float iou = 0.f;
      bool nb = false;
      if (live) {
        iou = pair_iou(rs, lane, cs, j);
        nb = col(cs, VALID, j) > 0.f && iou >= thr;
      }
      float g[GMAX];
#pragma unroll
      for (int k = 0; k < GMAX; ++k) g[k] = 0.f;
      float h1[P], dp2[P];
      bool win = false;
      if (nb) {
        pair_features<BF16>(rs, lane, cs, j, G, iou, g);
        float pre[P];
        pair_pre2<P, BF16, true>(as + lane, bs + j * P, wgs, w2s, b2s, g,
                                 pre, h1);
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float d = pre[q] == ms[q * LD + lane] ? dms[q * LD + lane]
                                                      : 0.f;
          dp2[q] = d;
          win |= d != 0.f;
        }
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) h1[p] = dp2[p] = 0.f;
      }
      if (!__any_sync(FULL, win)) continue;

#pragma unroll
      for (int p = 0; p < P; ++p) {
        h1s[lane * RW + p] = h1[p];
        dp2s[lane * RW + p] = dp2[p];
      }

      // dpre1 = (W2 dpre2) where h1 > 0; dpre2 is sparse in q.
      float dp1[P];
#pragma unroll
      for (int p = 0; p < P; ++p) dp1[p] = 0.f;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (dp2[q] != 0.f) {
          const float d = BF16 ? round_bf16(dp2[q]) : dp2[q];
#pragma unroll
          for (int p = 0; p < P; ++p) dp1[p] = fmaf(w2s[p * P + q], d, dp1[p]);
        }
      }
      // d_a and d_b take dpre1 unrounded.
      float u[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        dp1[p] = h1[p] > 0.f ? dp1[p] : 0.f;
        da_acc[p] += dp1[p];
        u[p] = dp1[p];
      }
      // d_b_j: sum over the warp's 32 rows -> the row tile's partial.
      reduce_scatter<P, P, 16>(u, lane);
      if (rs_writer<P>(lane)) {
#pragma unroll
        for (int r = 0; r < rs_count<P>(); ++r)
          dbp[(size_t)(col0 + j) * P + rs_index<P>(lane, r)] = u[r];
      }
      // dWg[k, :] += sum over the rows of g_k * dpre1 (the dot's operands).
      if (BF16) {
#pragma unroll
        for (int p = 0; p < P; ++p) dp1[p] = round_bf16(dp1[p]);
      }
#pragma unroll
      for (int k = 0; k < GMAX; ++k) {
        if (k < G) {
#pragma unroll
          for (int p = 0; p < P; ++p) u[p] = dp1[p] * g[k];
          reduce_scatter<P, P, 16>(u, lane);
          if (rs_writer<P>(lane)) {
#pragma unroll
            for (int r = 0; r < rs_count<P>(); ++r)
              dwgs[k * P + rs_index<P>(lane, r)] += u[r];
          }
        }
      }

      // dW2[:, q] += sum over the rows of h1 * dpre2[q], db2[q] += dpre2[q]:
      // lane q owns column q (and q + 32, ... for P > 32).
      __syncwarp();
#pragma unroll
      for (int q0 = 0; q0 < P; q0 += 32) {
        const int q = q0 + lane;
        if (q < P) {
          float acc[P];
          bool touched = false;
          float acc_b2 = 0.f;
          for (int l = 0; l < 32; ++l) {
            const float d = dp2s[l * RW + q];
            if (d == 0.f) continue;
            if (!touched) {
#pragma unroll
              for (int p = 0; p < P; ++p) acc[p] = dw2s[p * P + q];
              acc_b2 = db2a[q];
              touched = true;
            }
            acc_b2 += d;
            const float dr = BF16 ? round_bf16(d) : d;
#pragma unroll
            for (int p = 0; p < P; ++p)
              acc[p] = fmaf(h1s[l * RW + p], dr, acc[p]);
          }
          if (touched) {
#pragma unroll
            for (int p = 0; p < P; ++p) dw2s[p * P + q] = acc[p];
            db2a[q] = acc_b2;
          }
        }
      }
      __syncwarp();  // h1s / dp2s are rewritten by the next column
    }
  }

  // d_a: the warps' sums meet in a fixed order.
  __syncthreads();
  float* red = h1w;  // [NWARPS][TILE_I][RW]
#pragma unroll
  for (int p = 0; p < P; ++p) red[(warp * TILE_I + lane) * RW + p] = da_acc[p];
  __syncthreads();
  for (int x = tid; x < TILE_I * P; x += NTHREADS) {
    const int r = x / P, p = x - r * P;
    if (r >= nrow) continue;
    float v = red[r * RW + p];
    for (int w = 1; w < NWARPS; ++w) v += red[(w * TILE_I + r) * RW + p];
    da[((size_t)img * NR + row0 + r) * P + p] = v;
  }
  // Weight gradients: this block's partials, warps summed in order.
  const size_t blk = (size_t)img * NI + tile_i;
  for (int x = tid; x < P * P; x += NTHREADS) {
    float v = dw2w[x];
    for (int w = 1; w < NWARPS; ++w) v += dw2w[w * P * P + x];
    dw2_part[blk * P * P + x] = v;
  }
  for (int x = tid; x < G * P; x += NTHREADS) {
    float v = dwgw[x];
    for (int w = 1; w < NWARPS; ++w) v += dwgw[w * GMAX * P + x];
    dwg_part[blk * G * P + x] = v;
  }
  for (int x = tid; x < P; x += NTHREADS) {
    float v = db2w[x];
    for (int w = 1; w < NWARPS; ++w) v += db2w[w * P + x];
    db2_part[blk * P + x] = v;
  }
}

struct Args {
  const float *row_cols, *col_cols, *a, *b, *wg, *w2, *b2;
  const int* flags;
  const float *m, *dm;
  float *da, *db_part, *dwg_part, *dw2_part, *db2_part;
  int B, NR, NC, G;
  float thr;
};

template <int P, bool BF16>
int launch(const Args& x, cudaStream_t stream) {
  const size_t smem = smem_floats<P>() * sizeof(float);
  auto kernel = pair_pool_bwd_kernel<P, BF16>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((x.NR + TILE_I - 1) / TILE_I, x.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      x.row_cols, x.col_cols, x.a, x.b, x.wg, x.w2, x.b2, x.flags, x.m, x.dm,
      x.da, x.db_part, x.dwg_part, x.dw2_part, x.db2_part, x.NR, x.NC, x.G,
      x.thr);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch_p(int P, const Args& x, cudaStream_t s) {
  switch (P) {
    case 8: return launch<8, BF16>(x, s);
    case 16: return launch<16, BF16>(x, s);
    case 32: return launch<32, BF16>(x, s);
    case 64: return launch<64, BF16>(x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Tile shape the flags must be computed at: TILE_I * 1000 + TILE_J.
int gnet_pair_pool_bwd_tiles() { return TILE_I * 1000 + TILE_J; }

// Launches K6 on `stream`; returns cudaGetLastError() (0 = launched).
// db_part must be zero on entry (skipped tiles and columns without a
// winner are not written); every other output is written in full.
int gnet_pair_pool_bwd(const float* row_cols, const float* col_cols,
                       const float* a, const float* b, const float* wg,
                       const float* w2, const float* b2, const int* flags,
                       const float* m, const float* dm, float* da,
                       float* db_part, float* dwg_part, float* dw2_part,
                       float* db2_part, int B, int NR, int NC, int P, int G,
                       float thr, int bf16, void* stream) {
  if (B <= 0 || NR <= 0) return 0;
  if ((G != GMAX && G != GMAX - 1) || NC < 0)
    return (int)cudaErrorInvalidValue;
  const Args x{row_cols, col_cols, a,        b,        wg,
               w2,       b2,       flags,    m,        dm,
               da,       db_part,  dwg_part, dw2_part, db2_part,
               B,        NR,       NC,       G,        thr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_p<true>(P, x, s) : dispatch_p<false>(P, x, s);
}

}  // extern "C"
