// K6: the unfolded GossipNet pair-pool backward for Hopper (sm_90a).
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
// recomputed through K5's own stage A, queue and FC2 (pairwise_pair.cuh,
// pairwise2_pair.cuh, pair_group.cuh), where a pair's pre2 depends on
// nothing but the pair.
//
// Bound: operations, like K5, and what limits it on this card is how the
// sparse work is laid on warps: the recompute is K5's, and the gradient
// work is sparser still (about one winning q per neighbour pair that wins
// at all, and most win nothing). The design is K2's (pairwise2_bwd.cu):
// - The recompute is K5's stage A / stage B: dense test, compacted queue of
//   pairs with their nine features, FC2 of a group on the tensor cores in
//   bf16 mode (f32 mode: CUDA cores, IEEE f32, K5's fmaf order).
// - A winner queue. A group's pre2 is compared with m per (pair, q); a pair
//   that wins some q goes, with its features and q mask, into a second
//   per-warp queue, drained after every group. The gradient stage walks the
//   winners with the lanes over p: FC1 again for h1, W2 dpre2 over the set
//   bits only, then plain += into the warp's own accumulators.
// - The blocks that share a tile of own detections take its work round
//   robin at the grain of two tests; each sums into its own slice
//   [splits, ...] and a last small kernel adds the slices of d_a and d_b in
//   order (the wrapper sums the weight partials, per block and split).
// - Two passes, each owning what it sums. The row pass (a block owns 32
//   rows and walks the columns) sums d_a, dWg, dW2 and db2; the column
//   pass (a block owns 32 columns and walks the rows) sums d_b. The
//   features are not symmetric in the two detections (g1 = (cx_j - cx_i) /
//   w_i, s_i, s_j, ...), so the column pass hands the test and the features
//   the row it walks as the row and its own column as the column. No
//   [B, NI, NC, P] partial of d_b is written, zero-filled or reduced. In
//   bf16 mode the two passes are one grid (see launch below).
// Deterministic, with no float atomics: a warp adds its winners in queue
// order, which depends only on the inputs; the four warps' sums meet in
// order; the splits' slices are added in order. Two launches give
// bit-identical gradients. d_b_j adds its rows in an order fixed by the row
// indices alone, so a permutation of the columns permutes d_b bit for bit.
//
// BF16 mode rounds the operands of the TPU backward's three bf16 dots
// (pairwise.py:462-467, :545-563): dpre2 and W2 for dh1, dpre1 and g for
// dWg, h1 and dpre2 for dW2. d_a, d_b and db2 sum unrounded f32, as the
// TPU kernel sums them (K2 differs: its d_b' sums the rounded dpre1).
// Non-BF16 mode is IEEE f32.

#include "pairwise_pair.cuh"

namespace {

using namespace gnet;
using namespace gnet::unfolded;

constexpr int QWORDS6 = 1 + GMAX;     // ring words per entry: pair, features
constexpr int WCAP = 32;              // winners of one group, at most
constexpr int WWORDS = 1 + GMAX + 2;  // (row, col), features, q mask lo/hi

template <int P, bool ROWSIDE>
__host__ __device__ constexpr size_t warp_acc_words() {
  return TILE_I * P + (ROWSIDE ? P * P + GMAX * P + P : 0);
}

template <int P, bool BF16, bool ROWSIDE>
constexpr size_t smem_words() {
  return (BF16 ? Frag<P>::W2P_WORDS : P * P)     // W2 for FC2
         + P * P                                 // W2^T for W2 dpre2
         + GMAX * P + P                          // wgs, b2s
         + NWARPS * (QCAP * QWORDS6 + WCAP * WWORDS)  // queues
         + NWARPS * warp_acc_words<P, ROWSIDE>()
         + (ROWSIDE ? 0 : ACT_WORDS);  // the column pass's tile bits
}

struct Args {
  const float *row_cols, *col_cols, *a, *b, *wg, *w2, *b2;
  const int* flags;
  const float *m, *dm;
  float *da, *db, *dwg_part, *dw2_part, *db2_part;
  int B, NR, NC, G, splits;
  float thr;
  Tile tile;  // the flags' skip tile
};

// ROWSIDE: the block owns rows [own0, own0 + 32) and walks the columns;
// writes d_a of its rows and its partials of dWg, dW2, db2.
// !ROWSIDE: the block owns 32 columns and walks the rows; writes d_b.
template <int P, bool BF16, bool ROWSIDE>
__device__ __forceinline__ void pair_pool_bwd_pass(const Args& x, int tile,
                                                   int img, int split) {
  constexpr int GROUP = group_size<BF16>();
  constexpr int PP = (P + 31) / 32;   // p values per lane in the gradient stage
  constexpr size_t ACC = warp_acc_words<P, ROWSIDE>();
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem;                                   // f32 [P][P] (in, out)
  uint32_t* w2p = reinterpret_cast<uint32_t*>(smem);   // or packed bf16
  float* w2t = smem + (BF16 ? Frag<P>::W2P_WORDS : P * P);  // [q][p]
  float* wgs = w2t + P * P;                            // [GMAX][P]
  float* b2s = wgs + GMAX * P;                         // [P]
  float* qbase = b2s + P;
  float* accbase = qbase + NWARPS * (QCAP * QWORDS6 + WCAP * WWORDS);
  unsigned* act_bits =  // [ACT_WORDS], the column pass's (!ROWSIDE)
      reinterpret_cast<unsigned*>(accbase + NWARPS * ACC);

  const int G = x.G;
  const int C = G == GMAX ? FMAX : FMAX - 1;
  const int NR = x.NR, NC = x.NC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NI = (NR + TILE_I - 1) / TILE_I;        // row blocks
  const int NFR = x.tile.rows(NR), NFC = x.tile.cols(NC);  // the flags
  const int own0 = tile * TILE_I;
  const int NOWN = ROWSIDE ? NR : NC;
  const int NOTH = ROWSIDE ? NC : NR;

  float* wq = qbase + warp * (QCAP * QWORDS6 + WCAP * WWORDS);
  int* q_ij = reinterpret_cast<int*>(wq);              // [QCAP]
  float* q_g = wq + QCAP;                              // [GMAX][QCAP]
  int* w_ij = reinterpret_cast<int*>(wq + QCAP * QWORDS6);  // [WCAP]
  float* w_g = wq + QCAP * QWORDS6 + WCAP;             // [GMAX][WCAP]
  unsigned* w_lo = reinterpret_cast<unsigned*>(w_g + GMAX * WCAP);
  unsigned* w_hi = w_lo + WCAP;
  float* own_acc = accbase + warp * ACC;               // [TILE_I][P]
  float* dw2t = own_acc + TILE_I * P;                  // [q][p]   (ROWSIDE)
  float* dwgs = dw2t + P * P;                          // [GMAX][P]
  float* db2a = dwgs + GMAX * P;                       // [P]

  if (BF16) {
    stage_w2_frags<P>(x.w2, w2p, tid, NTHREADS);
  } else {
    for (int e = tid; e < P * P; e += NTHREADS) w2s[e] = x.w2[e];
  }
  for (int e = tid; e < P * P; e += NTHREADS) {
    const int q = e / P, p = e - q * P;
    w2t[e] = BF16 ? round_bf16(x.w2[p * P + q]) : x.w2[p * P + q];
  }
  stage_small_weights<P, BF16, GMAX>(x.wg, x.b2, G, wgs, b2s, tid);
  for (int e = tid; e < (int)(NWARPS * ACC); e += NTHREADS) accbase[e] = 0.f;
  const int* fl = x.flags + (size_t)img * NFR * NFC;
  if (!ROWSIDE)
    stage_column_activity(fl, NFR, NFC, x.tile, own0, NR, act_bits, lane,
                          warp);
  __syncthreads();

  const float* own_fields =
      (ROWSIDE ? x.row_cols + (size_t)img * C * NR
               : x.col_cols + (size_t)img * C * NC);
  const float* oth_fields =
      (ROWSIDE ? x.col_cols + (size_t)img * C * NC
               : x.row_cols + (size_t)img * C * NR);
  float mine[FMAX];
  const int own = own0 + lane;
  const bool live = load_fields(own_fields, C, NOWN, own, mine);

  const float* a_img = x.a + (size_t)img * NR * P;
  const float* b_img = x.b + (size_t)img * NC * P;
  const float* m_img = x.m + (size_t)img * NR * P;
  const float* dm_img = x.dm + (size_t)img * NR * P;

  // The warp's sums of dWg[:, p] and db2[p] for this lane's p values stay
  // in registers: every winner adds to them.
  float dwg_r[GMAX][PP], db2_r[PP];
#pragma unroll
  for (int r = 0; r < PP; ++r) {
    db2_r[r] = 0.f;
#pragma unroll
    for (int k = 0; k < GMAX; ++k) dwg_r[k][r] = 0.f;
  }

  // The gradient stage: the warp's `nwin` winners in queue order, the
  // lanes over p.
  auto gradients = [&](int nwin) {
    for (int w = 0; w < nwin; ++w) {
      const int ij = w_ij[w];
      const int i = ij >> 16, j = ij & 0xffff;
      const unsigned lo = w_lo[w], hi = w_hi[w];
      float g[GMAX];
#pragma unroll
      for (int k = 0; k < GMAX; ++k) g[k] = w_g[k * WCAP + w];
      const float* ar = a_img + (size_t)i * P;
      const float* br = b_img + (size_t)j * P;
      const float* dmr = dm_img + (size_t)i * P;
      float h1v[PP], dp1[PP], dmv[PP];
#pragma unroll
      for (int r = 0; r < PP; ++r) {
        const int p = lane + 32 * r;
        h1v[r] = dp1[r] = dmv[r] = 0.f;
        if (p < P) {
          h1v[r] = h1_value<P, BF16>(__ldg(ar + p), __ldg(br + p), wgs, g, p);
          dmv[r] = __ldg(dmr + p);
        }
      }
      // dpre2 is dm at the set bits (a win implies m > 0 and dm != 0).
      auto per_bit = [&](int q) {
        float d = __shfl_sync(ALL_LANES, dmv[0], q & 31);
        if constexpr (PP > 1) {
          const float d1 = __shfl_sync(ALL_LANES, dmv[PP - 1], q & 31);
          d = q < 32 ? d : d1;
        }
        const float dr = BF16 ? round_bf16(d) : d;
#pragma unroll
        for (int r = 0; r < PP; ++r) {
          const int p = lane + 32 * r;
          if (p < P) {
            dp1[r] = fmaf(w2t[q * P + p], dr, dp1[r]);
            if (ROWSIDE) dw2t[q * P + p] = fmaf(h1v[r], dr, dw2t[q * P + p]);
          }
        }
        if (ROWSIDE && lane == (q & 31)) {
          if (q < 32) db2_r[0] += d;
          else db2_r[PP - 1] += d;
        }
      };
      for (unsigned bits = lo; bits; bits &= bits - 1) per_bit(__ffs(bits) - 1);
      if constexpr (P > 32) {
        for (unsigned bits = hi; bits; bits &= bits - 1)
          per_bit(32 + __ffs(bits) - 1);
      }
      const int ol = (ROWSIDE ? i : j) - own0;
#pragma unroll
      for (int r = 0; r < PP; ++r) {
        const int p = lane + 32 * r;
        if (p < P) {
          const float v = h1v[r] > 0.f ? dp1[r] : 0.f;
          own_acc[ol * P + p] += v;  // d_a, d_b: unrounded
          if (ROWSIDE) {
            const float vr = BF16 ? round_bf16(v) : v;  // the dot's operand
#pragma unroll
            for (int k = 0; k < GMAX; ++k)  // g[k] is 0 beyond G
              dwg_r[k][r] = fmaf(vr, g[k], dwg_r[k][r]);
          }
        }
      }
    }
    __syncwarp();
  };

  // Stage B: recompute one group of `n` queued pairs from ring slot
  // `head`, collect its winners, run their gradients.
  auto consume = [&](int head, int n) {
    int nwin = 0;
    auto push_winner = [&](bool want, int ij, int qi, unsigned lo,
                           unsigned hi) {
      const unsigned mask = __ballot_sync(ALL_LANES, want);
      if (want) {
        const int pos = nwin + __popc(mask & ((1u << lane) - 1u));
        w_ij[pos] = ij;
#pragma unroll
        for (int k = 0; k < GMAX; ++k) w_g[k * WCAP + pos] = q_g[k * QCAP + qi];
        w_lo[pos] = lo;
        w_hi[pos] = hi;
      }
      nwin += __popc(mask);
    };
    if constexpr (BF16) {
      uint32_t afr[Frag<P>::KB][4];
      int ij2[2];
      group_h1_frags<P, GMAX, false>(a_img, b_img, wgs, q_ij, q_g, head, n,
                                     lane, afr, ij2);
      float acc[Frag<P>::NB][4];
      fc2_mma<P>(afr, w2p, b2s, acc, lane);
      const int gid = lane >> 2, tig = lane & 3;
      unsigned lo[2] = {0u, 0u}, hi[2] = {0u, 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (gid + 8 * h < n) {
          const size_t off = (size_t)(ij2[h] >> 16) * P;
#pragma unroll
          for (int nb = 0; nb < Frag<P>::NB; ++nb) {
            const int q = nb * 8 + tig * 2;
            const float2 mv =
                __ldg(reinterpret_cast<const float2*>(m_img + off + q));
            const float2 dv =
                __ldg(reinterpret_cast<const float2*>(dm_img + off + q));
            const bool w0 =
                acc[nb][2 * h] == mv.x && mv.x > 0.f && dv.x != 0.f;
            const bool w1 =
                acc[nb][2 * h + 1] == mv.y && mv.y > 0.f && dv.y != 0.f;
            const unsigned bits = (w0 ? 1u : 0u) | (w1 ? 2u : 0u);
            if (q < 32) lo[h] |= bits << (q & 31);
            else hi[h] |= bits << (q & 31);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the pair's mask: OR over its quad
        lo[h] |= __shfl_xor_sync(ALL_LANES, lo[h], 1);
        lo[h] |= __shfl_xor_sync(ALL_LANES, lo[h], 2);
        if constexpr (P > 32) {
          hi[h] |= __shfl_xor_sync(ALL_LANES, hi[h], 1);
          hi[h] |= __shfl_xor_sync(ALL_LANES, hi[h], 2);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)  // slots 0..7, then 8..15: queue order
        push_winner(tig == 0 && gid + 8 * h < n && (lo[h] | hi[h]) != 0u,
                    ij2[h], (head + gid + 8 * h) & (QCAP - 1), lo[h], hi[h]);
    } else {
      float g[GMAX];
      const int ij = lane_pair(q_ij, q_g, head, n, lane, g);
      float pre[P];
      const size_t off = (size_t)(ij >> 16) * P;
      pair_pre2<P>(a_img + off, b_img + (size_t)(ij & 0xffff) * P, wgs, w2s,
                   b2s, g, pre);
      unsigned lo = 0u, hi = 0u;
      if (lane < n) {
#pragma unroll
        for (int q4 = 0; q4 < P / 4; ++q4) {
          const float4 mv =
              __ldg(reinterpret_cast<const float4*>(m_img + off) + q4);
          const float4 dv =
              __ldg(reinterpret_cast<const float4*>(dm_img + off) + q4);
          const float m4[4] = {mv.x, mv.y, mv.z, mv.w};
          const float d4[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 4 * q4 + e;
            if (pre[q] == m4[e] && m4[e] > 0.f && d4[e] != 0.f) {
              if (q < 32) lo |= 1u << q;
              else hi |= 1u << (q - 32);
            }
          }
        }
      }
      push_winner((lo | hi) != 0u, ij, (head + lane) & (QCAP - 1), lo, hi);
    }
    __syncwarp();
    gradients(nwin);
  };

  // Stage A's test of this lane's detection against detection d of the
  // other side; the row pass owns the row, the column pass the column.
  const float thr = x.thr;
  const float thr_lo = __fmul_rn(thr, 1.f - 1e-6f);
  auto test = [&](int d, float (&g)[GMAX]) {
    float other[FMAX];
    const bool valid = load_fields(oth_fields, C, NOTH, d, other);
    float iou;
    if constexpr (ROWSIDE) {
      if (!(live && valid && neighbour_test(mine, other, thr, thr_lo, iou)))
        return false;
      det_features<BF16>(mine, other, G, iou, g);
    } else {
      if (!(live && valid && neighbour_test(other, mine, thr, thr_lo, iou)))
        return false;
      det_features<BF16>(other, mine, G, iou, g);
    }
    return true;
  };
  // Whether tile t of the other side (TJ detections) can hold a neighbour
  // of this block: K2's rule (pairwise2_bwd.cu).
  const int* own_flags =
      ROWSIDE ? fl + (size_t)(own0 >> x.tile.fi_shift) * NFC : fl;
  auto active = [&](int t) {
    return ROWSIDE ? own_flags[t] != 0
                   : ((act_bits[t >> 5] >> (t & 31)) & 1u) != 0u;
  };
  stage_loop<GROUP, GMAX>(live, NOTH, split, x.splits, x.tile.tj_shift,
                          active, ROWSIDE ? own << 16 : own,
                          ROWSIDE ? 0 : 16, q_ij, q_g, lane, warp, test,
                          consume);

  // The warps' sums meet in a fixed order.
  if (ROWSIDE) {
#pragma unroll
    for (int r = 0; r < PP; ++r) {
      const int p = lane + 32 * r;
      if (p < P) {
        db2a[p] = db2_r[r];
#pragma unroll
        for (int k = 0; k < GMAX; ++k) dwgs[k * P + p] = dwg_r[k][r];
      }
    }
  }
  __syncthreads();
  // this split's slice of the output: [splits, B, N, P]
  const size_t slice = (size_t)split * x.B + img;
  float* own_out = (ROWSIDE ? x.da : x.db) + slice * NOWN * P;
  for (int e = tid; e < TILE_I * P; e += NTHREADS) {
    if (own0 + e / P >= NOWN) continue;
    float v = accbase[e];
    for (int w = 1; w < NWARPS; ++w) v += accbase[w * ACC + e];
    own_out[(size_t)own0 * P + e] = v;
  }
  if (ROWSIDE) {
    // Weight gradients: this block's partials, warps summed in order.
    const size_t blk = slice * NI + tile;
    const float* dw2t0 = accbase + TILE_I * P;
    const float* dwg0 = dw2t0 + P * P;
    const float* db20 = dwg0 + GMAX * P;
    for (int e = tid; e < P * P; e += NTHREADS) {
      const int p = e / P, q = e - p * P;
      float v = dw2t0[q * P + p];
      for (int w = 1; w < NWARPS; ++w) v += dw2t0[w * ACC + q * P + p];
      x.dw2_part[blk * P * P + e] = v;
    }
    for (int e = tid; e < G * P; e += NTHREADS) {
      float v = dwg0[e];
      for (int w = 1; w < NWARPS; ++w) v += dwg0[w * ACC + e];
      x.dwg_part[blk * G * P + e] = v;
    }
    for (int e = tid; e < P; e += NTHREADS) {
      float v = db20[e];
      for (int w = 1; w < NWARPS; ++w) v += db20[w * ACC + e];
      x.db2_part[blk * P + e] = v;
    }
  }
}

// Both passes in one grid, so that the column pass fills the
// multiprocessors the row pass's last blocks leave idle: blockIdx.x counts
// the row tiles, then the column tiles of 32.
template <int P, bool BF16>
__global__ void __launch_bounds__(NTHREADS) pair_pool_bwd_kernel(Args x) {
  const int NI = (x.NR + TILE_I - 1) / TILE_I;
  if ((int)blockIdx.x < NI)
    pair_pool_bwd_pass<P, BF16, true>(x, blockIdx.x, blockIdx.y, blockIdx.z);
  else
    pair_pool_bwd_pass<P, BF16, false>(x, blockIdx.x - NI, blockIdx.y,
                                       blockIdx.z);
}

// One pass in a grid of its own.
template <int P, bool BF16, bool ROWSIDE>
__global__ void __launch_bounds__(NTHREADS)
pair_pool_bwd_pass_kernel(Args x) {
  pair_pool_bwd_pass<P, BF16, ROWSIDE>(x, blockIdx.x, blockIdx.y,
                                       blockIdx.z);
}

template <class Kernel>
int launch_grid(Kernel kernel, const Args& x, int tiles, size_t smem_words,
                cudaStream_t stream) {
  if (tiles <= 0) return 0;
  const size_t smem = smem_words * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(tiles, x.B, x.splits), NTHREADS, smem, stream>>>(x);
  return (int)cudaGetLastError();
}

// bf16 mode runs the two passes as one grid, f32 mode one after the
// other, as K2 does (its measurements: the joint grid is 9-13% faster in
// bf16; in f32 the larger pass's register count costs the other more
// occupancy than the shared tail wins).
template <int P, bool BF16>
int launch(const Args& x, cudaStream_t stream) {
  constexpr size_t row_words = smem_words<P, BF16, true>();
  constexpr size_t col_words = smem_words<P, BF16, false>();
  const int ni = (x.NR + TILE_I - 1) / TILE_I;
  const int nc_tiles = (x.NC + TILE_I - 1) / TILE_I;
  if constexpr (BF16) {  // only the grids a mode launches are compiled
    return launch_grid(pair_pool_bwd_kernel<P, BF16>, x, ni + nc_tiles,
                       row_words > col_words ? row_words : col_words, stream);
  } else {
    const int e = launch_grid(pair_pool_bwd_pass_kernel<P, BF16, true>, x, ni,
                              row_words, stream);
    return e != 0 ? e
                  : launch_grid(pair_pool_bwd_pass_kernel<P, BF16, false>, x,
                                nc_tiles, col_words, stream);
  }
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

// Whether the kernel takes the skip tile FI x TJ (rows x columns of a flag).
int gnet_pair_pool_bwd_tiles(int fi, int tj) {
  Tile t;
  return make_tile(fi, tj, t) ? 1 : 0;
}

// Launches K6 (its row pass and its column pass) on `stream`; returns
// cudaGetLastError() (0 = launched). `splits` blocks share the work on a
// tile of own detections, each summing into its own slice. Every output is
// written in full: da [B, NR, P] and db [B, NC, P] (through the scratch
// da_part [S, B, NR, P] and db_part [S, B, NC, P], whose slices are added
// in order; unused when S = 1), and per row block of 32 (NI of them)
// dwg_part [S*B*NI, G, P], dw2_part [S*B*NI, P, P], db2_part [S*B*NI, P],
// which the caller sums. `flags` [B, ceil(NR / fi), ceil(NC / tj)] at the
// skip tile fi x tj.
int gnet_pair_pool_bwd(const float* row_cols, const float* col_cols,
                       const float* a, const float* b, const float* wg,
                       const float* w2, const float* b2, const int* flags,
                       const float* m, const float* dm, float* da, float* db,
                       float* da_part, float* db_part, float* dwg_part,
                       float* dw2_part, float* db2_part, int B, int NR,
                       int NC, int P, int G, int splits, float thr, int bf16,
                       int fi, int tj, void* stream) {
  Tile tile;
  if (!make_tile(fi, tj, tile)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || NR <= 0) return 0;
  if ((G != GMAX && G != GMAX - 1) || NC < 0 || NR > MAX_DETS ||
      NC > MAX_DETS || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const bool direct = splits == 1;
  const Args x{row_cols, col_cols, a, b, wg, w2, b2, flags, m, dm,
               direct ? da : da_part, direct ? db : db_part,
               dwg_part, dw2_part, db2_part, B, NR, NC, G, splits, thr,
               tile};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = bf16 ? dispatch_p<true>(P, x, s) : dispatch_p<false>(P, x, s);
  if (e != 0 || direct) return e;
  return sum_slices(da_part, db_part, da, db, splits, (size_t)B * NR * P,
                    (size_t)B * NC * P, s);
}

}  // extern "C"
