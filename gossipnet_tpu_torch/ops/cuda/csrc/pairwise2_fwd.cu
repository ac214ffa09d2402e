// K1: GossipNet pair-pool forward for Hopper (sm_90a).
//
// Replaces the TPU kernel gossipnet_tpu/ops/pallas/pairwise2.py::_fwd_kernel
// (launched by _forward, wrapped by pallas_pair_pool_rect_v2 / _v2).
//
// Function: for every image b and row detection i,
//   m[b,i,:] = max(0, max over columns j with IoU(i,j) >= thr, both valid, of
//                  W2^T relu(a'_i + b'_j + Wg_k^T g_ij) + b2)
//   g_ij = [iou, cx_j * inv_w_i, cy_j * inv_h_i (, cls_i == cls_j)]
// a' and b' already carry the separable pair features (fold_separable in
// ops/cuda/pairwise2.py), so only 3 (or 4) features are pairwise here.
// The [N, N, P] pair tensor never exists.
//
// Bound: operations. A neighbour pair costs 2P^2 + (K+6)P = 2.3 kFLOP at
// P=32, K=3, against a few MB of input, but only about one tested pair in
// twenty is a neighbour, so what limits a kernel on this card is how the
// sparse work is laid on warps, not the arithmetic rate. What the design
// does about it:
// - Test densely, compute compactly. Stage A: lane l owns row row0 + l,
//   the four warps split each tile of TJ columns, every lane tests one
//   (row, column) pair per step, two steps in flight, the column read
//   through L1 as a broadcast (no staging, no barrier in the loop), the
//   division of the IoU skipped where the pair is clearly below the
//   threshold, and the pairs that pass go through a ballot into the warp's
//   queue (pair_group.cuh). Stage B pops groups of 16 (bf16) or 32 (f32)
//   pairs, so FC1 and FC2 run with every lane on a real neighbour pair;
//   whole tiles whose bounding boxes do not meet are skipped through the
//   flags of tile_activity, at the skip tile FI x TJ the launch names
//   (pairwise2_pair.cuh Tile: two shifts, no instantiation of its own). a' and b' are read from device memory (L1/L2)
//   per queued pair: 5% of the pairs need them.
// - FC2 on the tensor cores in bf16 mode: mma.sync.m16n8k16 per warp on the
//   group's h1 (made directly in the A-fragment layout) and W2 packed in
//   shared memory, f32 accumulator starting at b2 (fc2_mma). mma.sync, not
//   wgmma: a P=32 product needs no 64-row tile, and a queue per warp needs
//   no synchronisation across a warpgroup. f32 mode stays on CUDA cores,
//   IEEE f32, one pair per lane, in the fmaf order of the plain version.
// - The running max by order-free merge: m >= 0, so a positive float's bits
//   order like the float, and a group's pre2 merges into the row's max in
//   shared memory with an integer atomicMax; the result is the same bits
//   in any order.
// - So the work on a row tile is also split over gridDim.z blocks, which
//   take its steps round robin and merge into the output, zero-filled by
//   the entry function, the same way. On clustered detections one tile pair can hold a thousand
//   neighbour pairs, and a warp's groups are a serial chain of loads,
//   products and merges: what the kernel's time follows is the longest
//   chain, and the fine interleave is what shortens it (measured: 2.4x at
//   B=8 N=1024, 4x at B=8 N=256 over one block per row tile). The grid then
//   fills the card at B=8 N=256 and B=2 N=4096 as at B=8 N=1024.
//
// Numerics: pairwise2_pair.cuh and pair_group.cuh, shared with K2, which
// must recompute pre2 bit for bit.
//
// The bf16 stream (mode 2, the TPU kernel's elementwise_dtype=bfloat16 on
// bf16 operands) is an instantiation of its own (EW): h1 and pre2 are
// rounded where the TPU kernel's bf16 scratch rounds them (h1_value,
// fc2_mma), so every pre2, and so every entry of m, is a bf16 value. The
// integer max stays exact: the merged values are non-negative floats.
//
// Build switches, for timing what a stage costs only (the output is wrong
// with any of them; `chip_smoke.py --k1-stages` builds and times them):
// GNET_ABLATE_STAGE_B, stage B does nothing; GNET_ABLATE_MERGE, a group's
// pre2 is not merged into the running max; GNET_ABLATE_LOADS (bf16), every
// queued pair reads a' and b' of detection 0.

#include "pairwise2_pair.cuh"

namespace {

using namespace gnet;

// Row stride of the running max: rows of one group sit in different banks.
template <int P>
constexpr int MXLD = P + 1;

template <int P, bool BF16>
constexpr size_t smem_words() {
  return (BF16 ? Frag<P>::W2P_WORDS : P * P)  // W2
         + KMAX * P + P                                   // wgs, b2s
         + TILE_I * MXLD<P>                               // running max
         + NWARPS * QCAP * QWORDS;                        // queues
}

template <int P, bool BF16, bool EW>
__global__ void __launch_bounds__(NTHREADS)
pair_pool2_fwd_kernel(const float* __restrict__ row_cols,  // [B, C, NR]
                      const float* __restrict__ col_cols,  // [B, C, NC]
                      const float* __restrict__ a,         // [B, NR, P]
                      const float* __restrict__ b,         // [B, NC, P]
                      const float* __restrict__ wg,        // [K, P]
                      const float* __restrict__ w2,        // [P, P] (in, out)
                      const float* __restrict__ b2,        // [P]
                      const int* __restrict__ flags,  // [B, NR/FI, NC/TJ]
                      float* __restrict__ out,  // [B, NR, P], 0 if split
                      int NR, int NC, int K, float thr, Tile tile) {
  static_assert(!EW || BF16, "a bf16 stream needs bf16 operands");
  constexpr int GROUP = group_size<BF16>();
  constexpr int LD = MXLD<P>;
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem;                                   // f32 [P][P]
  uint32_t* w2p = reinterpret_cast<uint32_t*>(smem);   // or packed bf16
  float* wgs = smem + (BF16 ? Frag<P>::W2P_WORDS : P * P);  // [KMAX][P]
  float* b2s = wgs + KMAX * P;                         // [P]
  int* mx = reinterpret_cast<int*>(b2s + P);           // [TILE_I][LD] bits
  int* q_ij_all = mx + TILE_I * LD;                    // [NWARPS][QCAP]
  float* q_g_all = reinterpret_cast<float*>(q_ij_all + NWARPS * QCAP);

  const int C = K == 4 ? 9 : 8;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int img = blockIdx.y;
  const int row0 = blockIdx.x * TILE_I;
  const int NFR = tile.rows(NR), NFC = tile.cols(NC);  // the flags' shape
  int* q_ij = q_ij_all + warp * QCAP;
  float* q_g = q_g_all + warp * QFEAT * QCAP;

  if (BF16) {
    stage_w2_frags<P>(w2, w2p, tid, NTHREADS);
  } else {
    for (int x = tid; x < P * P; x += NTHREADS)
      w2s[x] = w2[x];
  }
  stage_small_weights<P, BF16>(wg, b2, K, wgs, b2s, tid);
  for (int x = tid; x < TILE_I * LD; x += NTHREADS) mx[x] = 0;
  __syncthreads();

  float ri[CMAX];
  const int i = row0 + lane;
  const bool live =
      load_det(row_cols + (size_t)img * C * NR, C, NR, i, ri);

  const float* cc = col_cols + (size_t)img * C * NC;
  const float* a_img = a + (size_t)img * NR * P;
  const float* b_img = b + (size_t)img * NC * P;
  // the flag row of the block's rows: the cells of its tiles of columns
  const int* fl =
      flags + ((size_t)img * NFR + (row0 >> tile.fi_shift)) * NFC;

  // Stage B: one group of `n` queued pairs from ring slot `head`.
  auto consume = [&](int head, int n) {
#ifdef GNET_ABLATE_STAGE_B
    return;
#endif
    if constexpr (BF16) {
      uint32_t afr[Frag<P>::KB][4];
      int ij2[2];
      group_h1_frags<P, KMAX, true, EW>(a_img, b_img, wgs, q_ij, q_g, head,
                                        n, lane, afr, ij2);
      float acc[Frag<P>::NB][4];
      fc2_mma<P, EW>(afr, w2p, b2s, acc, lane);
      const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (gid + 8 * h >= n) continue;
        int* mrow = mx + ((ij2[h] >> 16) - row0) * LD;
#pragma unroll
        for (int nb = 0; nb < Frag<P>::NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[nb][2 * h + e];
            const int q = nb * 8 + tig * 2 + e;
#ifdef GNET_ABLATE_MERGE
            if (v == 1234.5f) mrow[q] = 1;  // keeps the product alive
#else
            if (v > 0.f && __float_as_int(v) > mrow[q])
              atomicMax(mrow + q, __float_as_int(v));
#endif
          }
        }
      }
    } else {
      float g[KMAX];
      const int ij = lane_pair(q_ij, q_g, head, n, lane, g);
      float pre[P];
      pair_pre2<P>(a_img + (size_t)(ij >> 16) * P,
                         b_img + (size_t)(ij & 0xffff) * P, wgs, w2s, b2s, g,
                         pre);
      if (lane < n) {
        int* mrow = mx + ((ij >> 16) - row0) * LD;
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (pre[q] > 0.f && __float_as_int(pre[q]) > mrow[q])
            atomicMax(mrow + q, __float_as_int(pre[q]));
        }
      }
    }
    __syncwarp();
  };

  auto active = [&](int tj) { return fl[tj] != 0; };
  run_stages<BF16, GROUP>(ri, live, cc, C, NC, blockIdx.z, gridDim.z,
                          tile.tj_shift, active, K, thr, i << 16, 0, q_ij,
                          q_g, lane, warp, consume);

  // The block's maxima leave: stored where it saw every column, merged
  // where the columns are split over blocks (out is zero there).
  __syncthreads();
  for (int x = tid; x < TILE_I * P; x += NTHREADS) {
    const int r = x / P;
    if (row0 + r >= NR) continue;
    const size_t idx = ((size_t)img * NR + row0) * P + x;
    const int v = mx[r * LD + x - r * P];
    if (gridDim.z == 1)
      out[idx] = __int_as_float(v);
    else if (v > 0)
      atomicMax(reinterpret_cast<int*>(out) + idx, v);
  }
}

template <int P, bool BF16, bool EW>
int launch(const float* row_cols, const float* col_cols, const float* a,
           const float* b, const float* wg, const float* w2, const float* b2,
           const int* flags, float* out, int B, int NR, int NC, int K,
           int splits, float thr, Tile tile, cudaStream_t stream) {
  const size_t smem = smem_words<P, BF16>() * sizeof(float);
  auto kernel = pair_pool2_fwd_kernel<P, BF16, EW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((NR + TILE_I - 1) / TILE_I, B, splits);
  kernel<<<grid, NTHREADS, smem, stream>>>(row_cols, col_cols, a, b, wg, w2,
                                           b2, flags, out, NR, NC, K, thr,
                                           tile);
  return (int)cudaGetLastError();
}

template <bool BF16, bool EW>
int dispatch_p(int P, const float* row_cols, const float* col_cols,
               const float* a, const float* b, const float* wg,
               const float* w2, const float* b2, const int* flags, float* out,
               int B, int NR, int NC, int K, int splits, float thr,
               Tile tile, cudaStream_t s) {
  switch (P) {
    case 8:
      return launch<8, BF16, EW>(row_cols, col_cols, a, b, wg, w2, b2, flags, out,
                             B, NR, NC, K, splits, thr, tile, s);
    case 16:
      return launch<16, BF16, EW>(row_cols, col_cols, a, b, wg, w2, b2, flags,
                              out, B, NR, NC, K, splits, thr, tile, s);
    case 32:
      return launch<32, BF16, EW>(row_cols, col_cols, a, b, wg, w2, b2, flags,
                              out, B, NR, NC, K, splits, thr, tile, s);
    case 64:
      return launch<64, BF16, EW>(row_cols, col_cols, a, b, wg, w2, b2, flags,
                              out, B, NR, NC, K, splits, thr, tile, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Whether the kernel takes the skip tile FI x TJ (rows x columns of a flag).
int gnet_pair_pool2_tiles(int fi, int tj) {
  Tile t;
  return make_tile(fi, tj, t) ? 1 : 0;
}

// Launches K1 on `stream`; returns cudaGetLastError() (0 = launched).
// `splits` blocks share the work on a row tile; with splits > 1 they merge
// into `out`, which is zero-filled here first, on the same stream. `mode`:
// 0 f32, 1 bf16 operands, 2 bf16 operands and the bf16 stream. `flags`
// [B, ceil(NR / fi), ceil(NC / tj)] at the skip tile fi x tj.
int gnet_pair_pool2_fwd(const float* row_cols, const float* col_cols,
                        const float* a, const float* b, const float* wg,
                        const float* w2, const float* b2, const int* flags,
                        float* out, int B, int NR, int NC, int P, int K,
                        int splits, float thr, int mode, int fi, int tj,
                        void* stream) {
  Tile tile;
  if (!make_tile(fi, tj, tile)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || NR <= 0) return 0;
  if ((K != 3 && K != 4) || NC < 0 || NR > MAX_DETS || NC > MAX_DETS ||
      splits < 1 || splits > 65535 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    const cudaError_t e =
        cudaMemsetAsync(out, 0, (size_t)B * NR * P * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (mode == 2)
    return dispatch_p<true, true>(P, row_cols, col_cols, a, b, wg, w2, b2,
                                  flags, out, B, NR, NC, K, splits, thr, tile,
                                  s);
  return mode ? dispatch_p<true, false>(P, row_cols, col_cols, a, b, wg, w2,
                                        b2, flags, out, B, NR, NC, K, splits,
                                        thr, tile, s)
              : dispatch_p<false, false>(P, row_cols, col_cols, a, b, wg, w2,
                                         b2, flags, out, B, NR, NC, K, splits,
                                         thr, tile, s);
}

}  // extern "C"
