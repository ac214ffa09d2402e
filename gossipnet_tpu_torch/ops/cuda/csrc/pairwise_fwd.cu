// K5: the unfolded GossipNet pair-pool forward for Hopper (sm_90a).
//
// Replaces the TPU kernel gossipnet_tpu/ops/pallas/pairwise.py::_fwd_kernel
// (:314; tile math _tile_forward:147, launcher _forward:388, wrappers
// pallas_pair_pool_rect:707 / pallas_pair_pool:795), the model's
// `pair_kernel: 1` and the reference's independent oracle for K1.
//
// Function: for every image b and row detection i,
//   m[b,i,:] = max(0, max over columns j with IoU(i,j) >= thr, both valid, of
//                  W2^T relu(a_i + b_j + Wg^T g_ij) + b2)
// with all G = 8 pair features g_ij (9 with the class match) computed per
// pair from the stacked DetColumns (pairwise_pair.cuh). Nothing is folded:
// a = r Wa + b1 and b = r Wb come in as they are. The [N, N, P] pair
// tensor never exists.
//
// Bound: operations. A neighbour pair costs 2P^2 + 2GP + 4P operations and
// its features (two IEEE divisions among ten), against a few MB of input;
// only about one tested pair in twenty is a neighbour, so what limits the
// kernel on this card is how the sparse work is laid on warps. The design
// is K1's (pairwise2_fwd.cu), on the same queue and product:
// - Stage A: lane l owns row row0 + l and holds its fields in registers;
//   the four warps split each tile of TJ columns, every lane tests one
//   (row, column) pair per step, two steps in flight, the column's fields
//   read through L1 as a broadcast, the division of the IoU skipped where
//   the pair is clearly below the threshold (neighbour_test). A pair that
//   passes gets its nine features there, once, and goes with them into
//   the warp's ring (an entry is the packed pair and nine features: ten
//   words, 20 KB for the four rings). Whole tiles whose bounding boxes do
//   not meet are skipped through the flags of tile_activity, at the skip
//   tile FI x TJ the launch names (pairwise2_pair.cuh Tile).
// - Stage B pops groups of 16 (bf16) or 32 (f32) pairs, so FC1 and FC2 run
//   with every lane on a real neighbour pair. bf16: h1 made directly in the
//   A-fragment layout (the nine-feature fmaf chain, b in f32) and FC2 on
//   the tensor cores by fc2_mma (pair_group.cuh), f32 accumulator starting
//   at b2. f32: one pair per lane, FC2 on CUDA cores in the plain version's
//   fmaf order (pair_pre2), no TF32.
// - The running max by order-free merge: m >= 0, so a positive float's bits
//   order like the float, and a group's pre2 merges into the row's max in
//   shared memory with an integer atomicMax. So the work on a row tile is
//   split over gridDim.z blocks (col_splits in ops/cuda/launch.py), which
//   take its steps round robin and merge into the output, zero-filled by
//   the entry function, the same way: the bits do not depend on the order.
//
// Numerics: the fields, test and features of pairwise_pair.cuh, FC1 and FC2
// of pairwise2_pair.cuh / pair_group.cuh, all shared with K6, which must
// recompute pre2 bit for bit. BF16 mode rounds g, Wg, h1 and W2 and
// accumulates in f32; a, b and b2 stay f32. Non-BF16 mode is IEEE f32.

#include "pairwise_pair.cuh"

namespace {

using namespace gnet;
using namespace gnet::unfolded;

constexpr int QWORDS5 = 1 + GMAX;  // ring words per entry: pair, features

// Row stride of the running max: rows of one group sit in different banks.
template <int P>
constexpr int MXLD = P + 1;

template <int P, bool BF16>
constexpr size_t smem_words() {
  return (BF16 ? Frag<P>::W2P_WORDS : P * P)  // W2
         + GMAX * P + P                       // wgs, b2s
         + TILE_I * MXLD<P>                   // running max
         + NWARPS * QCAP * QWORDS5;           // queues
}

template <int P, bool BF16>
__global__ void __launch_bounds__(NTHREADS)
pair_pool_fwd_kernel(const float* __restrict__ row_cols,  // [B, C, NR]
                     const float* __restrict__ col_cols,  // [B, C, NC]
                     const float* __restrict__ a,         // [B, NR, P]
                     const float* __restrict__ b,         // [B, NC, P]
                     const float* __restrict__ wg,        // [G, P]
                     const float* __restrict__ w2,        // [P, P] (in, out)
                     const float* __restrict__ b2,        // [P]
                     const int* __restrict__ flags,  // [B, NR/FI, NC/TJ]
                     float* __restrict__ out,  // [B, NR, P], 0 if split
                     int NR, int NC, int G, float thr, Tile tile) {
  constexpr int GROUP = group_size<BF16>();
  constexpr int LD = MXLD<P>;
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem;                                   // f32 [P][P]
  uint32_t* w2p = reinterpret_cast<uint32_t*>(smem);   // or packed bf16
  float* wgs = smem + (BF16 ? Frag<P>::W2P_WORDS : P * P);  // [GMAX][P]
  float* b2s = wgs + GMAX * P;                         // [P]
  int* mx = reinterpret_cast<int*>(b2s + P);           // [TILE_I][LD] bits
  int* q_ij_all = mx + TILE_I * LD;                    // [NWARPS][QCAP]
  float* q_g_all = reinterpret_cast<float*>(q_ij_all + NWARPS * QCAP);

  const int C = G == GMAX ? FMAX : FMAX - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int img = blockIdx.y;
  const int row0 = blockIdx.x * TILE_I;
  const int NFR = tile.rows(NR), NFC = tile.cols(NC);  // the flags' shape
  int* q_ij = q_ij_all + warp * QCAP;
  float* q_g = q_g_all + warp * GMAX * QCAP;           // [GMAX][QCAP]

  if (BF16) {
    stage_w2_frags<P>(w2, w2p, tid, NTHREADS);
  } else {
    for (int x = tid; x < P * P; x += NTHREADS) w2s[x] = w2[x];
  }
  stage_small_weights<P, BF16, GMAX>(wg, b2, G, wgs, b2s, tid);
  for (int x = tid; x < TILE_I * LD; x += NTHREADS) mx[x] = 0;
  __syncthreads();

  float ri[FMAX];
  const int i = row0 + lane;
  const bool live = load_fields(row_cols + (size_t)img * C * NR, C, NR, i, ri);

  const float* cc = col_cols + (size_t)img * C * NC;
  const float* a_img = a + (size_t)img * NR * P;
  const float* b_img = b + (size_t)img * NC * P;
  // the flag row of the block's rows: the cells of its tiles of columns
  const int* fl =
      flags + ((size_t)img * NFR + (row0 >> tile.fi_shift)) * NFC;

  // Stage B: one group of `n` queued pairs from ring slot `head`.
  auto consume = [&](int head, int n) {
    if constexpr (BF16) {
      uint32_t afr[Frag<P>::KB][4];
      int ij2[2];
      group_h1_frags<P, GMAX, false>(a_img, b_img, wgs, q_ij, q_g, head, n,
                                     lane, afr, ij2);
      float acc[Frag<P>::NB][4];
      fc2_mma<P>(afr, w2p, b2s, acc, lane);
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
            if (v > 0.f && __float_as_int(v) > mrow[q])
              atomicMax(mrow + q, __float_as_int(v));
          }
        }
      }
    } else {
      float g[GMAX];
      const int ij = lane_pair(q_ij, q_g, head, n, lane, g);
      float pre[P];
      pair_pre2<P>(a_img + (size_t)(ij >> 16) * P,
                   b_img + (size_t)(ij & 0xffff) * P, wgs, w2s, b2s, g, pre);
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

  // Stage A's test of this lane's row against column j.
  const float thr_lo = __fmul_rn(thr, 1.f - 1e-6f);
  auto test = [&](int j, float (&g)[GMAX]) {
    float cj[FMAX];
    const bool valid = load_fields(cc, C, NC, j, cj);
    float iou;
    if (live && valid && neighbour_test(ri, cj, thr, thr_lo, iou)) {
      det_features<BF16>(ri, cj, G, iou, g);
      return true;
    }
    return false;
  };
  auto active = [&](int tj) { return fl[tj] != 0; };
  stage_loop<GROUP, GMAX>(live, NC, blockIdx.z, gridDim.z, tile.tj_shift,
                          active, i << 16, 0, q_ij, q_g, lane, warp, test,
                          consume);

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

struct Args {
  const float *row_cols, *col_cols, *a, *b, *wg, *w2, *b2;
  const int* flags;
  float* out;
  int B, NR, NC, G, splits;
  float thr;
  Tile tile;  // the flags' skip tile
};

template <int P, bool BF16>
int launch(const Args& x, cudaStream_t stream) {
  const size_t smem = smem_words<P, BF16>() * sizeof(float);
  auto kernel = pair_pool_fwd_kernel<P, BF16>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((x.NR + TILE_I - 1) / TILE_I, x.B, x.splits);
  kernel<<<grid, NTHREADS, smem, stream>>>(x.row_cols, x.col_cols, x.a, x.b,
                                           x.wg, x.w2, x.b2, x.flags, x.out,
                                           x.NR, x.NC, x.G, x.thr,
                                           x.tile);
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

// Whether the kernel takes the skip tile FI x TJ (rows x columns of a flag).
int gnet_pair_pool_tiles(int fi, int tj) {
  Tile t;
  return make_tile(fi, tj, t) ? 1 : 0;
}

// Launches K5 on `stream`; returns cudaGetLastError() (0 = launched).
// row_cols / col_cols are stacked DetColumns [B, 14, N], with the class
// appended as field 14 when G = 9. `splits` blocks share the work on a row
// tile; with splits > 1 they merge into `out`, which is zero-filled here
// first, on the same stream. `flags` [B, ceil(NR / fi), ceil(NC / tj)] at
// the skip tile fi x tj.
int gnet_pair_pool_fwd(const float* row_cols, const float* col_cols,
                       const float* a, const float* b, const float* wg,
                       const float* w2, const float* b2, const int* flags,
                       float* out, int B, int NR, int NC, int P, int G,
                       int splits, float thr, int bf16, int fi, int tj,
                       void* stream) {
  Tile tile;
  if (!make_tile(fi, tj, tile)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || NR <= 0) return 0;
  if ((G != GMAX && G != GMAX - 1) || NC < 0 || NR > MAX_DETS ||
      NC > MAX_DETS || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    const cudaError_t e =
        cudaMemsetAsync(out, 0, (size_t)B * NR * P * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
  }
  const Args x{row_cols, col_cols, a, b, wg, w2, b2, flags, out,
               B,        NR,       NC, G, splits, thr, tile};
  return bf16 ? dispatch_p<true>(P, x, s) : dispatch_p<false>(P, x, s);
}

}  // extern "C"
