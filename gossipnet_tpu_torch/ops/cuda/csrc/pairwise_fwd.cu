// K5: the unfolded GossipNet pair-pool forward for Hopper (sm_90a), CUDA
// cores.
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
// tensor never exists: each thread streams its row over the columns and
// keeps a running max.
//
// Bound at the serving shapes: compute. A neighbour pair costs ~P^2 +
// (G + 2)P FMAs (FC2 dominates at P = 32) plus the feature arithmetic (two
// IEEE divisions among ~10 operations), against a few MB of input. This
// first version runs both products on CUDA cores; it does less than the
// dense count because it skips (a) whole tiles whose row and column
// bounding boxes do not meet (flags from pairwise2.tile_activity at this
// tile shape) and (b) per thread, every pair that is not a neighbour.
// mma/wgmma on FC2 is later work.
//
// Layout: K1's (pairwise2_fwd.cu). One block per (row tile of TILE_I = 32
// rows, image); lane l of every warp owns row row0 + l; the NWARPS warps
// split each staged column tile of TILE_J columns, so the lanes of a warp
// read the same column (a shared-memory broadcast). The row tile's fields
// and a, the weights and the column tile live in shared memory; the
// running max[P] and the FC2 accumulators in registers. The TPU kernel's
// [P, TI, TJ] layout, its kron-packed weights (`packed`, a TPU-only MXU
// option) and the hoisted row broadcast do not carry over.
//
// Numerics: the per-pair arithmetic is pairwise_pair.cuh's, shared with
// K6. BF16 mode rounds g, Wg, h1 and W2 and accumulates in f32; a, b and
// b2 stay f32. Non-BF16 mode is IEEE f32.

#include "pairwise_pair.cuh"

namespace {

using namespace gnet::unfolded;
using gnet::NTHREADS;
using gnet::NWARPS;
using gnet::round_bf16;
using gnet::TILE_I;
using gnet::TILE_J;

template <int P>
constexpr size_t smem_floats() {
  constexpr size_t stage = TILE_J * P + FMAX * TILE_J;
  constexpr size_t red = NWARPS * TILE_I * (P + 1);
  return P * P + GMAX * P + P + P * (TILE_I + 1) + FMAX * TILE_I +
         (stage > red ? stage : red);
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
                     const int* __restrict__ flags,       // [B, NI, NJ]
                     float* __restrict__ out,             // [B, NR, P]
                     int NR, int NC, int G, float thr) {
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem;                        // [P][P]
  float* wgs = w2s + P * P;                 // [GMAX][P], rows >= G zero
  float* b2s = wgs + GMAX * P;              // [P]
  float* as = b2s + P;                      // [P][TILE_I + 1]
  float* rs = as + P * (TILE_I + 1);        // [FMAX][TILE_I] row fields
  float* bs = rs + FMAX * TILE_I;           // [TILE_J][P]    column tile
  float* cs = bs + TILE_J * P;              // [FMAX][TILE_J] column tile
  float* red = bs;                          // [NWARPS][TILE_I][P + 1], after the loop

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
  const float* a_img = a + (size_t)img * NR * P;
  for (int x = tid; x < TILE_I * P; x += NTHREADS) {
    const int r = x / P, p = x - r * P;
    as[p * (TILE_I + 1) + r] = r < nrow ? a_img[(size_t)(row0 + r) * P + p]
                                        : 0.f;
  }
  stage_fields<TILE_I>(rs, row_cols + (size_t)img * C * NR, C, NR, row0,
                       nrow, tid, NTHREADS);
  __syncthreads();
  const bool live = lane < nrow && row(rs, VALID, lane) > 0.f;

  float mx[P];
#pragma unroll
  for (int q = 0; q < P; ++q) mx[q] = 0.f;

  const float* cc = col_cols + (size_t)img * C * NC;
  const float* b_img = b + (size_t)img * NC * P;
  const int* fl = flags + ((size_t)img * NI + tile_i) * NJ;

  for (int tj = 0; tj < NJ; ++tj) {
    if (fl[tj] == 0) continue;  // the same for the whole block
    const int col0 = tj * TILE_J;
    const int ncol = min(TILE_J, NC - col0);
    __syncthreads();  // the previous tile's readers are done
    for (int x = tid; x < TILE_J * P; x += NTHREADS)
      bs[x] = x < ncol * P ? b_img[(size_t)col0 * P + x] : 0.f;
    stage_fields<TILE_J>(cs, cc, C, NC, col0, ncol, tid, NTHREADS);
    __syncthreads();
    if (!live) continue;

    for (int j = warp; j < ncol; j += NWARPS) {
      const float iou = pair_iou(rs, lane, cs, j);
      if (!(col(cs, VALID, j) > 0.f && iou >= thr)) continue;

      float g[GMAX];
      pair_features<BF16>(rs, lane, cs, j, G, iou, g);
      float pre[P];
      pair_pre2<P, BF16, false>(as + lane, bs + j * P, wgs, w2s, b2s, g, pre,
                                pre);
#pragma unroll
      for (int q = 0; q < P; ++q) mx[q] = fmaxf(mx[q], pre[q]);
    }
  }

  // Max over the warps: each writes its rows' maxima, then the block
  // writes out[b, row0:row0+TILE_I, :] coalesced.
  __syncthreads();
  float* mine = red + (size_t)(warp * TILE_I + lane) * (P + 1);
#pragma unroll
  for (int q = 0; q < P; ++q) mine[q] = mx[q];
  __syncthreads();
  for (int x = tid; x < TILE_I * P; x += NTHREADS) {
    const int r = x / P, p = x - r * P;
    if (r >= nrow) continue;
    float v = red[(size_t)r * (P + 1) + p];
    for (int w = 1; w < NWARPS; ++w)
      v = fmaxf(v, red[(size_t)(w * TILE_I + r) * (P + 1) + p]);
    out[((size_t)img * NR + row0 + r) * P + p] = v;
  }
}

struct Args {
  const float *row_cols, *col_cols, *a, *b, *wg, *w2, *b2;
  const int* flags;
  float* out;
  int B, NR, NC, G;
  float thr;
};

template <int P, bool BF16>
int launch(const Args& x, cudaStream_t stream) {
  const size_t smem = smem_floats<P>() * sizeof(float);
  auto kernel = pair_pool_fwd_kernel<P, BF16>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((x.NR + TILE_I - 1) / TILE_I, x.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(x.row_cols, x.col_cols, x.a, x.b,
                                           x.wg, x.w2, x.b2, x.flags, x.out,
                                           x.NR, x.NC, x.G, x.thr);
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
int gnet_pair_pool_tiles() { return TILE_I * 1000 + TILE_J; }

// Launches K5 on `stream`; returns cudaGetLastError() (0 = launched).
// row_cols / col_cols are stacked DetColumns [B, 14, N], with the class
// appended as field 14 when G = 9.
int gnet_pair_pool_fwd(const float* row_cols, const float* col_cols,
                       const float* a, const float* b, const float* wg,
                       const float* w2, const float* b2, const int* flags,
                       float* out, int B, int NR, int NC, int P, int G,
                       float thr, int bf16, void* stream) {
  if (B <= 0 || NR <= 0) return 0;
  if ((G != GMAX && G != GMAX - 1) || NC < 0)
    return (int)cudaErrorInvalidValue;
  const Args x{row_cols, col_cols, a, b, wg, w2, b2, flags, out,
               B,        NR,       NC, G, thr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_p<true>(P, x, s) : dispatch_p<false>(P, x, s);
}

}  // extern "C"
