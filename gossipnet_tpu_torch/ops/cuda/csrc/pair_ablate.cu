// K7: the per-tile ablation of the unfolded pair tile for Hopper (sm_90a),
// CUDA cores.
//
// Replaces the TPU kernel scripts/kernel_ablate.py::kernel (:19; launcher
// pool:77, pl.pallas_call at :78), a measuring probe: the TPU's unfolded
// pair tile (K5's function, every pair of the tile through every stage)
// with one stage switched off per mode, so that the difference of two
// modes' times is what a stage costs.
//
// Function, for every image b and row detection i (P = 32, G = 8, all dots
// with bf16 operands and f32 accumulation, as the probe's BF = True):
//   out[b,i,:] = max over ALL columns j of
//                  neighbour(i,j) ? h2(i,j) : -1e30
//   g    = the 8 pair features of ops/pair_features.py
//   gw   = Wg^T g                               (bf16 operands)
//   h1   = relu((a_i + b_j) + gw)
//   h2   = relu(W2^T h1 + b2)                   (bf16 operands)
//   neighbour = IoU(i,j) >= thr, both valid
// Modes (the probe's sys.argv[1]):
//   full    as above
//   nofeat  IoU stand-in (x1_i + x1_j) * 0.001, every feature that value;
//           the mask runs on the stand-in
//   nogw    gw = 0 (the features are then dead code, here as in the probe)
//   nofc2   h2 = h1 (f32, unrounded: no dot consumes it)
//   nomask  no mask: the max runs over every column
//   bf3d    bf16 elementwise: u1 = (bf16(a) + bf16(b)) + bf16(gw), each add
//           rounded; pre2 = bf16(dot) + bf16(b2) rounded; -1e30 as bf16
// Unlike K5: no tile skip (every tile is staged and tested, which is what
// "per tile" measures), no separable fold, and a row with no neighbour
// gives -1e30, not 0.
//
// Bound: operations. A pair through both products costs 2P^2 + 2GP = 2,560
// operations against ~100 input bytes per detection. This kernel runs the
// products on CUDA cores, densely: every pair of every tile goes through
// every stage its mode keeps, and the mask is a select applied last, as in
// the probe. So two modes differ in the switched-off stage's work and in
// nothing else, whatever share of the pairs passes the mask.
//
// Layout: one block per (row tile of 32 rows, image); lane l of every
// warp owns row row0 + l; the 4 warps split each staged column tile of TJ
// columns (TJ = 32, 64 or 128, a template parameter: the probe's TJ is a
// TPU block shape, this is the card's); running max[P] in registers. MODE
// is a template parameter: a runtime branch would cost the stage it is
// meant to remove. The probe's [P, TI, TJ] layout, its reshaped MXU dot
// and its revisited output block do not carry over.
//
// Numerics: IoU and features are pairwise_pair.cuh's (explicitly rounded
// IEEE operations, features rounded to bf16). gw is an fmaf chain from 0 in
// feature order; FC2 an fmaf chain from 0 over p ascending, b2 added after
// (the probe adds b2 to the finished dot).

#include "pairwise_pair.cuh"

namespace {

using namespace gnet::unfolded;
using gnet::fc2_accumulate;
using gnet::NTHREADS;
using gnet::NWARPS;
using gnet::round_bf16;
using gnet::TILE_I;

constexpr int P = 32;      // pairwise_dim of the probe
constexpr int G = 8;       // pair features
constexpr int C = 14;      // DetColumns fields (class-agnostic)
constexpr int PANEL = gnet::TILE_J;  // column fields are staged in panels
                                     // of 64, the stride col() reads with

enum Mode { FULL = 0, NOFEAT, NOGW, NOFC2, NOMASK, BF3D, NMODES };

template <int TJ>
constexpr size_t smem_floats() {
  constexpr size_t stage = TJ * P + ((TJ + PANEL - 1) / PANEL) * FMAX * PANEL;
  constexpr size_t red = NWARPS * TILE_I * (P + 1);
  return P * P + G * P + P + P * (TILE_I + 1) + FMAX * TILE_I +
         (stage > red ? stage : red);
}

template <int MODE, int TJ>
__global__ void __launch_bounds__(NTHREADS)
pair_ablate_kernel(const float* __restrict__ cols,  // [B, C, N]
                   const float* __restrict__ a,     // [B, N, P]
                   const float* __restrict__ b,     // [B, N, P]
                   const float* __restrict__ wg,    // [G, P]
                   const float* __restrict__ w2,    // [P, P] (in, out)
                   const float* __restrict__ b2,    // [P]
                   float* __restrict__ out,         // [B, N, P]
                   int N, float thr) {
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem;                        // [P][P], bf16-rounded
  float* wgs = w2s + P * P;                 // [G][P], bf16-rounded
  float* b2s = wgs + G * P;                 // [P]
  float* as = b2s + P;                      // [P][TILE_I + 1]
  float* rs = as + P * (TILE_I + 1);        // [FMAX][TILE_I] row fields
  float* bs = rs + FMAX * TILE_I;           // [TJ][P] column tile
  float* cs = bs + TJ * P;                  // [panels][FMAX][PANEL]
  float* red = bs;                          // [NWARPS][TILE_I][P + 1], after the loop

  constexpr bool BF = MODE == BF3D;
  constexpr int NPANELS = (TJ + PANEL - 1) / PANEL;
  const float NEG = BF ? round_bf16(-1e30f) : -1e30f;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int img = blockIdx.y;
  const int row0 = blockIdx.x * TILE_I;
  const int nrow = min(TILE_I, N - row0);
  const int NJ = (N + TJ - 1) / TJ;

  for (int x = tid; x < P * P; x += NTHREADS) w2s[x] = round_bf16(w2[x]);
  for (int x = tid; x < G * P; x += NTHREADS) wgs[x] = round_bf16(wg[x]);
  for (int x = tid; x < P; x += NTHREADS)
    b2s[x] = BF ? round_bf16(b2[x]) : b2[x];
  const float* a_img = a + (size_t)img * N * P;
  for (int x = tid; x < TILE_I * P; x += NTHREADS) {
    const int r = x / P, p = x - r * P;
    const float v = r < nrow ? a_img[(size_t)(row0 + r) * P + p] : 0.f;
    as[p * (TILE_I + 1) + r] = BF ? round_bf16(v) : v;
  }
  const float* cc = cols + (size_t)img * C * N;
  stage_fields<TILE_I>(rs, cc, C, N, row0, nrow, tid, NTHREADS);
  __syncthreads();
  // Only the padding lanes of a ragged last row tile sit out; an invalid
  // row is computed like any other and masked.
  const bool live = lane < nrow;
  const bool row_ok = MODE == NOMASK || row(rs, VALID, lane) > 0.f;

  float mx[P];
#pragma unroll
  for (int q = 0; q < P; ++q) mx[q] = NEG;

  const float* b_img = b + (size_t)img * N * P;

  for (int tj = 0; tj < NJ; ++tj) {
    const int col0 = tj * TJ;
    const int ncol = min(TJ, N - col0);
    __syncthreads();  // the previous tile's readers are done
    for (int x = tid; x < TJ * P; x += NTHREADS) {
      const float v = x < ncol * P ? b_img[(size_t)col0 * P + x] : 0.f;
      bs[x] = BF ? round_bf16(v) : v;
    }
#pragma unroll
    for (int pn = 0; pn < NPANELS; ++pn)
      stage_fields<PANEL>(cs + pn * FMAX * PANEL, cc, C, N, col0 + pn * PANEL,
                          max(0, min(PANEL, ncol - pn * PANEL)), tid,
                          NTHREADS);
    __syncthreads();
    if (!live) continue;

    for (int j = warp; j < ncol; j += NWARPS) {
      const float* cp = cs + (j / PANEL) * FMAX * PANEL;  // this column's panel
      const int jp = j % PANEL;
      float iou;
      if (MODE == NOFEAT)
        iou = __fmul_rn(__fadd_rn(row(rs, X1, lane), col(cp, X1, jp)), 0.001f);
      else
        iou = pair_iou(rs, lane, cp, jp);
      const bool nb = MODE == NOMASK ||
                      (row_ok && col(cp, VALID, jp) > 0.f && iou >= thr);

      float g[GMAX];
      if (MODE == NOFEAT) {
        const float v = round_bf16(iou);
#pragma unroll
        for (int k = 0; k < G; ++k) g[k] = v;
      } else if (MODE != NOGW) {
        pair_features<true>(rs, lane, cp, jp, G, iou, g);
      }

      const float* bj = bs + j * P;
      float pre[P];
      if (MODE != NOFC2) {
#pragma unroll
        for (int q = 0; q < P; ++q) pre[q] = 0.f;
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float gw = 0.f;
        if (MODE != NOGW) {
#pragma unroll
          for (int k = 0; k < G; ++k) gw = fmaf(wgs[k * P + p], g[k], gw);
        }
        const float ab = __fadd_rn(as[p * (TILE_I + 1) + lane], bj[p]);
        float h;
        if (BF)  // (bf16(a) + bf16(b)) + bf16(gw), each add rounded
          h = round_bf16(__fadd_rn(round_bf16(ab), round_bf16(gw)));
        else
          h = __fadd_rn(ab, gw);
        h = fmaxf(h, 0.f);
        if (MODE == NOFC2) {
          pre[p] = h;
        } else {
          if (!BF) h = round_bf16(h);  // the FC2 dot's operand
          fc2_accumulate<P>(h, w2s, p, pre);
        }
      }
      if (MODE != NOFC2) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float v = BF ? round_bf16(__fadd_rn(round_bf16(pre[q]), b2s[q]))
                             : __fadd_rn(pre[q], b2s[q]);
          pre[q] = fmaxf(v, 0.f);
        }
      }
      // The mask comes last and is a select, not a branch around the work.
#pragma unroll
      for (int q = 0; q < P; ++q) mx[q] = fmaxf(mx[q], nb ? pre[q] : NEG);
    }
  }

  // Max over the warps, then out[b, row0:row0+TILE_I, :] coalesced.
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
    out[((size_t)img * N + row0 + r) * P + p] = v;
  }
}

struct Args {
  const float *cols, *a, *b, *wg, *w2, *b2;
  float* out;
  int B, N;
  float thr;
};

template <int MODE, int TJ>
int launch(const Args& x, cudaStream_t stream) {
  const size_t smem = smem_floats<TJ>() * sizeof(float);
  auto kernel = pair_ablate_kernel<MODE, TJ>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((x.N + TILE_I - 1) / TILE_I, x.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(x.cols, x.a, x.b, x.wg, x.w2, x.b2,
                                           x.out, x.N, x.thr);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch_tj(int tile_j, const Args& x, cudaStream_t s) {
  switch (tile_j) {
    case 32: return launch<MODE, 32>(x, s);
    case 64: return launch<MODE, 64>(x, s);
    case 128: return launch<MODE, 128>(x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// What the library was built for: TILE_I * 1000000 + P * 1000 + NMODES.
int gnet_pair_ablate_shape() { return TILE_I * 1000000 + P * 1000 + NMODES; }

// Launches K7 on `stream`; returns cudaGetLastError() (0 = launched).
// cols is stacked DetColumns [B, 14, N]; mode indexes full, nofeat, nogw,
// nofc2, nomask, bf3d; tile_j is 32, 64 or 128.
int gnet_pair_ablate(const float* cols, const float* a, const float* b,
                     const float* wg, const float* w2, const float* b2,
                     float* out, int B, int N, int mode, int tile_j, float thr,
                     void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const Args x{cols, a, b, wg, w2, b2, out, B, N, thr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case FULL: return dispatch_tj<FULL>(tile_j, x, s);
    case NOFEAT: return dispatch_tj<NOFEAT>(tile_j, x, s);
    case NOGW: return dispatch_tj<NOGW>(tile_j, x, s);
    case NOFC2: return dispatch_tj<NOFC2>(tile_j, x, s);
    case NOMASK: return dispatch_tj<NOMASK>(tile_j, x, s);
    case BF3D: return dispatch_tj<BF3D>(tile_j, x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
