// K7: the per-tile ablation of the unfolded pair tile for Hopper (sm_90a):
// features once per pair, FC2 on the tensor cores.
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
// gives -1e30, not 0. Every pair goes through every stage its mode keeps
// and the mask is applied last, so two modes differ in the switched-off
// stage's work and in nothing else, whatever share of the pairs passes.
//
// Bound: operations. A pair through both products costs 2P^2 + 2GP = 2,560
// operations against ~100 input bytes per detection. FC2 (2P^2) runs on
// the tensor cores, as K1, K2, K5 and K6 run it (pair_group.cuh); FC1
// (2GP) stays an fmaf chain on the CUDA cores (see Numerics), so FC1, the
// elementwise work, the IoU and the features at the f32 rate are this
// design's floor (chip_smoke.py phase 12 logs it beside the bound).
//
// Layout: one block of 4 warps per (row tile of 32 rows, image). Warp w
// owns the 16 rows of row group w % 2 -- the slots gid and gid + 8 of
// mma.sync's fragments (Frag<32>, pair_group.cuh) -- and every other pair
// of columns of each staged column tile (columns 4k + 2 (w / 2) and the
// next). Column tiles of TJ = 32, 64 or 128 columns (a template parameter:
// the probe's TJ is a TPU block shape, this is the card's) are staged with
// cp.async into one of two buffers while the block computes on the other:
// one block barrier a tile. For each pair of columns a warp runs
//   stage A: lane l takes pair (slot l % 16, column l / 16) once: its IoU,
//     neighbour bit (a ballot) and 8 features (to the warp's slice of
//     shared memory);
//   stage B: per column, a group of 16 pairs (16 rows x 1 column). A lane
//     keeps a_i of its two slots and the Wg columns of its 8 A-fragment p
//     values in registers for the whole launch, reads b_j and its slots'
//     features, computes h1 and packs the bf16 operands straight into the
//     A fragments; fc2_mma runs FC2 as two m16n8k16 k blocks with the
//     accumulator from 0 (a zero bias array); b2 is added after.
// The running max lives in the C fragment's own registers: each of a
// lane's 16 values is one (row, q), so the loop needs no shuffle. The
// mask is a predicated max, and relu is taken once at the end (the max of
// relu(v) over the neighbours is relu of their max v). The two warps that
// split a row group's columns merge through shared memory at the end, and
// the output is written coalesced. MODE is a template parameter: a
// runtime branch would cost the stage it is meant to remove.
//
// Numerics: IoU and features are pairwise_pair.cuh's (explicitly rounded
// IEEE operations, features rounded to bf16), computed once per pair. gw
// is an fmaf chain from 0 in feature order, so h1 is the plain version's
// bit for bit (nofc2 is bit-equal). FC2 sums the same exact bf16 products
// in the tensor cores' order (two k blocks of 16) instead of the plain
// version's fmaf order: ~1e-6 on the output, inside the f32 gate. FC1 on
// the tensor cores would move gw by an f32 ulp now and then and so flip a
// bf16 h1 by a whole step; it stays on the CUDA cores.

#include "pairwise_pair.cuh"

namespace {

using namespace gnet::unfolded;
using gnet::ALL_LANES;
using gnet::Frag;
using gnet::NTHREADS;
using gnet::NWARPS;
using gnet::pack_bf16;
using gnet::round_bf16;
using gnet::TILE_I;

constexpr int P = 32;      // pairwise_dim of the probe
constexpr int G = 8;       // pair features
constexpr int C = 14;      // DetColumns fields (class-agnostic)
constexpr int PANEL = gnet::unfolded::K7_PANEL;  // column fields are
                                                 // staged in panels of 64, col()'s stride
constexpr int GROUP = 16;                        // rows of an mma tile
constexpr int ROW_GROUPS = TILE_I / GROUP;       // 2
constexpr int COL_SPLITS = NWARPS / ROW_GROUPS;  // warps per row group: 2
constexpr int PASS_COLS = 32 / GROUP;  // columns of one stage-A pass: 2
constexpr int NM = P / 8;  // a lane's p (and q) values: m * 8 + tig * 2 + e
using F = Frag<P>;
static_assert(F::KB * 2 == NM && F::NB == NM, "2 k blocks, 4 n blocks");
static_assert(G == 8, "a pair's features are two float4");

enum Mode { FULL = 0, NOFEAT, NOGW, NOFC2, NOMASK, BF3D, NMODES };

template <int TJ>
struct Smem {  // offsets in 4-byte words; every region 16-byte aligned
  static constexpr int NPANELS = (TJ + PANEL - 1) / PANEL;
  static constexpr int CS = NPANELS * FMAX * PANEL;  // one column-field tile
  static constexpr int W2P = 0;                       // [KP][LDW] bf16 pairs
  static constexpr int ZERO = W2P + F::W2P_WORDS;     // [P] fc2_mma's bias
  static constexpr int RS = ZERO + P;                 // [FMAX][TILE_I]
  static constexpr int BS = RS + FMAX * TILE_I;       // [2][TJ][P]
  static constexpr int CSO = BS + 2 * TJ * P;         // [2][CS]
  static constexpr int FS = CSO + 2 * CS;  // [NWARPS][PASS_COLS][2][GROUP]
  static constexpr int RED = FS + NWARPS * PASS_COLS * 2 * GROUP * 4;
  static constexpr int WORDS = RED + COL_SPLITS * TILE_I * (P + 1);
  static_assert(RS % 4 == 0 && BS % 4 == 0 && CSO % 4 == 0 && FS % 4 == 0,
                "16-byte copies and float4 reads");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// (lo, hi) rounded to bf16 and back: one conversion for the two.
__device__ __forceinline__ float2 round_bf16x2(float lo, float hi) {
  const uint32_t u = pack_bf16(lo, hi);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// relu of two bf16 values packed as pack_bf16 packs them.
__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
  v = __hmax2(v, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Starts the copies of column tile `col0` (b rows and the column fields in
// panels) into bs / cs; the ragged edge is written directly: zeros for b,
// the safe pad for the fields. Whole block; completes at cp.async.wait_all.
template <int TJ>
__device__ __forceinline__ void stage_tile(float* bs, float* cs,
                                           const float* __restrict__ b_img,
                                           const float* __restrict__ cc,
                                           int N, int col0, bool b_aligned,
                                           int tid) {
  const int ncol = min(TJ, N - col0);
  const float* src = b_img + (size_t)col0 * P;
  if (b_aligned) {
    for (int x = 4 * tid; x < TJ * P; x += 4 * NTHREADS) {
      if (x < ncol * P)
        cp_async16(bs + x, src + x);
      else
        *reinterpret_cast<float4*>(bs + x) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int x = tid; x < TJ * P; x += NTHREADS) {
      if (x < ncol * P)
        cp_async4(bs + x, src + x);
      else
        bs[x] = 0.f;
    }
  }
  for (int x = tid; x < Smem<TJ>::CS; x += NTHREADS) {
    const int pn = x / (FMAX * PANEL), r = x - pn * FMAX * PANEL;
    const int f = r / PANEL, t = pn * PANEL + r - f * PANEL;
    if (t >= TJ) continue;  // TJ = 32: half a panel
    if (f < C && t < ncol)
      cp_async4(cs + x, cc + (size_t)f * N + col0 + t);
    else
      cs[x] = f < C ? safe_pad(f) : 0.f;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
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
  using S = Smem<TJ>;
  extern __shared__ __align__(16) float smem[];
  const uint32_t* w2p = reinterpret_cast<const uint32_t*>(smem + S::W2P);
  const float* zero = smem + S::ZERO;
  float* rs = smem + S::RS;
  float* bs = smem + S::BS;
  float* cs = smem + S::CSO;
  float4* fs = reinterpret_cast<float4*>(smem + S::FS);
  float* red = smem + S::RED;

  constexpr bool BF = MODE == BF3D;
  constexpr bool GW = MODE != NOGW;    // features and FC1
  constexpr bool FC2 = MODE != NOFC2;
  const float NEG = BF ? round_bf16(-1e30f) : -1e30f;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % ROW_GROUPS, split = warp / ROW_GROUPS;
  const int img = blockIdx.y;
  const int row0 = blockIdx.x * TILE_I;
  const int nrow = min(TILE_I, N - row0);
  const int NJ = (N + TJ - 1) / TJ;
  const float* cc = cols + (size_t)img * C * N;
  const float* b_img = b + (size_t)img * N * P;
  const bool b_aligned = (reinterpret_cast<uintptr_t>(b) & 15) == 0;

  // Tile 0 is in flight while the block stages what it keeps.
  stage_tile<TJ>(bs, cs, b_img, cc, N, 0, b_aligned, tid);
  if (FC2)
    gnet::stage_w2_frags<P>(w2, reinterpret_cast<uint32_t*>(smem + S::W2P),
                            tid, NTHREADS);
  for (int x = tid; x < P; x += NTHREADS) smem[S::ZERO + x] = 0.f;
  stage_fields<TILE_I>(rs, cc, C, N, row0, nrow, tid, NTHREADS);

  // A lane's p values, for the whole launch: p = m * 8 + tig * 2 + e. They
  // are the A fragment's (k block m / 2, register pair m % 2) and the C
  // fragment's n block m, so h1 at (slot s, p) and pre2 at (slot s, q = p)
  // sit at the same [m][2 s + e] of a lane.
  float ar[2][NM][2];  // a_i of slots gid, gid + 8 (bf16 in bf3d)
  float wr[G][NM][2];  // Wg[k][p], bf16-rounded
  float b2r[NM][2];    // b2[q] (bf16 in bf3d)
  const float* a_img = a + (size_t)img * N * P;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = m * 8 + tig * 2 + e;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int r = row0 + rg * GROUP + gid + 8 * s;
        const float v = r < N ? __ldg(a_img + (size_t)r * P + p) : 0.f;
        ar[s][m][e] = BF ? round_bf16(v) : v;
      }
#pragma unroll
      for (int k = 0; k < G; ++k)
        wr[k][m][e] = round_bf16(__ldg(wg + k * P + p));
      b2r[m][e] = BF ? round_bf16(__ldg(b2 + p)) : __ldg(b2 + p);
    }
  }

  float mx[NM][4];  // C fragment: [n block][slot gid: 0, 1; gid + 8: 2, 3]
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[m][e] = NEG;

  // Stage A's pair for this lane: slot s_a of the row group, column c_a of
  // a pass. Rows past N (a ragged last row tile) compute on the safe pad
  // and are never written.
  const int s_a = lane % GROUP, c_a = lane / GROUP;
  const int i_a = rg * GROUP + s_a;
  float4* my_fs = fs + warp * PASS_COLS * 2 * GROUP;

  for (int t = 0; t < NJ; ++t) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // tile t is staged; every warp is done with tile t - 1
    if (t + 1 < NJ)
      stage_tile<TJ>(bs + ((t + 1) & 1) * TJ * P, cs + ((t + 1) & 1) * S::CS,
                     b_img, cc, N, (t + 1) * TJ, b_aligned, tid);
    const float* bt = bs + (t & 1) * TJ * P;
    const float* ct = cs + (t & 1) * S::CS;
    const int ncol = min(TJ, N - t * TJ);

    for (int j0 = PASS_COLS * split; j0 < ncol;
         j0 += PASS_COLS * COL_SPLITS) {
      // stage A: the IoU, the bit and the features of one pair a lane
      const int jj = j0 + c_a;  // < TJ; a column past ncol is the pad
      const float* cp = ct + (jj / PANEL) * FMAX * PANEL;
      const int jp = jj % PANEL;
      float iou;
      if (MODE == NOFEAT)
        iou = __fmul_rn(__fadd_rn(row(rs, X1, i_a), col(cp, X1, jp)), 0.001f);
      else
        iou = pair_iou(rs, i_a, cp, jp);
      const bool nb = jj < ncol && (MODE == NOMASK ||
                                    (row(rs, VALID, i_a) > 0.f &&
                                     col(cp, VALID, jp) > 0.f && iou >= thr));
      if (GW) {
        float g[GMAX];
        if (MODE == NOFEAT) {
          const float v = round_bf16(iou);
#pragma unroll
          for (int k = 0; k < G; ++k) g[k] = v;
        } else {
          pair_features<true>(rs, i_a, cp, jp, G, iou, g);
        }
        float4* f = my_fs + c_a * 2 * GROUP + s_a;
        f[0] = make_float4(g[0], g[1], g[2], g[3]);
        f[GROUP] = make_float4(g[4], g[5], g[6], g[7]);
      }
      const unsigned bits = __ballot_sync(ALL_LANES, nb);
      __syncwarp();

      // stage B: one group of 16 pairs (the row group x one column) a
      // step. A column past ncol (N odd) computes on the zero pad and has no
      // bit set, so the two steps share one block of code.
#pragma unroll
      for (int c = 0; c < PASS_COLS; ++c) {
        const float* bj = bt + (j0 + c) * P;
        float bv[NM][2];
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          const float2 v =
              *reinterpret_cast<const float2*>(bj + m * 8 + tig * 2);
          const float2 r = BF ? round_bf16x2(v.x, v.y) : v;
          bv[m][0] = r.x;
          bv[m][1] = r.y;
        }
        const bool nb2[2] = {((bits >> (c * GROUP + gid)) & 1u) != 0,
                             ((bits >> (c * GROUP + gid + 8)) & 1u) != 0};
        float g[2][G];
        if (GW) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const float4 lo = my_fs[c * 2 * GROUP + gid + 8 * s];
            const float4 hi = my_fs[c * 2 * GROUP + GROUP + gid + 8 * s];
            g[s][0] = lo.x; g[s][1] = lo.y; g[s][2] = lo.z; g[s][3] = lo.w;
            g[s][4] = hi.x; g[s][5] = hi.y; g[s][6] = hi.z; g[s][7] = hi.w;
          }
        }
        uint32_t afr[F::KB][4];  // FC2's A fragments
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int m = 0; m < NM; ++m) {
            float ab[2], gw[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              gw[e] = 0.f;
              if (GW) {
#pragma unroll
                for (int k = 0; k < G; ++k)
                  gw[e] = fmaf(wr[k][m][e], g[s][k], gw[e]);
              }
              ab[e] = __fadd_rn(ar[s][m][e], bv[m][e]);
            }
            float h[2];  // h1 before relu
            if (BF) {  // (bf16(a) + bf16(b)) + bf16(gw), each add rounded
              const float2 rab = round_bf16x2(ab[0], ab[1]);
              const float2 rgw = round_bf16x2(gw[0], gw[1]);
              h[0] = __fadd_rn(rab.x, rgw.x);  // rounded by the pack below
              h[1] = __fadd_rn(rab.y, rgw.y);
            } else {
              h[0] = GW ? __fadd_rn(ab[0], gw[0]) : ab[0];
              h[1] = GW ? __fadd_rn(ab[1], gw[1]) : ab[1];
            }
            if (FC2) {  // the dot's operand: bf16(relu(h1))
              afr[m >> 1][s + 2 * (m & 1)] =
                  relu_bf16x2(pack_bf16(h[0], h[1]));
            } else if (nb2[s]) {  // h2 = h1, f32; relu at the end
              mx[m][2 * s] = fmaxf(mx[m][2 * s], h[0]);
              mx[m][2 * s + 1] = fmaxf(mx[m][2 * s + 1], h[1]);
            }
          }
        }
        if (FC2) {
          float acc[F::NB][4];
          gnet::fc2_mma<P>(afr, w2p, zero, acc, lane);
#pragma unroll
          for (int m = 0; m < NM; ++m) {
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              float v0, v1;
              if (BF) {  // bf16(bf16(dot) + bf16(b2))
                const float2 r = round_bf16x2(acc[m][e], acc[m][e + 1]);
                const float2 v = round_bf16x2(__fadd_rn(r.x, b2r[m][0]),
                                              __fadd_rn(r.y, b2r[m][1]));
                v0 = v.x;
                v1 = v.y;
              } else {
                v0 = __fadd_rn(acc[m][e], b2r[m][0]);
                v1 = __fadd_rn(acc[m][e + 1], b2r[m][1]);
              }
              if (nb2[e >> 1]) {
                mx[m][e] = fmaxf(mx[m][e], v0);
                mx[m][e + 1] = fmaxf(mx[m][e + 1], v1);
              }
            }
          }
        }
      }
      __syncwarp();  // the features are read before the next pass writes
    }
  }

  // Merge the warps that split a row group's columns, then relu (or -1e30
  // where no column was a neighbour) and out[b, row0:row0+TILE_I, :]
  // coalesced.
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rg * GROUP + gid + 8 * (e >> 1);
      const int q = m * 8 + tig * 2 + (e & 1);
      red[(split * TILE_I + r) * (P + 1) + q] = mx[m][e];
    }
  __syncthreads();
  for (int x = tid; x < TILE_I * P; x += NTHREADS) {
    const int r = x / P, q = x - r * P;
    if (r >= nrow) continue;
    float v = red[r * (P + 1) + q];
#pragma unroll
    for (int w = 1; w < COL_SPLITS; ++w)
      v = fmaxf(v, red[(w * TILE_I + r) * (P + 1) + q]);
    out[((size_t)img * N + row0 + r) * P + q] = v == NEG ? NEG : fmaxf(v, 0.f);
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
  const size_t smem = Smem<TJ>::WORDS * sizeof(float);
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
