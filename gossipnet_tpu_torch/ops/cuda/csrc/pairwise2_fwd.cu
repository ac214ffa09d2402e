// K1: GossipNet pair-pool forward for Hopper (sm_90a), CUDA cores.
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
// The [N, N, P] pair tensor never exists: each thread streams its row over
// the columns and keeps a running max.
//
// Bound at the serving shapes: compute. The JAX cost model
// (pairwise2.py:643-647) counts 2P^2 + (K+6)P = 2.3 kFLOP per pair at
// P=32, K=3: 19.6 GFLOP for a dense B=8 N=1024 launch, against about
// 4.7 MB of input. This first version runs both products on CUDA cores
// (FMA, no tensor cores): a neighbour pair costs ~P^2 + (K+2)P FMAs. It
// does less than the dense count says, because it skips (a) whole tiles
// whose row and column bounding boxes do not meet (flags from
// tile_activity) and (b) per thread, every pair that is not a neighbour.
// mma/wgmma on the FC2 product is later work.
//
// Layout: one block per (row tile of TILE_I = 32 rows, image). Lane l of
// every warp owns row row0 + l; the NWARPS warps split each staged column
// tile of TILE_J columns, so the lanes of a warp read the same column (a
// shared-memory broadcast) and differ only in their row. Per thread: the
// running max[P] and the FC2 accumulators in registers; a' of the tile,
// the weights and the column tile in shared memory. At the end the
// per-warp maxima meet through shared memory.
//
// Numerics: the IoU and the neighbour predicate use explicitly rounded
// operations (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so no FMA
// contraction can move a pair across the threshold: the plain PyTorch
// version makes the same neighbour decisions bit for bit. BF16 mode rounds
// what the TPU kernel feeds its bf16 dots (features g, b', Wg_k, h1, W2) and
// accumulates in f32; a' and b2 stay f32. Non-BF16 mode is IEEE f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE_I = 32;  // rows per block: one per lane
constexpr int TILE_J = 64;  // columns staged per step
constexpr int NWARPS = 4;   // warps sharing one column tile
constexpr int NTHREADS = 32 * NWARPS;
constexpr int KMAX = 4;     // pair features kept in the kernel
constexpr int CMAX = 9;     // fields per detection column (8, +1 class)
constexpr float EPS = 1e-6f;

// Row fields: x1 y1 x2 y2 area inv_w inv_h valid [cls]
// Col fields: x1 y1 x2 y2 area cx   cy    valid [cls]

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int P>
constexpr size_t smem_floats() {
  constexpr size_t stage = TILE_J * P + CMAX * TILE_J;
  constexpr size_t red = NWARPS * TILE_I * (P + 1);
  return P * P + KMAX * P + P + P * (TILE_I + 1) + (stage > red ? stage : red);
}

template <int P, bool BF16>
__global__ void __launch_bounds__(NTHREADS)
pair_pool2_fwd_kernel(const float* __restrict__ row_cols,  // [B, C, NR]
                      const float* __restrict__ col_cols,  // [B, C, NC]
                      const float* __restrict__ a,         // [B, NR, P]
                      const float* __restrict__ b,         // [B, NC, P]
                      const float* __restrict__ wg,        // [K, P]
                      const float* __restrict__ w2,        // [P, P] (in, out)
                      const float* __restrict__ b2,        // [P]
                      const int* __restrict__ flags,       // [B, NI, NJ]
                      float* __restrict__ out,             // [B, NR, P]
                      int NR, int NC, int K, float thr) {
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem;                        // [P][P]
  float* wgs = w2s + P * P;                 // [KMAX][P], rows >= K zero
  float* b2s = wgs + KMAX * P;              // [P]
  float* as = b2s + P;                      // [P][TILE_I + 1]
  float* bs = as + P * (TILE_I + 1);        // [TILE_J][P]   column tile
  float* cs = bs + TILE_J * P;              // [CMAX][TILE_J] column tile
  float* red = bs;                          // [NWARPS][TILE_I][P + 1], after the loop

  const int C = K == 4 ? 9 : 8;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int img = blockIdx.y;
  const int tile_i = blockIdx.x;
  const int NI = (NR + TILE_I - 1) / TILE_I;
  const int NJ = (NC + TILE_J - 1) / TILE_J;
  const int row0 = tile_i * TILE_I;

  for (int x = tid; x < P * P; x += NTHREADS)
    w2s[x] = BF16 ? round_bf16(w2[x]) : w2[x];
  for (int x = tid; x < KMAX * P; x += NTHREADS) {
    const float v = x < K * P ? wg[x] : 0.f;
    wgs[x] = BF16 ? round_bf16(v) : v;
  }
  for (int x = tid; x < P; x += NTHREADS) b2s[x] = b2[x];
  const float* a_img = a + (size_t)img * NR * P;
  for (int x = tid; x < TILE_I * P; x += NTHREADS) {
    const int r = x / P, p = x - r * P;
    as[p * (TILE_I + 1) + r] =
        row0 + r < NR ? a_img[(size_t)(row0 + r) * P + p] : 0.f;
  }

  // This thread's row.
  const int i = row0 + lane;
  float ri[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) ri[c] = 0.f;
  if (i < NR) {
    const float* rc = row_cols + (size_t)img * C * NR + i;
#pragma unroll
    for (int c = 0; c < CMAX; ++c)  // unrolled: ri stays in registers
      if (c < C) ri[c] = rc[(size_t)c * NR];
  }
  const bool live = i < NR && ri[7] > 0.f;

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
    for (int x = tid; x < TILE_J * P; x += NTHREADS) {
      const float v = x < ncol * P ? b_img[(size_t)col0 * P + x] : 0.f;
      bs[x] = BF16 ? round_bf16(v) : v;
    }
    for (int x = tid; x < CMAX * TILE_J; x += NTHREADS) {
      const int c = x / TILE_J, j = x - c * TILE_J;
      cs[x] = c < C && j < ncol ? cc[(size_t)c * NC + col0 + j] : 0.f;
    }
    __syncthreads();
    if (!live) continue;

    for (int j = warp; j < ncol; j += NWARPS) {
      const float jvalid = cs[7 * TILE_J + j];
      const float iw = fmaxf(__fsub_rn(fminf(ri[2], cs[2 * TILE_J + j]),
                                       fmaxf(ri[0], cs[0 * TILE_J + j])), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(ri[3], cs[3 * TILE_J + j]),
                                       fmaxf(ri[1], cs[1 * TILE_J + j])), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(ri[4], cs[4 * TILE_J + j]), inter);
      const float iou = __fdiv_rn(inter, fmaxf(uni, EPS));
      if (!(jvalid > 0.f && iou >= thr)) continue;

      float g0 = iou;
      float g1 = __fmul_rn(cs[5 * TILE_J + j], ri[5]);
      float g2 = __fmul_rn(cs[6 * TILE_J + j], ri[6]);
      float g3 = (K == 4 && ri[8] == cs[8 * TILE_J + j]) ? 1.f : 0.f;
      if (BF16) {
        g0 = round_bf16(g0);
        g1 = round_bf16(g1);
        g2 = round_bf16(g2);
      }
      const float* bj = bs + j * P;
      float pre[P];
#pragma unroll
      for (int q = 0; q < P; ++q) pre[q] = b2s[q];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        float h = bj[p];
        h = fmaf(wgs[0 * P + p], g0, h);
        h = fmaf(wgs[1 * P + p], g1, h);
        h = fmaf(wgs[2 * P + p], g2, h);
        h = fmaf(wgs[3 * P + p], g3, h);  // row 3 is zero when K == 3
        h = fmaxf(as[p * (TILE_I + 1) + lane] + h, 0.f);
        if (BF16) h = round_bf16(h);
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
    if (row0 + r >= NR) continue;
    float v = red[(size_t)r * (P + 1) + p];
    for (int w = 1; w < NWARPS; ++w)
      v = fmaxf(v, red[(size_t)(w * TILE_I + r) * (P + 1) + p]);
    out[((size_t)img * NR + row0 + r) * P + p] = v;
  }
}

template <int P, bool BF16>
int launch(const float* row_cols, const float* col_cols, const float* a,
           const float* b, const float* wg, const float* w2, const float* b2,
           const int* flags, float* out, int B, int NR, int NC, int K,
           float thr, cudaStream_t stream) {
  const size_t smem = smem_floats<P>() * sizeof(float);
  auto kernel = pair_pool2_fwd_kernel<P, BF16>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((NR + TILE_I - 1) / TILE_I, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(row_cols, col_cols, a, b, wg, w2,
                                           b2, flags, out, NR, NC, K, thr);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch_p(int P, const float* row_cols, const float* col_cols,
               const float* a, const float* b, const float* wg,
               const float* w2, const float* b2, const int* flags, float* out,
               int B, int NR, int NC, int K, float thr, cudaStream_t s) {
  switch (P) {
    case 8:
      return launch<8, BF16>(row_cols, col_cols, a, b, wg, w2, b2, flags, out,
                             B, NR, NC, K, thr, s);
    case 16:
      return launch<16, BF16>(row_cols, col_cols, a, b, wg, w2, b2, flags,
                              out, B, NR, NC, K, thr, s);
    case 32:
      return launch<32, BF16>(row_cols, col_cols, a, b, wg, w2, b2, flags,
                              out, B, NR, NC, K, thr, s);
    case 64:
      return launch<64, BF16>(row_cols, col_cols, a, b, wg, w2, b2, flags,
                              out, B, NR, NC, K, thr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Tile shape the flags must be computed at: TILE_I * 1000 + TILE_J.
int gnet_pair_pool2_tiles() { return TILE_I * 1000 + TILE_J; }

// Launches K1 on `stream`; returns cudaGetLastError() (0 = launched).
int gnet_pair_pool2_fwd(const float* row_cols, const float* col_cols,
                        const float* a, const float* b, const float* wg,
                        const float* w2, const float* b2, const int* flags,
                        float* out, int B, int NR, int NC, int P, int K,
                        float thr, int bf16, void* stream) {
  if (B <= 0 || NR <= 0) return 0;
  if ((K != 3 && K != 4) || NC < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_p<true>(P, row_cols, col_cols, a, b, wg, w2, b2,
                                 flags, out, B, NR, NC, K, thr, s)
              : dispatch_p<false>(P, row_cols, col_cols, a, b, wg, w2, b2,
                                  flags, out, B, NR, NC, K, thr, s);
}

}  // extern "C"
