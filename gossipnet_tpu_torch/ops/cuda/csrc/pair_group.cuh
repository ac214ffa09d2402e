// The neighbour-pair queue and the grouped FC2 product of the pair-pool
// kernels: K1 (pairwise2_fwd.cu), K2 (pairwise2_bwd.cu), K5
// (pairwise_fwd.cu) and K6 (pairwise_bwd.cu). Nothing here knows how h1 is
// made; an entry holds as many features as its kernel keeps per pair (K1/K2
// QFEAT = 4, K5/K6 nine).
//
// Why a queue: only ~5% of the (row, column) pairs a tile tests are
// neighbours, and a warp that runs the products for "its 32 rows against
// one column" keeps a quarter to a third of its lanes busy. So the tile
// loop is split. Stage A tests one pair per lane and pushes the pairs that
// pass, compacted by ballot and prefix count, into a per-warp ring in
// shared memory (the pair's global row and column and its features, NF
// words of them in a layout [NF][QCAP]).
// Stage B pops full groups, so the products run with every lane on a real
// neighbour pair. The ring outlives the column tile (an entry names its
// detections by global index), so a group is short only once, at the end.
// The order of the ring depends only on the inputs.
//
// Why a grouped product: in bf16 mode FC2 (pre2 = W2^T h1 + b2) of a group
// of 16 pairs is one [16, P] x [P, P] product on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 accumulator that starts at b2).
// h1 is produced directly in the A-fragment layout, W2 waits in shared
// memory packed as the B fragments want it. K2 finds K1's winners by
// pre2 == m, which holds because both kernels call fc2_mma below with the
// same k order and accumulator start: an output element's chain of
// products does not depend on the pair's slot in the group, on the other
// pairs of the group or on the calling kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gnet {

constexpr unsigned ALL_LANES = 0xffffffffu;
constexpr int QCAP = 128;   // ring entries per warp: a group (<= 32) + 2 pushes
constexpr int QFEAT = 4;    // features K1/K2 keep per entry
constexpr int QWORDS = 1 + QFEAT;  // K1/K2's shared-memory words per entry
constexpr int MAX_DETS = 1 << 15;  // an entry packs (row << 16) | column

// ---------------------------------------------------------------------------
// the queue
// ---------------------------------------------------------------------------

// Pushes this lane's pair if `pass`; `count` (warp-uniform) grows by the
// number pushed. Lanes enter in lane order, so the ring's order is fixed.
template <int NF>
__device__ __forceinline__ void queue_push(int* q_ij, float* q_g, int head,
                                           int& count, bool pass, int ij,
                                           const float (&g)[NF], int lane) {
  const unsigned mask = __ballot_sync(ALL_LANES, pass);
  if (pass) {
    const int slot =
        (head + count + __popc(mask & ((1u << lane) - 1u))) & (QCAP - 1);
    q_ij[slot] = ij;
#pragma unroll
    for (int k = 0; k < NF; ++k) q_g[k * QCAP + slot] = g[k];
  }
  count += __popc(mask);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// FC2 of a group of 16 pairs on the tensor cores
// ---------------------------------------------------------------------------

// Fragment geometry of mma.sync.m16n8k16 for a [16, P] x [P, P] product.
// Lane l: gid = l >> 2 (a slot of the group, and gid + 8), tig = l & 3.
//   A (h1, 16 x 16 per k block): reg r of k block kb holds slot
//     gid + 8 * (r & 1), p = kb * 16 + tig * 2 + 8 * (r >> 1) and p + 1.
//   B (W2, 16 x 8): b0 holds k = tig * 2, tig * 2 + 1 at n = gid; b1 k + 8.
//   C (pre2, 16 x 8 per n block): e = 0, 1: slot gid, q = nb * 8 + tig * 2
//     + e; e = 2, 3: slot gid + 8, the same q.
// P = 8 pads k to 16 with zeros.
template <int P>
struct Frag {
  static constexpr int KB = (P < 16 ? 16 : P) / 16;  // k blocks
  static constexpr int NB = P / 8;                   // n blocks
  static constexpr int KP = KB * 8;                  // packed k pairs
  static constexpr int LDW = P + 8;  // row stride of w2p: no bank conflict
  static constexpr int W2P_WORDS = KP * LDW;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// W2 [P, P] (in, out) f32 in device memory -> w2p[kp][n] = (W2[2 kp][n],
// W2[2 kp + 1][n]) rounded to bf16, rows beyond P zero. Whole block.
template <int P>
__device__ __forceinline__ void stage_w2_frags(const float* __restrict__ w2,
                                               uint32_t* w2p, int tid,
                                               int nthreads) {
  using F = Frag<P>;
  for (int x = tid; x < F::KP * P; x += nthreads) {
    const int kp = x / P, n = x - kp * P;
    const int k0 = 2 * kp;
    const float lo = k0 < P ? w2[k0 * P + n] : 0.f;
    const float hi = k0 + 1 < P ? w2[(k0 + 1) * P + n] : 0.f;
    w2p[kp * F::LDW + n] = pack_bf16(lo, hi);
  }
}

__device__ __forceinline__ void mma_m16n8k16_bf16(float (&c)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// pre2 of the group: acc starts at b2 and takes the k blocks in ascending
// order. The one place FC2 of bf16 mode is computed, for K1, K2, K5, K6.
template <int P>
__device__ __forceinline__ void fc2_mma(
    const uint32_t (&a)[Frag<P>::KB][4], const uint32_t* w2p,
    const float* b2s, float (&acc)[Frag<P>::NB][4], int lane) {
  using F = Frag<P>;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nb = 0; nb < F::NB; ++nb) {
    acc[nb][0] = acc[nb][2] = b2s[nb * 8 + tig * 2];
    acc[nb][1] = acc[nb][3] = b2s[nb * 8 + tig * 2 + 1];
  }
#pragma unroll
  for (int kb = 0; kb < F::KB; ++kb) {
#pragma unroll
    for (int nb = 0; nb < F::NB; ++nb) {
      const uint32_t b0 = w2p[(kb * 8 + tig) * F::LDW + nb * 8 + gid];
      const uint32_t b1 = w2p[(kb * 8 + tig + 4) * F::LDW + nb * 8 + gid];
      mma_m16n8k16_bf16(acc[nb], a[kb], b0, b1);
    }
  }
}

}  // namespace gnet
