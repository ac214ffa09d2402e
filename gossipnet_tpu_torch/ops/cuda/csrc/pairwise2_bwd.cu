// K2: GossipNet pair-pool backward for Hopper (sm_90a).
//
// Replaces the TPU kernel gossipnet_tpu/ops/pallas/pairwise2.py::_bwd_kernel
// (launched by _backward; its VJP _pair_pool2_p.defvjp; win rule _win_grad).
//
// Function: the VJP of K1 (pairwise2_fwd.cu) from its saved output m and
// the cotangent dm, recomputing every neighbour pair:
//   pre2_ij = W2^T h1_ij + b2,  h1_ij = relu(a'_i + b'_j + Wg_k^T g_ij)
//   dpre2_ij[q] = dm_i[q] if pre2_ij[q] == m_i[q] and m_i[q] > 0, else 0
// so EACH exact tie of the max gets the full dm (the TPU kernel's rule),
//   dpre1_ij = (W2 dpre2_ij) where h1_ij > 0
//   d_a'_i = sum_j dpre1_ij          d_b'_j = sum_i dpre1_ij
//   dWg_k  = sum_ij dpre1_ij g_ij^T  dW2 = sum_ij h1_ij dpre2_ij^T
//   db2    = sum_ij dpre2_ij
// The winner test is exact float equality against K1's m, so pre2 is
// recomputed through K1's own queue and FC2 functions (pairwise2_pair.cuh,
// pair_group.cuh), where a pair's pre2 depends on nothing but the pair.
//
// Bound: operations, like K1, and like K1 what limits it on this card is
// how sparse work is laid on warps: the recompute is K1's, and the
// gradient work is sparser still (about one winning q per neighbour pair).
// What the design does about it:
// - The recompute is K1's stage B on the forward's neighbour list (the
//   list kernel of pairwise2_fwd.cu ran stage A once a forward): the row
//   pass takes its row tile's list in groups, dealt round robin to its
//   splits' warps as K1 deals them, so no launch tests a pair; FC2 of a
//   group on the tensor cores in bf16 mode (f32 mode: CUDA cores, IEEE f32,
//   K1's fmaf order). A row tile whose list overflowed, and the column
//   pass's recompute, run stage A (dense test, compacted queue) as before.
// - A winner queue. A group's pre2 is compared with m per (pair, q); a pair
//   that wins some q goes, with its q mask, into a second per-warp queue,
//   drained after every group, so it needs no capacity beyond a group and
//   drops no tie. The gradient stage walks the winners with the lanes over
//   p: FC1 again for h1 (cheaper than keeping it), W2 dpre2 over the set
//   bits only, then plain += into the warp's own accumulators in shared
//   memory: no shuffles, no scan over lanes, no work for pairs that lose.
// - The blocks that share a tile of own detections take its work round
//   robin at the grain of a group of the list (or of two tests, where they
//   test), so a crowded tile does not leave one warp with a long serial
//   chain; each sums into its own slice [splits, ...].
// - The split count is sized for a padded grid in which every tile has
//   work; where detections are few most blocks have none (invalid
//   detections sort last, so their tiles' flags are clear). A block first
//   finds from its list's groups (row pass), or from its flag row or its
//   column bits where it tests, whether any step falls to it
//   (block_has_step); if not, it records that in `work` and leaves before
//   it stages, zeroes or writes anything. The working blocks count themselves in `counts`,
//   one integer atomicAdd a block.
// - A last small kernel (pair_pool2_bwd_kernel_sum) adds, in a fixed
//   order and over the working blocks only, the splits' slices of d_a'
//   and d_b' and the row blocks' partials of dWg_k, dW2 and db2; a block
//   that did not run is an exact zero and its scratch is never read.
// - Each neighbour pair is recomputed once. The row pass (a block owns 32
//   rows and walks the columns) sums d_a', dWg_k, dW2 and db2, and keeps
//   for each winning pair (i, j) a record: (i, j) and its P values of
//   dpre1_ij, rounded as the dots' operand (the term d_b'_j adds; a pair
//   that wins no q adds nothing). A row tile's records share one region
//   of scratch, whose slots the tile's blocks take by an integer
//   atomicAdd a group; it holds TILE_I x P records, the most a tile can
//   have without exact ties (one winner a row and q). The column pass
//   then launches (a block owns 32 columns, the same blocks and skip rule
//   as before) and sums d_b' from the records: the row tiles are dealt to
//   the splits (records_split) and a split's tiles to its block's warps
//   in turn; a warp reads the regions of its tiles that can neighbour the
//   block's columns (stage_column_activity's bits), files the records of
//   those columns by (row, column), and each lane adds one column's in
//   ascending row order; the warps' sums meet in order. So where a record
//   was written does not matter, every record lands in a block that the
//   skip rule runs, and a block reads a 1/S share of the regions. Exact
//   ties can overflow a region (duplicate detections; the bf16 stream
//   ties often): a region that would overflow writes no record past its
//   end and marks its image incomplete, and the column blocks of that
//   image recompute their pairs as the row pass does, with the roles
//   swapped (the IoU test and the features are commutative; at the skip
//   tile FI x TJ a tile of rows and 32 columns overlap up to four flags,
//   found once at the start). Each column block counts which way it took,
//   one integer atomicAdd a block. The three grids (row, column, sum)
//   follow a set of the record counts.
// Deterministic, with no float atomics: a warp adds its winners in the
// order of its groups (the list's, or its queue's), which depends only on
// the inputs; the four warps' sums meet in
// order; the last kernel sums the blocks' partials in an order fixed by
// the shape and the flags. Two launches
// give bit-identical gradients. d_b'_j adds its rows in an order fixed by
// the row indices alone, so a permutation of the columns permutes d_b'
// bit for bit, and a column and its copy get the same bits.
//
// BF16 mode rounds the operands the TPU backward feeds its bf16 dots
// (dpre2, dpre1, g, h1, W2) and sums in f32; d_a' and db2 sum unrounded
// f32, as the TPU kernel does. Non-BF16 mode is IEEE f32. EW (mode 2, the
// bf16 stream) recomputes h1 and pre2 as K1's EW instantiation does, so a
// winner is a pair whose bf16 pre2 equals m (the TPU kernel's _win_grad,
// bf16 branch); ties are common there, and each gets the full dm.

#include "pairwise2_pair.cuh"

namespace {

using namespace gnet;

constexpr int WCAP = 32;             // winners of one group, at most
constexpr int WWORDS = 1 + QFEAT + 2;  // (row, col), features, q mask lo/hi

template <int P, bool ROWSIDE>
__host__ __device__ constexpr size_t warp_acc_words() {
  return TILE_I * P + (ROWSIDE ? P * P + KMAX * P + P : 0);
}

template <int P, bool BF16, bool ROWSIDE>
constexpr size_t smem_words() {
  return (BF16 ? Frag<P>::W2P_WORDS : P * P)  // W2 for FC2
         + P * P                                          // W2^T for W2 dpre2
         + KMAX * P + P                                   // wgs, b2s
         + NWARPS * (QCAP * QWORDS + WCAP * WWORDS)       // queues
         + NWARPS * warp_acc_words<P, ROWSIDE>()
         // the row pass's list ends and dense word, the column pass's bits
         + (ROWSIDE ? LIST_PARTS + 1 : ACT_WORDS);
}

// A row block's weight partials, one row of wpart: dWg_k [K][P], dW2
// [P][P], db2 [P].
__host__ __device__ inline int weight_words(int K, int P) {
  return K * P + P * P + P;
}

// Records a row tile's region holds: one winning pair a row and q, the
// most a tile has without exact ties.
template <int P>
__host__ __device__ constexpr int rec_cap() {
  return TILE_I * P;
}

struct Args {
  const float *row_cols, *col_cols, *a, *b, *wg, *w2, *b2;
  const int* flags;
  const float *m, *dm;
  float *da_part, *db_part, *wpart;  // [S, B, NR, P], [S, B, NC, P],
                                     // [S * B * NI, weight_words]
  int* work;                    // [S, B, NI + NCT]: the block had a step
  // over all launches: blocks with a step; column blocks with a step that
  // summed records; those that recomputed; row blocks with a step that
  // took their pairs from the list; those that tested them
  unsigned long long* counts;
  float* rec_vr;  // [B, NI, rec_cap, P]: a record's dpre1 terms
  int* rec_ij;    // [B, NI, rec_cap]: its (row << 16) | column
  int* rec_fill;  // [B, NI + 1]: records a row tile took (may pass the
                  // cap), then the image's word "a region overflowed"
  const int* lst_ij;  // the forward's neighbour list (K1's list kernel)
  const float4* lst_g;
  const int* lst_count;
  int B, NR, NC, K, splits;
  float thr;
  Tile tile;  // the flags' skip tile
};

// The split whose column blocks sum the records of row i: one whose share
// of stage_loop's items holds an item of i's tile of TJ rows (the k-th 32
// rows of a tile take its k-th item; at TJ = 16 a tile takes its first),
// so the skip rule gives that split's block a step wherever the tile can
// hold a neighbour of its columns. Rows of one row tile share a split
// when TJ >= 32, and each half of it at TJ = 16.
__device__ __forceinline__ int records_split(int i, int tj_shift,
                                             int splits) {
  return (((i >> tj_shift) << (tj_shift - 3)) +
          ((i & ((1 << tj_shift) - 1)) >> 5)) % splits;
}

// The column pass from the row pass's records: d_b' of the block's 32
// columns [c0, c0 + 32), written to its slice of db_part in full. The
// split's row tiles are dealt to the warps in turn, by their order among
// the split's tiles (the rows alone fix it). A warp takes its tiles in
// ascending order and, of each that can neighbour the columns, files the
// region's records of the columns by (row, column) in its own shared
// memory `wq`; then lane l adds column l's records in ascending row
// order, a record's P floats at once. The warps' sums meet in order in
// `acc` ([NWARPS][TILE_I][P], shared).
template <int P, class Active>
__device__ __forceinline__ void sum_records(const Args& x, int c0, int img,
                                            int split, const int* fill,
                                            Active& active, float* wq,
                                            float* acc, int lane, int warp,
                                            int tid) {
  constexpr int CAP = rec_cap<P>();
  constexpr int SCAN = 8;  // record indices a lane loads at once
  static_assert(CAP <= 65536, "a record's slot fits 16 bits");
  static_assert(TILE_I + TILE_I * TILE_I / 2 <= QCAP * QWORDS + WCAP * WWORDS,
                "a warp's table fits where its queues are");
  unsigned* rows = reinterpret_cast<unsigned*>(wq);  // [column]: bit r,
                                                     // row r has a record
  unsigned short* slot =  // [row][column]: the record's slot
      reinterpret_cast<unsigned short*>(rows + TILE_I);
  const int NI = (x.NR + TILE_I - 1) / TILE_I;
  const int tj_shift = x.tile.tj_shift;
  const int last_tile = (x.NR - 1) >> tj_shift;  // the bits stop there
  const int half = min(TILE_I, 1 << tj_shift);   // rows of one split
  float sum[P];
#pragma unroll
  for (int p = 0; p < P; ++p) sum[p] = 0.f;
  rows[lane] = 0u;
  __syncwarp();
  int before = 0;  // the split's row tiles before this chunk of 32
  for (int t0 = 0; t0 < NI; t0 += 32) {
    // lane l: row tile t0 + l, its splits (two halves at TJ = 16), whether
    // it has records and can neighbour the columns
    const int t = t0 + lane;
    const int split_lo = records_split(t * TILE_I, tj_shift, x.splits);
    const int split_hi =
        records_split(t * TILE_I + TILE_I - 1, tj_shift, x.splits);
    const bool ours = t < NI && (split_lo == split || split_hi == split);
    bool near = false;
    if (ours && fill[t] > 0) {
      const int u1 = min((t * TILE_I + TILE_I - 1) >> tj_shift, last_tile);
      for (int u = (t * TILE_I) >> tj_shift; u <= u1; ++u)
        near = near || active(u);
    }
    const unsigned mine = __ballot_sync(ALL_LANES, ours);
    unsigned todo = __ballot_sync(ALL_LANES, near);
    for (; todo; todo &= todo - 1u) {
      const int l = __ffs(todo) - 1;
      if ((before + __popc(mine & ((1u << l) - 1u))) % NWARPS != warp)
        continue;
      const int r0 = (t0 + l) * TILE_I;
      const int lo = __shfl_sync(ALL_LANES, split_lo, l);
      const int hi = __shfl_sync(ALL_LANES, split_hi, l);
      const int n = min(fill[t0 + l], CAP);
      const size_t region = (size_t)img * NI + t0 + l;
      const int* ij = x.rec_ij + region * CAP;
      for (int k0 = 0; k0 < n; k0 += 32 * SCAN) {
        int e[SCAN];  // every load in flight before any is tested
#pragma unroll
        for (int v = 0; v < SCAN; ++v) {
          const int k = k0 + v * 32 + lane;
          e[v] = k < n ? __ldg(ij + k) : -1;
        }
#pragma unroll
        for (int v = 0; v < SCAN; ++v) {
          const int ri = (e[v] >> 16) - r0, jl = (e[v] & 0xffff) - c0;
          if (e[v] >= 0 && jl >= 0 && jl < TILE_I &&
              (ri < half ? lo : hi) == split) {
            slot[ri * TILE_I + jl] = (unsigned short)(k0 + v * 32 + lane);
            atomicOr(rows + jl, 1u << ri);  // one record a pair
          }
        }
      }
      __syncwarp();
      const float* vr = x.rec_vr + region * CAP * P;
      unsigned bits = rows[lane];
      rows[lane] = 0u;
      for (; bits; bits &= bits - 1u) {
        const float4* v = reinterpret_cast<const float4*>(
            vr + (size_t)slot[(__ffs(bits) - 1) * TILE_I + lane] * P);
        float4 f[P / 4];  // the record's loads in flight at once
#pragma unroll
        for (int q = 0; q < P / 4; ++q) f[q] = __ldg(v + q);
#pragma unroll
        for (int q = 0; q < P / 4; ++q) {
          sum[4 * q] += f[q].x;
          sum[4 * q + 1] += f[q].y;
          sum[4 * q + 2] += f[q].z;
          sum[4 * q + 3] += f[q].w;
        }
      }
      __syncwarp();
    }
    before += __popc(mine);
  }
  float* own = acc + (size_t)warp * TILE_I * P + lane * P;
#pragma unroll
  for (int p = 0; p < P; ++p) own[p] = sum[p];
  __syncthreads();
  float* out = x.db_part + ((size_t)split * x.B + img) * x.NC * P;
  for (int e = tid; e < TILE_I * P; e += NTHREADS) {
    if (c0 + e / P >= x.NC) continue;
    float v = acc[e];
    for (int w = 1; w < NWARPS; ++w) v += acc[w * TILE_I * P + e];
    out[(size_t)c0 * P + e] = v;
  }
}

// ROWSIDE: the block owns rows [own0, own0 + 32) and walks the columns;
// writes its slice of d_a', its partials of dWg_k, dW2, db2 and its
// winners' records. !ROWSIDE: the block owns 32 columns; writes its slice
// of d_b' from the records, or, where its image's records are incomplete,
// walks the rows. Either writes nothing but its `work` entry if it has no
// step.
template <int P, bool BF16, bool EW, bool ROWSIDE>
__device__ __forceinline__ void pair_pool2_bwd_pass(const Args& x, int tile,
                                                    int img, int split) {
  static_assert(!EW || BF16, "a bf16 stream needs bf16 operands");
  constexpr int GROUP = group_size<BF16>();
  constexpr int PP = (P + 31) / 32;   // p values per lane in the gradient stage
  constexpr size_t ACC = warp_acc_words<P, ROWSIDE>();
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem;                                   // f32 [P][P] (in, out)
  uint32_t* w2p = reinterpret_cast<uint32_t*>(smem);   // or packed bf16
  float* w2t = smem + (BF16 ? Frag<P>::W2P_WORDS : P * P);  // [q][p]
  float* wgs = w2t + P * P;                            // [KMAX][P]
  float* b2s = wgs + KMAX * P;                         // [P]
  float* qbase = b2s + P;
  float* accbase = qbase + NWARPS * (QCAP * QWORDS + WCAP * WWORDS);
  unsigned* act_bits =  // [ACT_WORDS], the column pass's (!ROWSIDE)
      reinterpret_cast<unsigned*>(accbase + NWARPS * ACC);
  int* ends = reinterpret_cast<int*>(act_bits);  // the row pass's: [PARTS]
  int* dense_word = ends + LIST_PARTS;

  const int K = x.K;
  const int C = K == 4 ? 9 : 8;
  const int NR = x.NR, NC = x.NC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NI = (NR + TILE_I - 1) / TILE_I;        // row blocks
  const int NFR = x.tile.rows(NR), NFC = x.tile.cols(NC);  // the flags
  const int own0 = tile * TILE_I;
  const int NOWN = ROWSIDE ? NR : NC;
  const int NOTH = ROWSIDE ? NC : NR;

  float* wq = qbase + warp * (QCAP * QWORDS + WCAP * WWORDS);
  int* q_ij = reinterpret_cast<int*>(wq);              // [QCAP]
  float* q_g = wq + QCAP;                              // [QFEAT][QCAP]
  int* w_ij = reinterpret_cast<int*>(wq + QCAP * QWORDS);  // [WCAP]
  float* w_g = wq + QCAP * QWORDS + WCAP;              // [QFEAT][WCAP]
  unsigned* w_lo = reinterpret_cast<unsigned*>(w_g + QFEAT * WCAP);
  unsigned* w_hi = w_lo + WCAP;
  float* own_acc = accbase + warp * ACC;               // [TILE_I][P]
  float* dw2t = own_acc + TILE_I * P;                  // [q][p]   (ROWSIDE)
  float* dwgs = dw2t + P * P;                          // [KMAX][P]
  float* db2a = dwgs + KMAX * P;                       // [P]

  // Whether tile t of the other side (TJ detections) can hold a neighbour
  // of this block: in the row pass the flag in column t of the own rows'
  // flag row; in the column pass, bit t of stage_column_activity's.
  const int* fl = x.flags + (size_t)img * NFR * NFC;
  const int* own_flags =
      ROWSIDE ? fl + (size_t)(own0 >> x.tile.fi_shift) * NFC : fl;
  if (!ROWSIDE) {
    stage_column_activity(fl, NFR, NFC, x.tile, own0, NR, act_bits, lane,
                          warp);
    __syncthreads();
  }
  auto active = [&](int t) {
    return ROWSIDE ? own_flags[t] != 0
                   : ((act_bits[t >> 5] >> (t & 31)) & 1u) != 0u;
  };
  // The row pass takes its row tile's list where no part overflowed: its
  // groups dealt round robin to the (split, warp)s, as K1's are.
  const int cap = list_cap(NC);
  const size_t tile_part0 = ((size_t)img * NI + tile) * LIST_PARTS;
  int total = 0;
  const bool dense =
      !ROWSIDE || read_list_counts(x.lst_count + tile_part0, cap, ends,
                                   dense_word, lane, warp, total);
  const int groups = (total + GROUP - 1) / GROUP;
  const bool has_step =
      dense ? block_has_step(NOTH, split, x.splits, x.tile.tj_shift, active,
                             tid)
            : groups > split * NWARPS;
  if (tid == 0) {
    const int ntiles = NI + (NC + TILE_I - 1) / TILE_I;
    x.work[((size_t)split * x.B + img) * ntiles + (ROWSIDE ? 0 : NI) + tile] =
        has_step;
    if (has_step) atomicAdd(x.counts, 1ull);
    if (has_step && ROWSIDE) atomicAdd(x.counts + (dense ? 4 : 3), 1ull);
  }
  if (!has_step) return;
  int* const fill = x.rec_fill + (size_t)img * (NI + 1);
  if constexpr (!ROWSIDE) {
    const bool from_records = fill[NI] == 0;
    if (tid == 0) atomicAdd(x.counts + (from_records ? 1 : 2), 1ull);
    if (from_records) {
      sum_records<P>(x, own0, img, split, fill, active, wq, accbase, lane,
                     warp, tid);
      return;
    }
  }

  if (BF16) {
    stage_w2_frags<P>(x.w2, w2p, tid, NTHREADS);
  } else {
    for (int e = tid; e < P * P; e += NTHREADS)
      w2s[e] = x.w2[e];
  }
  for (int e = tid; e < P * P; e += NTHREADS) {
    const int q = e / P, p = e - q * P;
    w2t[e] = BF16 ? round_bf16(x.w2[p * P + q]) : x.w2[p * P + q];
  }
  stage_small_weights<P, BF16>(x.wg, x.b2, K, wgs, b2s, tid);
  for (int e = tid; e < (int)(NWARPS * ACC); e += NTHREADS) accbase[e] = 0.f;
  __syncthreads();

  const float* a_img = x.a + (size_t)img * NR * P;
  const float* b_img = x.b + (size_t)img * NC * P;
  const float* m_img = x.m + (size_t)img * NR * P;
  const float* dm_img = x.dm + (size_t)img * NR * P;
  // ROWSIDE: this row tile's region of records
  constexpr int CAP = rec_cap<P>();
  const size_t region = ROWSIDE ? (size_t)img * NI + tile : 0;
  int* rec_ij = x.rec_ij + region * CAP;
  float* rec_vr = x.rec_vr + region * CAP * P;

  // The warp's sums of dWg_k[:, p] and db2[p] for this lane's p values stay
  // in registers: every winner adds to them.
  float dwg_r[KMAX][PP], db2_r[PP];
#pragma unroll
  for (int r = 0; r < PP; ++r) {
    db2_r[r] = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) dwg_r[k][r] = 0.f;
  }

  // The gradient stage: the warp's `nwin` winners in queue order, the
  // lanes over p. The row pass takes nwin slots of its tile's region at
  // once and records each winner that fits; the atomic's result is first
  // read after the first winner's gradient, which hides its latency.
  auto gradients = [&](int nwin) {
    int slot0 = 0;
    if (ROWSIDE && nwin > 0 && lane == 0) slot0 = atomicAdd(fill + tile, nwin);
    for (int w = 0; w < nwin; ++w) {
      const int ij = w_ij[w];
      const int i = ij >> 16, j = ij & 0xffff;
      const unsigned lo = w_lo[w], hi = w_hi[w];
      float g[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) g[k] = w_g[k * WCAP + w];
      const float* ar = a_img + (size_t)i * P;
      const float* br = b_img + (size_t)j * P;
      const float* dmr = dm_img + (size_t)i * P;
      float h1v[PP], dp1[PP], dmv[PP];
#pragma unroll
      for (int r = 0; r < PP; ++r) {
        const int p = lane + 32 * r;
        h1v[r] = dp1[r] = dmv[r] = 0.f;
        if (p < P) {
          const float bv = __ldg(br + p);
          h1v[r] = h1_value<P, BF16, EW>(__ldg(ar + p),
                                     BF16 ? round_bf16(bv) : bv, wgs, g, p);
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
      int slot = CAP;  // ROWSIDE: the winner's record, where it fits
      if (ROWSIDE) {
        slot = __shfl_sync(ALL_LANES, slot0, 0) + w;
        if (lane == 0) {
          if (slot < CAP) rec_ij[slot] = ij;
          else fill[NI] = 1;  // the image's records are incomplete
        }
      }
#pragma unroll
      for (int r = 0; r < PP; ++r) {
        const int p = lane + 32 * r;
        if (p < P) {
          const float v = h1v[r] > 0.f ? dp1[r] : 0.f;
          const float vr = BF16 ? round_bf16(v) : v;  // the dots' operand
          if (ROWSIDE) {
            own_acc[ol * P + p] += v;
#pragma unroll
            for (int k = 0; k < KMAX; ++k)  // g[k] is 0 beyond K
              dwg_r[k][r] = fmaf(vr, g[k], dwg_r[k][r]);
            if (slot < CAP) rec_vr[(size_t)slot * P + p] = vr;
          } else {
            own_acc[ol * P + p] += vr;
          }
        }
      }
    }
    __syncwarp();
  };

  // Stage B: recompute one group of `n` pairs (`group`: the ring or the
  // list), collect its winners, run their gradients.
  auto consume_group = [&](const auto& group, int n) {
    int nwin = 0;
    auto push_winner = [&](bool want, int ij, const float (&g)[QFEAT],
                           unsigned lo, unsigned hi) {
      const unsigned mask = __ballot_sync(ALL_LANES, want);
      if (want) {
        const int pos = nwin + __popc(mask & ((1u << lane) - 1u));
        w_ij[pos] = ij;
#pragma unroll
        for (int k = 0; k < QFEAT; ++k) w_g[k * WCAP + pos] = g[k];
        w_lo[pos] = lo;
        w_hi[pos] = hi;
      }
      nwin += __popc(mask);
    };
    if constexpr (BF16) {
      uint32_t afr[Frag<P>::KB][4];
      int ij2[2];
      float g2[2][KMAX];
      group_h1_frags<P, KMAX, true, EW>(a_img, b_img, wgs, group, n, lane,
                                        afr, ij2, g2);
      float acc[Frag<P>::NB][4];
      fc2_mma<P, EW>(afr, w2p, b2s, acc, lane);
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
                    ij2[h], g2[h], lo[h], hi[h]);
    } else {
      float g[KMAX];
      const int ij = lane_pair<KMAX>(group, n, lane, g);
      float pre[P];
      const size_t off = (size_t)(ij >> 16) * P;
      pair_pre2<P>(a_img + off, b_img + (size_t)(ij & 0xffff) * P, wgs,
                         w2s, b2s, g, pre);
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
      push_winner((lo | hi) != 0u, ij, g, lo, hi);
    }
    __syncwarp();
    gradients(nwin);
  };

  if (dense) {
    const float* own_fields =
        (ROWSIDE ? x.row_cols + (size_t)img * C * NR
                 : x.col_cols + (size_t)img * C * NC);
    const float* oth_fields =
        (ROWSIDE ? x.col_cols + (size_t)img * C * NC
                 : x.row_cols + (size_t)img * C * NR);
    float ri[CMAX];
    const int own = own0 + lane;
    const bool live = load_det(own_fields, C, NOWN, own, ri);
    auto consume = [&](int head, int n) {
      consume_group(RingGroup<KMAX>{q_ij, q_g, head}, n);
    };
    run_stages<BF16, GROUP>(ri, live, oth_fields, C, NOTH, split, x.splits,
                            x.tile.tj_shift, active, K, x.thr,
                            ROWSIDE ? own << 16 : own, ROWSIDE ? 0 : 16, q_ij,
                            q_g, lane, warp, consume);
  } else {
    const int* t_ij = x.lst_ij + tile_part0 * cap;
    const float4* t_g = x.lst_g + tile_part0 * cap;
    for (int grp = split * NWARPS + warp; grp < groups;
         grp += x.splits * NWARPS) {
      const int e0 = grp * GROUP, n = min(GROUP, total - e0);
      consume_group(ListGroup<BF16>{t_ij, t_g, ends, cap, e0, n}, n);
    }
  }

  // The warps' sums meet in a fixed order.
  if (ROWSIDE) {
#pragma unroll
    for (int r = 0; r < PP; ++r) {
      const int p = lane + 32 * r;
      if (p < P) {
        db2a[p] = db2_r[r];
#pragma unroll
        for (int k = 0; k < KMAX; ++k) dwgs[k * P + p] = dwg_r[k][r];
      }
    }
  }
  __syncthreads();
  // this split's slice of the output: [splits, B, N, P]
  const size_t slice = (size_t)split * x.B + img;
  float* own_out = (ROWSIDE ? x.da_part : x.db_part) + slice * NOWN * P;
  for (int e = tid; e < TILE_I * P; e += NTHREADS) {
    if (own0 + e / P >= NOWN) continue;
    float v = accbase[e];
    for (int w = 1; w < NWARPS; ++w) v += accbase[w * ACC + e];
    own_out[(size_t)own0 * P + e] = v;
  }
  if (ROWSIDE) {
    // Weight gradients: this block's partials, warps summed in order.
    float* wp = x.wpart + (slice * NI + tile) * weight_words(K, P);
    const float* dw2t0 = accbase + TILE_I * P;
    const float* dwg0 = dw2t0 + P * P;
    const float* db20 = dwg0 + KMAX * P;
    for (int e = tid; e < K * P; e += NTHREADS) {
      float v = dwg0[e];
      for (int w = 1; w < NWARPS; ++w) v += dwg0[w * ACC + e];
      wp[e] = v;
    }
    for (int e = tid; e < P * P; e += NTHREADS) {
      const int p = e / P, q = e - p * P;
      float v = dw2t0[q * P + p];
      for (int w = 1; w < NWARPS; ++w) v += dw2t0[w * ACC + q * P + p];
      wp[K * P + e] = v;
    }
    for (int e = tid; e < P; e += NTHREADS) {
      float v = db20[e];
      for (int w = 1; w < NWARPS; ++w) v += db20[w * ACC + e];
      wp[K * P + P * P + e] = v;
    }
  }
}

// One pass a grid: the column pass reads the row pass's records.
template <int P, bool BF16, bool EW, bool ROWSIDE>
__global__ void __launch_bounds__(NTHREADS)
pair_pool2_bwd_pass_kernel(Args x) {
  pair_pool2_bwd_pass<P, BF16, EW, ROWSIDE>(x, blockIdx.x, blockIdx.y,
                                            blockIdx.z);
}

// The last step: every output summed over the blocks that had a step, in
// an order fixed by the shape and the flags. A thread reads the `work`
// words of up to 32 of its terms at once (all loads in flight: testing
// them one by one would chain the loads), then loads only the terms that
// have work, several at a time, and adds them in order. Blocks [0,
// wblocks) take WCOLS columns of the weight partials each: the rows
// (split, image, row tile) are dealt round robin to WGROUPS groups, each
// adds its rows in order, and the groups' sums meet in a fixed tree. The
// other blocks add d_a' and d_b', a float4 a thread, over the splits in
// order.
constexpr int SUM_THREADS = 512;
constexpr int WCOLS = 8;
constexpr int WGROUPS = SUM_THREADS / WCOLS;

struct SumArgs {
  const int* work;
  const float *da_part, *db_part, *wpart;
  float *da, *db, *wsum;
  int B, NR, NC, P, splits, NI, ntiles, W, wblocks;
};

__device__ __forceinline__ float4& operator+=(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

// v += term(j) for the j < n with has(j), in ascending j, N term loads in
// flight at a time.
template <int N, class T, class Has, class Term>
__device__ __forceinline__ void add_present(T& v, int n, Has has, Term term) {
  for (int j0 = 0; j0 < n; j0 += 32) {
    unsigned bits = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (j0 + k < n && has(j0 + k)) bits |= 1u << k;
    while (bits) {
      T u[N];
      int got = 0;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (bits) {
          u[k] = term(j0 + __ffs(bits) - 1);
          bits &= bits - 1u;
          got = k + 1;
        }
      }
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k < got) v += u[k];
    }
  }
}

__global__ void __launch_bounds__(SUM_THREADS)
pair_pool2_bwd_kernel_sum(SumArgs x) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < x.wblocks) {
    __shared__ float part[WGROUPS][WCOLS];
    const int cl = tid % WCOLS, g = tid / WCOLS;
    const int c = blockIdx.x * WCOLS + cl;
    const int rows = x.splits * x.B * x.NI;  // (split, image, row tile)
    float v = 0.f;
    if (c < x.W) {
      add_present<8>(
          v, (rows - g + WGROUPS - 1) / WGROUPS,
          [&](int j) {
            const int r = g + j * WGROUPS, sb = r / x.NI;
            return x.work[(size_t)sb * x.ntiles + (r - sb * x.NI)] != 0;
          },
          [&](int j) { return x.wpart[(size_t)(g + j * WGROUPS) * x.W + c]; });
    }
    part[g][cl] = v;
    for (int half = WGROUPS / 2; half > 0; half /= 2) {
      __syncthreads();
      if (g < half) part[g][cl] += part[g + half][cl];
    }
    if (g == 0 && c < x.W) x.wsum[c] = part[0][cl];
    return;
  }
  const size_t na = (size_t)x.B * x.NR * x.P / 4;  // float4s of d_a'
  const size_t nb = (size_t)x.B * x.NC * x.P / 4;
  size_t i = (size_t)(blockIdx.x - x.wblocks) * SUM_THREADS + tid;
  const bool rowside = i < na;
  if (!rowside) i -= na;
  const size_t n = rowside ? na : nb;
  if (i >= n) return;
  const int nown = rowside ? x.NR : x.NC;
  const size_t det = 4 * i / x.P;  // image * nown + own detection
  const int img = (int)(det / nown);
  const int col =
      (rowside ? 0 : x.NI) + (int)(det - (size_t)img * nown) / TILE_I;
  const float4* part =
      reinterpret_cast<const float4*>(rowside ? x.da_part : x.db_part);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  add_present<4>(
      v, x.splits,
      [&](int s) {
        return x.work[((size_t)s * x.B + img) * x.ntiles + col] != 0;
      },
      [&](int s) { return part[(size_t)s * n + i]; });
  reinterpret_cast<float4*>(rowside ? x.da : x.db)[i] = v;
}

template <class Kernel>
int launch_grid(Kernel kernel, const Args& x, int tiles, size_t smem_words,
                cudaStream_t stream) {
  if (tiles <= 0 || x.B <= 0) return 0;
  const size_t smem = smem_words * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(tiles, x.B, x.splits), NTHREADS, smem, stream>>>(x);
  return (int)cudaGetLastError();
}

// The row pass, then the column pass, which reads its records.
template <int P, bool BF16, bool EW>
int launch(const Args& x, cudaStream_t stream) {
  const int e = launch_grid(pair_pool2_bwd_pass_kernel<P, BF16, EW, true>, x,
                            (x.NR + TILE_I - 1) / TILE_I,
                            smem_words<P, BF16, true>(), stream);
  return e != 0 ? e
                : launch_grid(pair_pool2_bwd_pass_kernel<P, BF16, EW, false>,
                              x, (x.NC + TILE_I - 1) / TILE_I,
                              smem_words<P, BF16, false>(), stream);
}

template <bool BF16, bool EW>
int dispatch_p(int P, const Args& x, cudaStream_t s) {
  switch (P) {
    case 8: return launch<8, BF16, EW>(x, s);
    case 16: return launch<16, BF16, EW>(x, s);
    case 32: return launch<32, BF16, EW>(x, s);
    case 64: return launch<64, BF16, EW>(x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Whether the kernel takes the skip tile FI x TJ (rows x columns of a flag).
int gnet_pair_pool2_bwd_tiles(int fi, int tj) {
  Tile t;
  return make_tile(fi, tj, t) ? 1 : 0;
}

// Launches K2 (a set of rec_fill, its row pass, its column pass, then the
// sum) on `stream`; returns cudaGetLastError() (0 = launched). `splits`
// blocks share the work on a tile of own detections, each summing into its
// own slice of the scratch da_part [S, B, NR, P] and db_part [S, B, NC, P];
// each row block of 32 (NI of them) writes its weight partials into a row
// of wpart [S*B*NI, K*P + P*P + P], and every block its entry of work
// [S, B, NI + ceil(NC / 32)]. A block with no step writes only that entry.
// The row tiles' records: rec_vr [B, NI, 32 P, P] float, rec_ij [B, NI,
// 32 P] and rec_fill [B, NI + 1] int (set to zero here). The sum writes
// every output in full: da [B, NR, P], db [B, NC, P] and wsum [K*P + P*P +
// P] (dWg_k [K, P], dW2 [P, P], db2 [P]). `counts`: five unsigned 64-bit
// integers, to which each block with a step adds 1, each column block with
// a step 1 to the second where it summed records, else to the third, and
// each row block with a step 1 to the fourth where it took its pairs from
// the list (lst_ij, lst_g, lst_count: gnet_pair_pool2_list's on the same
// geometry), else to the fifth.
// `mode`: 0 f32, 1 bf16 operands, 2 bf16 operands and the bf16 stream.
// `flags` [B, ceil(NR / fi), ceil(NC / tj)] at the skip tile fi x tj.
int gnet_pair_pool2_bwd(const float* row_cols, const float* col_cols,
                        const float* a, const float* b, const float* wg,
                        const float* w2, const float* b2, const int* flags,
                        const float* m, const float* dm, float* da,
                        float* db, float* da_part, float* db_part,
                        float* wpart, float* wsum, int* work,
                        unsigned long long* counts, float* rec_vr,
                        int* rec_ij, int* rec_fill, const int* lst_ij,
                        const float* lst_g, const int* lst_count, int B,
                        int NR, int NC,
                        int P, int K, int splits, float thr, int mode, int fi,
                        int tj, void* stream) {
  Tile tile;
  if (!make_tile(fi, tj, tile)) return (int)cudaErrorInvalidValue;
  if ((K != 3 && K != 4) || B < 0 || NR < 0 || NC < 0 || NR > MAX_DETS ||
      NC > MAX_DETS || splits < 1 || splits > 65535 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const Args x{row_cols, col_cols, a, b, wg, w2, b2, flags, m, dm,
               da_part, db_part, wpart, work, counts, rec_vr, rec_ij,
               rec_fill, lst_ij, reinterpret_cast<const float4*>(lst_g),
               lst_count, B, NR, NC, K, splits, thr, tile};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = (NR + TILE_I - 1) / TILE_I;
  const cudaError_t set = cudaMemsetAsync(
      rec_fill, 0, (size_t)B * (ni + 1) * sizeof(int), s);
  if (set != cudaSuccess) return (int)set;
  const int e = mode == 2 ? dispatch_p<true, true>(P, x, s)
                : mode    ? dispatch_p<true, false>(P, x, s)
                          : dispatch_p<false, false>(P, x, s);
  if (e != 0) return e;
  const int W = weight_words(K, P);
  const SumArgs y{work, da_part, db_part, wpart, da, db, wsum, B, NR, NC, P,
                  splits, ni, ni + (NC + TILE_I - 1) / TILE_I, W,
                  (W + WCOLS - 1) / WCOLS};
  const size_t n4 = (size_t)B * (NR + NC) * P / 4;
  pair_pool2_bwd_kernel_sum<<<(unsigned)(y.wblocks + (n4 + SUM_THREADS - 1) /
                                                         SUM_THREADS),
                              SUM_THREADS, 0, s>>>(y);
  return (int)cudaGetLastError();
}

}  // extern "C"
