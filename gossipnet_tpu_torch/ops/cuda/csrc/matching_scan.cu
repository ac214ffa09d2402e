// K3/K4: the greedy det<->GT matching scan for Hopper (sm_90a).
//
// Replaces the TPU kernels gossipnet_tpu/ops/pallas/matching_kernel.py::
// _kernel_batched (K3, greedy_scan_pallas_batched) and ::_kernel (K4,
// greedy_scan_pallas). K4 is this kernel over a grid of one image.
//
// Function: per image b and threshold t, walk the N detections in their
// (score-sorted) row order; detection n takes, among the GTs not yet taken
// at threshold t, the one of largest IoU with IoU >= t, the lowest GT index
// winning ties (jnp.argmax's rule, _kernel_batched:136); a detection with
// no such GT stays unmatched (best = -1). The IoU is pre-masked by the
// caller (invalid detections and non-real GTs zeroed), so every threshold
// must be > 0; the wrapper refuses t <= 0.
//
// Bound: neither bytes nor operations. It reads the [B, N, G] IoU once
// and does only comparisons, but every detection depends on the `taken`
// state left by the one before it: a chain of N steps per (b, t). The
// design takes all the work it can off that chain. One block per image:
//
// - Producer warps turn each row into its candidate list at the lowest
//   threshold: the GTs with IoU >= t_min, ordered by (IoU desc, GT index
//   asc), at most CAP = 32 of them (one a lane). For a higher threshold the
//   candidates are a prefix of that list, so a row stores the list's GT
//   indices and, per threshold, the prefix length. A row with more than
//   CAP candidates is flagged in a mask of its own, and the chain takes it
//   the old way (a warp argmax over the whole row, read from device
//   memory), so the result is exact for any input. A loader warp streams
//   the image into a ring of row buffers (up to 32 rows each), ahead of
//   the producers: one bulk copy a buffer that completes on an mbarrier
//   where rows are whole 16-byte words (G % 4 == 0), else a 4-byte
//   cp.async an element.
// - The producers fill a ring of SLOTS slots of ROWS rows each, ahead of
//   the chain, with, per slot and threshold, a mask of the rows that have
//   a candidate there. A slot is handed over by two mbarriers: `full`
//   (every producer lane has written its rows of it) and `empty` (every
//   chain lane has passed it). No block-wide barrier after the start.
// - Chain warps (one per threshold up to MAX_CHAIN, then a warp takes
//   several, one after the other) sit alone on the SM's first scheduler
//   (warps 0, 4, 8, ...); the loader and the producers issue from the
//   other three. A chain warp walks the rows of its threshold's mask in
//   order. `taken` for a threshold lives in shared memory as G bits. Lane
//   j tests list entry j (one shared load and a bit test), a ballot finds
//   the first free entry, and that lane sets the bit and records the row's
//   result in shared memory. A row's list is loaded two rows ahead, so a
//   row adds to the chain only the `taken` load, the ballot and the store;
//   the rows past a list split the walk, so that its loop tests no row for
//   them. A slot's outputs are written once it is walked, 32 rows a store.
//
// Exact: comparisons only, so the result equals the plain version's.
//
// Timing switch (a scratch build, not a mode): -DGNET_ABLATE_CHAIN makes
// the chain's bit test a no-op (no `taken` load, store or warp sync), so
// the chain no longer waits on itself and the kernel runs at the
// producers' pace. Its outputs are wrong and are not read.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_G = 1024;          // 32 words of `taken` bits
constexpr int MAX_T = 32;
constexpr int ROWS = 32;             // rows a slot, one lane each
constexpr int CAP = 32;              // list entries a row, one lane each
constexpr int SLOTS = 8;
constexpr int MAX_CHAIN = 8;         // warps 0, 4, ..., 28
constexpr int LOADER = 1;            // the warp that fills the row buffers
constexpr int PRODUCERS = 23;        // warps 2, 3, 5, 6, 7, 9, ..., 31
constexpr int MAX_BUFS = 8;          // row buffers at most
constexpr int SMEM_MAX = 232448;     // a block's shared memory on sm_90

struct alignas(16) Ring {
  int gt[SLOTS][ROWS][CAP];          // GT indices in list order, 0-padded
  uint8_t len[SLOTS][ROWS][MAX_T];   // prefix with IoU >= thr[t]
  uint32_t rows[SLOTS][MAX_T];       // rows with a list prefix at thr[t]
  uint32_t over[SLOTS][MAX_T];       // rows past a list, at every thr[t]
  float stage_v[PRODUCERS][CAP]; // a producer's candidates, unsorted
  int stage_g[PRODUCERS][CAP];
  int claimed[PRODUCERS];        // candidates a producer has staged
  uint32_t taken[MAX_T][MAX_G / 32];
  int res[MAX_CHAIN][ROWS];          // a chain warp's results of a slot
  float thr[MAX_T];
  uint64_t full[SLOTS];
  uint64_t empty[SLOTS];
  uint64_t loaded[MAX_BUFS];         // a row buffer's copy has landed
  uint64_t freed[MAX_BUFS];          // every producer is done with it
  // then the row buffers: [buffers][rows a buffer * G, rounded to 4]
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}

// Release: this thread's earlier shared-memory accesses are ordered
// before the phase completes for a waiter.
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(smem(bar))
      : "memory");
}

// Acquire: waits until the phase of the given parity has completed. The
// waiting warp is suspended (up to the hint, 10 ms) rather than spinning,
// so it takes no issue slots from the warps that work.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity), "r"(10000000u)
        : "memory");
  }
}

// Rows [n0, n0 + rows) of the image into a row buffer, completing on
// its mbarrier `bar`. VEC 4 (rows of whole 16-byte words): one bulk copy
// by lane 0. VEC 1: a 4-byte cp.async an element by every lane, each
// lane's arrival on `bar` triggered when its copies have landed.
template <int VEC>
__device__ __forceinline__ void load_rows(uint64_t* bar, float* buf,
                                          const float* src, int count,
                                          int lane) {
  const uint32_t b = smem(bar);
  if constexpr (VEC == 4) {
    if (lane == 0) {
      const uint32_t bytes = static_cast<uint32_t>(count) * 4u;
      asm volatile(
          "{\n .reg .b64 state;\n"
          " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}"
          ::"r"(b), "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem(buf)),
          "l"(src), "r"(bytes), "r"(b)
          : "memory");
    }
  } else {
    for (int e = lane; e < count; e += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem(buf + e)),
                   "l"(src + e)
                   : "memory");
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(b)
                 : "memory");
  }
}

// Row r of slot s from its landed buffer `buf`: its list, its prefix per
// threshold, its bit in the slot's row masks. Lane l looks at the columns
// VEC (l + 32 k) + i, i < VEC; a candidate is rare (one column in a
// hundred), so a lane first flags each of its VEC-wide pieces that holds
// one and counts them only there.
template <int VEC>
__device__ __forceinline__ void produce_row(Ring& ring, int p, int s, int r,
                                            const float* buf, int G, int T,
                                            float tmin, int& staged,
                                            int lane) {
  unsigned flags = 0;  // bit k: piece k of this lane holds a candidate
  int k = 0;
  for (int e = lane * VEC; e < G; e += 32 * VEC, ++k) {
    float m;
    if constexpr (VEC == 4) {
      const float4 x = *reinterpret_cast<const float4*>(buf + e);
      m = fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w));
    } else {
      m = buf[e];
    }
    flags |= unsigned(m >= tmin) << k;
  }
  int own = 0;
  for (unsigned f = flags; f; f &= f - 1) {
    const int e = ((__ffs(f) - 1) * 32 + lane) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) own += buf[e + i] >= tmin;
  }
  const int total = __reduce_add_sync(FULL, own);
  if (total == 0) return;  // no candidate: the row stays out of the chain
  if (total > CAP) {       // the chain reads the row itself
    if (lane < T) atomicOr(&ring.over[s][lane], 1u << r);
    return;
  }
  // stage the candidates in any order: positions claimed with one atomic
  // a lane, counted from the candidates of this producer's earlier rows
  float* sv = ring.stage_v[p];
  int* sg = ring.stage_g[p];
  if (own) {
    int at = atomicAdd(&ring.claimed[p], own) - staged;
    for (unsigned f = flags; f; f &= f - 1) {
      const int e = ((__ffs(f) - 1) * 32 + lane) * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float v = buf[e + i];
        if (v >= tmin) {
          sv[at] = v;
          sg[at] = e + i;
          ++at;
        }
      }
    }
  }
  staged += total;
  __syncwarp();
  const float v = lane < total ? sv[lane] : -1.f;
  const int g = lane < total ? sg[lane] : 0;
  __syncwarp();  // read before the next row's candidates overwrite them
  int rank = 0;  // list position: (IoU desc, GT index asc)
  for (int i = 0; i < total; ++i) {
    const float vi = __shfl_sync(FULL, v, i);
    const int gi = __shfl_sync(FULL, g, i);
    rank += vi > v || (vi == v && gi < g);
  }
  // lanes past the list pad it with GT 0, a safe index that no lane below
  // a prefix length reads
  ring.gt[s][r][lane < total ? rank : lane] = lane < total ? g : 0;
  int len = 0;  // lane t: the prefix for threshold t
  for (int t = 0; t < T; ++t) {
    const int l = __popc(__ballot_sync(FULL, lane < total && v >= ring.thr[t]));
    if (lane == t) len = l;
  }
  if (lane < T) {
    ring.len[s][r][lane] = static_cast<uint8_t>(len);
    if (len > 0) atomicOr(&ring.rows[s][lane], 1u << r);
  }
}

// A row with more than CAP candidates at threshold `th`: a warp argmax
// over the whole row, lowest index on ties; lane 0 takes the GT and
// records it as row r's result.
__device__ __noinline__ void chain_full_row(uint32_t* taken, int* res,
                                            int r, float th,
                                            const float* __restrict__ src,
                                            int G, int lane) {
  float bv = -1.f;  // "no candidate" (every threshold is > 0)
  int bi = G;
  for (int k = 0, g = lane; g < G; ++k, g += 32) {
    const float v = src[g];
    if (v >= th && !((taken[k] >> lane) & 1u) && v > bv) {
      bv = v;
      bi = g;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, s);
    const int oi = __shfl_xor_sync(FULL, bi, s);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0 && bi < G) {
    taken[bi >> 5] |= 1u << (bi & 31);
    res[r] = bi;
  }
  __syncwarp();
}

// Threshold t's walk over the rows `rows` of slot s, all with a list, in
// order. The GT a row takes goes to res[row] (left at -1 where it takes
// none). A row's list is loaded two rows ahead of its step.
__device__ __forceinline__ void chain_lists(Ring& ring, int* res, int s,
                                            int t, unsigned rows, int lane) {
  uint32_t* taken = ring.taken[t];
  const unsigned below = (1u << lane) - 1u;
  int left = __popc(rows);
  // a missing row reads row 31, unused
  int r = (__ffs(rows) - 1) & 31;
  rows &= rows - 1;
  int r1 = (__ffs(rows) - 1) & 31;
  rows &= rows - 1;
  int g = ring.gt[s][r][lane], len = ring.len[s][r][t];
  int g1 = ring.gt[s][r1][lane], len1 = ring.len[s][r1][t];
  for (; left > 0; --left) {
    const int r2 = (__ffs(rows) - 1) & 31;
    rows &= rows - 1;
    const int g2 = ring.gt[s][r2][lane], len2 = ring.len[s][r2][t];
    const uint32_t bit = 1u << (g & 31);
#ifdef GNET_ABLATE_CHAIN
    const uint32_t word = 0u;
#else
    const uint32_t word = taken[g >> 5];
#endif
    const bool free = lane < len && !(word & bit);
    const unsigned hits = __ballot_sync(FULL, free);
    if (free && !(hits & below)) {  // the first free entry's lane
#ifndef GNET_ABLATE_CHAIN
      taken[g >> 5] = word | bit;
#endif
      res[r] = g;
    }
#ifndef GNET_ABLATE_CHAIN
    __syncwarp();  // the bit is seen by the next row's load
#endif
    r = r1;
    g = g1;
    len = len1;
    r1 = r2;
    g1 = g2;
    len1 = len2;
  }
}

// Threshold t's walk over slot s: its rows with a list, and between them
// in order the rows past a list (rare) with a whole-row argmax each, so
// that the loop over the lists tests no row for overflow.
__device__ __forceinline__ void chain_slot(Ring& ring, int* res, int s, int t,
                                           int n0, const float* __restrict__ img,
                                           int G, int lane) {
  unsigned rows = ring.rows[s][t];
  unsigned over = ring.over[s][t];
  for (;;) {
    const unsigned stop = over & (0u - over);  // the next overflow row
    const unsigned seg = stop ? rows & (stop - 1) : rows;
    chain_lists(ring, res, s, t, seg, lane);
    if (!stop) break;
    const int r = __ffs(stop) - 1;
    chain_full_row(ring.taken[t], res, r, ring.thr[t],
                   img + static_cast<size_t>(n0 + r) * G, G, lane);
    rows &= ~seg;
    over &= over - 1;
  }
}

template <int VEC>
__global__ void __launch_bounds__(1024, 1)
    greedy_scan_kernel(const float* __restrict__ iou,  // [B, N, G]
                       const float* __restrict__ thr,  // [T]
                       uint8_t* __restrict__ matched,  // [B, N, T]
                       int* __restrict__ best,         // [B, N, T]
                       int N, int G, int T, int chain, int brows,
                       int nbufs) {
  extern __shared__ __align__(16) unsigned char raw[];
  Ring& ring = *reinterpret_cast<Ring*>(raw);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = (N + ROWS - 1) / ROWS;
  const float* img = iou + static_cast<size_t>(b) * N * G;
  matched += static_cast<size_t>(b) * N * T;
  best += static_cast<size_t>(b) * N * T;

  for (int x = threadIdx.x; x < MAX_T * (MAX_G / 32); x += blockDim.x)
    (&ring.taken[0][0])[x] = 0u;
  for (int x = threadIdx.x; x < SLOTS * MAX_T; x += blockDim.x)
    (&ring.rows[0][0])[x] = (&ring.over[0][0])[x] = 0u;
  if (threadIdx.x < T) ring.thr[threadIdx.x] = thr[threadIdx.x];
  if (threadIdx.x < PRODUCERS) ring.claimed[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      bar_init(&ring.full[s], 32 * PRODUCERS);
      bar_init(&ring.empty[s], 32 * chain);
    }
    for (int x = 0; x < nbufs; ++x) {
      bar_init(&ring.loaded[x], VEC == 4 ? 1 : 32);
      bar_init(&ring.freed[x], 32 * PRODUCERS);
    }
  }
  __syncthreads();  // the only block-wide barrier

  float* bufs = reinterpret_cast<float*>(raw + sizeof(Ring));
  const int buf_floats = (brows * G + 3) & ~3;
  if (warp == LOADER) {  // rows brows at a time, `nbufs` buffers ahead
    const int nb = (N + brows - 1) / brows;
    for (int k = 0; k < nb; ++k) {
      const int x = k % nbufs, use = k / nbufs;
      if (use > 0) bar_wait(&ring.freed[x], (use - 1) & 1);
      const int count = min(brows, N - k * brows) * G;
      load_rows<VEC>(&ring.loaded[x], bufs + x * buf_floats,
                     img + static_cast<size_t>(k) * brows * G, count, lane);
    }
    return;
  }
  if (warp % 4 != 0) {  // producer p: rows p, p + PRODUCERS, ...
    const int p = warp - warp / 4 - 2;
    float tmin = ring.thr[0];
    for (int t = 1; t < T; ++t) tmin = fminf(tmin, ring.thr[t]);
    int staged = 0;  // candidates this producer has staged
    const int chunks_b = ROWS / brows;  // row buffers a ring slot
    // every slot and every buffer in order, rows or none, so that each
    // arrival counts toward the use it is meant for
    for (int c = 0; c < chunks; ++c) {
      const int s = c % SLOTS;
      if (c >= SLOTS) bar_wait(&ring.empty[s], (c / SLOTS - 1) & 1);
      for (int k = c * chunks_b; k < (c + 1) * chunks_b; ++k) {
        const int x = k % nbufs;
        const int n0 = k * brows, n1 = min(N, n0 + brows);
        if (n0 >= N) break;
        bar_wait(&ring.loaded[x], (k / nbufs) & 1);
        const float* buf = bufs + x * buf_floats;
        for (int n = n0 + ((p - n0) % PRODUCERS + PRODUCERS) % PRODUCERS;
             n < n1; n += PRODUCERS)
          produce_row<VEC>(ring, p, s, n % ROWS, buf + (n - n0) * G, G, T,
                           tmin, staged, lane);
        bar_arrive(&ring.freed[x]);
      }
      bar_arrive(&ring.full[s]);
    }
    return;
  }

  const int w = warp / 4;  // a chain warp: thresholds w, w + chain, ...
  if (w >= chain) return;
  int* res = ring.res[w];
  for (int c = 0; c < chunks; ++c) {
    const int s = c % SLOTS;
    bar_wait(&ring.full[s], (c / SLOTS) & 1);
    const int n = c * ROWS + lane;
    for (int t = w; t < T; t += chain) {
      res[lane] = -1;
      __syncwarp();
      chain_slot(ring, res, s, t, c * ROWS, img, G, lane);
      __syncwarp();
      const int pick = res[lane];
      __syncwarp();  // read before the next threshold's walk resets it
      if (lane == 0) ring.rows[s][t] = ring.over[s][t] = 0u;
      if (n < N) {
        const size_t o = static_cast<size_t>(n) * T + t;
        matched[o] = pick >= 0 ? 1 : 0;
        best[o] = pick;
      }
    }
    bar_arrive(&ring.empty[s]);
  }
}

template <int VEC>
int launch(const float* iou, const float* thr, uint8_t* matched, int* best,
           int B, int N, int G, int T, cudaStream_t stream) {
  // row buffers of `brows` rows (a divisor of ROWS), two at least
  const size_t room = SMEM_MAX - sizeof(Ring);
  int brows = ROWS;
  auto floats = [&](int rows) { return (rows * G + 3) & ~3; };
  while (brows > 1 && 2 * floats(brows) * sizeof(float) > room) brows /= 2;
  int nbufs = static_cast<int>(room / (floats(brows) * sizeof(float)));
  if (nbufs > MAX_BUFS) nbufs = MAX_BUFS;
  const int smem_bytes =
      static_cast<int>(sizeof(Ring) + nbufs * floats(brows) * sizeof(float));
  const int chain = T < MAX_CHAIN ? T : MAX_CHAIN;
  // above 48 KB of dynamic shared memory: once per device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(greedy_scan_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  // 32 warps: the chain's at 0, 4, ..., the loader at 1, the producers
  greedy_scan_kernel<VEC><<<B, 1024, smem_bytes, stream>>>(
      iou, thr, matched, best, N, G, T, chain, brows, nbufs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest G the kernel takes.
int gnet_greedy_scan_max_g() { return MAX_G; }

// Launches the scan for B images on `stream`; returns the CUDA error of
// the shared-memory attribute or of the launch, 0 when both succeed.
int gnet_greedy_scan(const float* iou, const float* thr, uint8_t* matched,
                     int* best, int B, int N, int G, int T, void* stream) {
  if (B <= 0 || N <= 0 || T <= 0) return 0;
  if (G <= 0 || G > MAX_G || T > MAX_T) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  // 16-byte copies where every row starts on 16 bytes
  if (G % 4 == 0 && reinterpret_cast<uintptr_t>(iou) % 16 == 0)
    return launch<4>(iou, thr, matched, best, B, N, G, T, st);
  return launch<1>(iou, thr, matched, best, B, N, G, T, st);
}

}  // extern "C"
