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
// (3.7 MB at B=8 N=1024 G=112: ~1.1 us at the card's memory rate) and does
// only comparisons, but every detection depends on the `taken` state left
// by the one before it: N serial warp argmax steps per (b, t) problem.
// The design keeps that chain short: one warp per (b, t), `taken` as a bit
// mask in registers (bit k of lane l <-> GT l + 32k, so G <= 1024), the
// image's rows staged in chunks into shared memory by the whole block (at
// least STAGE_WARPS warps, coalesced, many loads in flight) so a step reads
// shared memory, not device memory, and a 5-shuffle argmax per step.
//
// Exact: comparisons only, so the result equals the plain version's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_G = 1024;           // 32 lanes x 32 mask bits
constexpr int STAGE_FLOATS = 12288;   // 48 KB of staged IoU rows
constexpr int STAGE_WARPS = 8;        // warps that stage, scanning or not

__global__ void greedy_scan_kernel(const float* __restrict__ iou,  // [B, N, G]
                                   const float* __restrict__ thr,  // [T]
                                   uint8_t* __restrict__ matched,  // [B, N, T]
                                   int* __restrict__ best,         // [B, N, T]
                                   int N, int G, int T, int chunk) {
  extern __shared__ float rows[];  // [chunk][G]
  const int b = blockIdx.x;
  const int t = threadIdx.x >> 5;   // one warp per threshold; t >= T stage only
  const int lane = threadIdx.x & 31;
  const float th = t < T ? thr[t] : 0.f;
  const float* src = iou + (size_t)b * N * G;
  uint32_t taken = 0u;

  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int nrows = min(chunk, N - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int x = threadIdx.x; x < nrows * G; x += blockDim.x)
      rows[x] = src[(size_t)c0 * G + x];
    __syncthreads();
    if (t >= T) continue;
    for (int r = 0; r < nrows; ++r) {
      const float* row = rows + r * G;
      float bv = -1.f;  // the kernel's "no candidate" value (t > 0)
      int bi = G;
      for (int k = 0, g = lane; g < G; ++k, g += 32) {
        const float v = row[g];
        if (v >= th && !((taken >> k) & 1u) && v > bv) {
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
      const bool hit = bi < G;
      if (lane == 0) {
        const size_t o = ((size_t)b * N + c0 + r) * T + t;
        matched[o] = hit ? 1 : 0;
        best[o] = hit ? bi : -1;
      }
      if (hit && (bi & 31) == lane) taken |= 1u << (bi >> 5);
    }
  }
}

}  // namespace

extern "C" {

// Largest G the kernel takes.
int gnet_greedy_scan_max_g() { return MAX_G; }

// Launches the scan for B images on `stream`; returns cudaGetLastError().
int gnet_greedy_scan(const float* iou, const float* thr, uint8_t* matched,
                     int* best, int B, int N, int G, int T, void* stream) {
  if (B <= 0 || N <= 0 || T <= 0) return 0;
  if (G <= 0 || G > MAX_G || T > 32) return (int)cudaErrorInvalidValue;
  int chunk = STAGE_FLOATS / G;
  if (chunk > N) chunk = N;
  const size_t smem = (size_t)chunk * G * sizeof(float);
  const int warps = T > STAGE_WARPS ? T : STAGE_WARPS;
  greedy_scan_kernel<<<B, 32 * warps, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      iou, thr, matched, best, N, G, T, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
