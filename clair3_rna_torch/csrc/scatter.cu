// Event histogram kernels for Hopper (sm_90a): per-event (position,
// channel[, group, rank]) -> channel-count image [+ first-occurrence group
// ranks].
//
// Replaces the JAX package's Pallas TPU kernels
//   K3  clair3_rna_tpu/ops/fused_scatter.py:131 _kernel, launched from :194
//       fused_scatter (the fused pass's flat-event wire): counts f32
//       [32, W] and group ranks f32 [8, W], 2^30 = empty;
//   K4  clair3_rna_tpu/ops/pileup_kernel.py:36 _kernel, launched from :81
//       _pallas_counts (the pure-array builder's channel counts): int32
//       [length_pad, 32], position-major.
// They compute the same outputs, not the same schedule: the TPU kernels turn
// counting into one-hot bf16 matmuls over a scalar-prefetched visit list of
// (tile, event block) pairs on a sequential grid. Here it is an integer
// histogram. Events arrive bucketed by 256-position tile on the host (a
// stable sort), and one CTA owns one tile: its events are the contiguous
// range [ev_off[t], ev_off[t+1]). The tile's accumulators live in shared
// memory (K3: 32 channels + 6 groups x 256 positions x 4 B = 38 KB; K4:
// 32 x 256 x 4 B = 32 KB, both under the 48 KB static limit); the threads
// stride over the tile's events with atomicAdd on int32 counts and atomicMin
// on int32 ranks. Integer atomics commute, so the result is exact and
// deterministic. Each tile is written once, coalesced, in the output's
// layout.
//
// Inert inputs: an event whose position lies outside this CTA's tile (so
// outside [0, W), which covers pads at W and K4's -1 pads) is skipped, as is
// a channel outside [0, 32); a group outside [0, 6) (star 6, pad 7) takes no
// part in the rank min but still counts.
//
// Bound on an H100: bytes. K3 reads ~10 B/event (pos 4, chan 1, group 1,
// rank 4) and writes 40 x 4 = 160 B/position; K4 reads 5 B/event and writes
// 32 x 4 = 128 B/position; a few integer operations per event are far below
// the compute peak. Before that, atomic contention: a deep pileup sends every
// read at a position to the same four base channels, and those shared-memory
// atomics serialise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int POS_TILE = 256;
constexpr int C_PAD = 32;
constexpr int G_RANK = 6;
constexpr int G_PAD = 8;
constexpr int RANK_INF = 1 << 30;

__global__ void __launch_bounds__(POS_TILE)
fused_scatter_kernel(const int32_t* __restrict__ pos,
                     const int8_t* __restrict__ chan,
                     const int8_t* __restrict__ group,
                     const int32_t* __restrict__ rank,
                     const int32_t* __restrict__ ev_off,
                     long long width,
                     float* __restrict__ counts,
                     float* __restrict__ grank) {
  __shared__ int32_t s_counts[C_PAD * POS_TILE];
  __shared__ int32_t s_rank[G_RANK * POS_TILE];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const long long base = (long long)tile * POS_TILE;
  for (int i = t; i < C_PAD * POS_TILE; i += POS_TILE) s_counts[i] = 0;
  for (int i = t; i < G_RANK * POS_TILE; i += POS_TILE) s_rank[i] = RANK_INF;
  __syncthreads();

  const int e_lo = ev_off[tile];
  const int e_hi = ev_off[tile + 1];
  for (int e = e_lo + t; e < e_hi; e += POS_TILE) {
    const long long p = (long long)pos[e] - base;
    if (p < 0 || p >= POS_TILE) continue;  // not this tile's: inert
    const int c = chan[e];
    if (c >= 0 && c < C_PAD) atomicAdd(&s_counts[c * POS_TILE + p], 1);
    const int g = group[e];
    if (g >= 0 && g < G_RANK) atomicMin(&s_rank[g * POS_TILE + p], rank[e]);
  }
  __syncthreads();

  const long long out = base + t;
#pragma unroll 4
  for (int c = 0; c < C_PAD; ++c)
    counts[c * width + out] = (float)s_counts[c * POS_TILE + t];
#pragma unroll
  for (int g = 0; g < G_PAD; ++g)
    grank[g * width + out] =
        (float)(g < G_RANK ? s_rank[g * POS_TILE + t] : RANK_INF);
}

__global__ void __launch_bounds__(POS_TILE)
pileup_counts_kernel(const int32_t* __restrict__ pos,
                     const int8_t* __restrict__ chan,
                     const int32_t* __restrict__ ev_off,
                     int32_t* __restrict__ out) {
  __shared__ int32_t s_counts[POS_TILE * C_PAD];  // position-major

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const long long base = (long long)tile * POS_TILE;
  for (int i = t; i < POS_TILE * C_PAD; i += POS_TILE) s_counts[i] = 0;
  __syncthreads();

  const int e_lo = ev_off[tile];
  const int e_hi = ev_off[tile + 1];
  for (int e = e_lo + t; e < e_hi; e += POS_TILE) {
    const long long p = (long long)pos[e] - base;
    if (p < 0 || p >= POS_TILE) continue;  // not this tile's: inert
    const int c = chan[e];
    if (c >= 0 && c < C_PAD) atomicAdd(&s_counts[p * C_PAD + c], 1);
  }
  __syncthreads();

  // the tile's [POS_TILE, C_PAD] block is contiguous in the output
  int32_t* dst = out + base * C_PAD;
  for (int i = t; i < POS_TILE * C_PAD; i += POS_TILE) dst[i] = s_counts[i];
}

}  // namespace

// Plain C entry points for ctypes. Each enqueues one launch on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

extern "C" int fused_scatter_launch(const void* pos, const void* chan,
                                    const void* group, const void* rank,
                                    const void* ev_off, int n_tiles,
                                    long long width, void* counts,
                                    void* grank, void* stream) {
  fused_scatter_kernel<<<n_tiles, POS_TILE, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pos), static_cast<const int8_t*>(chan),
      static_cast<const int8_t*>(group), static_cast<const int32_t*>(rank),
      static_cast<const int32_t*>(ev_off), width,
      static_cast<float*>(counts), static_cast<float*>(grank));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pileup_counts_launch(const void* pos, const void* chan,
                                    const void* ev_off, int n_tiles,
                                    void* out, void* stream) {
  pileup_counts_kernel<<<n_tiles, POS_TILE, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pos), static_cast<const int8_t*>(chan),
      static_cast<const int32_t*>(ev_off), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
