// Tilelet expansion kernel for Hopper (sm_90a): packed read rows ->
// channel-count image + first-occurrence group ranks.
//
// Replaces the JAX package's Pallas TPU kernels
//   K1  clair3_rna_tpu/ops/tilelet.py:283 _make_kernel_v2 (v2 wire: 2-bit
//       crumbs + validity bitmap, 96 B/row), launched from :395
//       tilelet_expand_v2, and
//   K2  clair3_rna_tpu/ops/tilelet.py:190 _make_kernel (nibble wire, 128
//       B/row), launched from :470 tilelet_expand.
// It computes the same outputs, not the same schedule: the TPU kernels walk
// a scalar-prefetched visit list on a sequential grid and carry per-tile
// accumulators in VMEM between grid steps. Here one CTA owns one 256-
// position tile, one thread owns one position, and the tile's rows are the
// contiguous range [row_off[t], row_off[t+1]) of the tile-sorted input.
// Rows are staged through shared memory in coalesced 32-bit loads; each
// thread decodes its slot of every staged row and keeps its counts (8, or 16
// phased) and its 4 min ranks in registers. Outputs go straight to genome
// order (counts[c * W + pos], grank[g * W + pos]), so neither the v2
// kernel's plane weave nor the nibble kernel's even/odd interleave exists.
// No atomics: every output is written once, by one thread, so the result is
// exact and deterministic.
//
// Bound on an H100: bytes. Per 100 kb chunk the kernel reads ~2-3 MB of
// rows and writes 40 * W * 4 B (W = 131072 for a 100 kb chunk: ~21 MB) of
// f32 image, against 4 integer compares per row-slot; the output write
// dominates, so the floor is ~(rows + 160 * W) bytes / 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int POS_TILE = 256;
constexpr int C_PAD = 32;
constexpr int G_PAD = 8;
constexpr int STAGE_ROWS = 64;
constexpr int RANK_INF = 1 << 30;

template <bool V2>
struct WireLayout;

template <>
struct WireLayout<true> {   // 2-bit crumbs + validity bitmap
  static constexpr int kCodeBytes = POS_TILE / 4;
  static constexpr int kValidBytes = POS_TILE / 8;
};

template <>
struct WireLayout<false> {  // nibbles, EMPTY = 15
  static constexpr int kCodeBytes = POS_TILE / 2;
  static constexpr int kValidBytes = 4;  // unused; keeps the array non-empty
};

template <bool V2, bool PHASED>
__global__ void __launch_bounds__(POS_TILE)
tilelet_kernel(const uint8_t* __restrict__ codes,
               const uint8_t* __restrict__ valid,
               const int32_t* __restrict__ row_off,
               const int32_t* __restrict__ rank,
               const int8_t* __restrict__ strand,
               const int8_t* __restrict__ hp,
               long long width,
               float* __restrict__ counts,
               float* __restrict__ grank) {
  constexpr int kCB = WireLayout<V2>::kCodeBytes;
  constexpr int kVB = WireLayout<V2>::kValidBytes;
  __shared__ uint32_t s_codes[STAGE_ROWS * kCB / 4];
  __shared__ uint32_t s_valid[STAGE_ROWS * kVB / 4];
  __shared__ int32_t s_rank[STAGE_ROWS];
  __shared__ int8_t s_strand[STAGE_ROWS];
  __shared__ int8_t s_hp[STAGE_ROWS];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int r_lo = row_off[tile];
  const int r_hi = row_off[tile + 1];

  int fwd[4] = {0, 0, 0, 0};
  int rev[4] = {0, 0, 0, 0};
  int hp1[4] = {0, 0, 0, 0};
  int hp2[4] = {0, 0, 0, 0};
  int minr[4] = {RANK_INF, RANK_INF, RANK_INF, RANK_INF};

  const uint8_t* sc = reinterpret_cast<const uint8_t*>(s_codes);
  const uint8_t* sv = reinterpret_cast<const uint8_t*>(s_valid);

  for (int r0 = r_lo; r0 < r_hi; r0 += STAGE_ROWS) {
    const int n = min(STAGE_ROWS, r_hi - r0);
    __syncthreads();  // the previous stage has been consumed
    const uint32_t* gc =
        reinterpret_cast<const uint32_t*>(codes + (long long)r0 * kCB);
    for (int i = p; i < n * (kCB / 4); i += POS_TILE) s_codes[i] = gc[i];
    if (V2) {
      const uint32_t* gv =
          reinterpret_cast<const uint32_t*>(valid + (long long)r0 * kVB);
      for (int i = p; i < n * (kVB / 4); i += POS_TILE) s_valid[i] = gv[i];
    }
    if (p < n) {
      s_rank[p] = rank[r0 + p];
      s_strand[p] = strand[r0 + p];
      s_hp[p] = hp[r0 + p];
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      int code;
      if (V2) {
        const int bit = (sv[j * kVB + (p >> 3)] >> (p & 7)) & 1;
        code = bit ? (sc[j * kCB + (p >> 2)] >> (2 * (p & 3))) & 3 : 4;
      } else {
        const int b = sc[j * kCB + (p >> 1)];
        code = (p & 1) ? (b & 15) : (b >> 4);
      }
      if (code >= 4) continue;  // hole: no count, no rank
      const int s = s_strand[j];
      const int rk = s_rank[j];
      const int h = s_hp[j];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = (code == c);
        fwd[c] += m & (s == 0);
        rev[c] += m & (s == 1);
        if (PHASED) {
          hp1[c] += m & (h == 1);
          hp2[c] += m & (h == 2);
        }
        minr[c] = (m && rk < minr[c]) ? rk : minr[c];
      }
    }
  }

  const long long pos = (long long)tile * POS_TILE + p;
#pragma unroll
  for (int c = 0; c < C_PAD; ++c) {
    int v = 0;
    if (c < 4) v = fwd[c];
    else if (c >= 9 && c < 13) v = rev[c - 9];
    else if (PHASED && c >= 18 && c < 22) v = hp1[c - 18];
    else if (PHASED && c >= 24 && c < 28) v = hp2[c - 24];
    counts[c * width + pos] = (float)v;
  }
#pragma unroll
  for (int g = 0; g < G_PAD; ++g) {
    grank[g * width + pos] = (float)(g < 4 ? minr[g] : RANK_INF);
  }
}

template <bool V2, bool PHASED>
void launch(const void* codes, const void* valid, const void* row_off,
            const void* rank, const void* strand, const void* hp,
            int n_tiles, long long width, void* counts, void* grank,
            cudaStream_t stream) {
  tilelet_kernel<V2, PHASED><<<n_tiles, POS_TILE, 0, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(row_off), static_cast<const int32_t*>(rank),
      static_cast<const int8_t*>(strand), static_cast<const int8_t*>(hp),
      width, static_cast<float*>(counts), static_cast<float*>(grank));
}

}  // namespace

// Plain C entry point for ctypes. Enqueues on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int tilelet_expand_launch(int wire_v2, int phased,
                                     const void* codes, const void* valid,
                                     const void* row_off, const void* rank,
                                     const void* strand, const void* hp,
                                     int n_tiles, long long width,
                                     void* counts, void* grank,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wire_v2) {
    if (phased)
      launch<true, true>(codes, valid, row_off, rank, strand, hp, n_tiles,
                         width, counts, grank, st);
    else
      launch<true, false>(codes, valid, row_off, rank, strand, hp, n_tiles,
                          width, counts, grank, st);
  } else {
    if (phased)
      launch<false, true>(codes, valid, row_off, rank, strand, hp, n_tiles,
                          width, counts, grank, st);
    else
      launch<false, false>(codes, valid, row_off, rank, strand, hp, n_tiles,
                           width, counts, grank, st);
  }
  return static_cast<int>(cudaGetLastError());
}
