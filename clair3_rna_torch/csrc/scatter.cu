// Event histogram kernels for Hopper (sm_90a): per-event (position,
// channel[, group, rank]) -> channel-count image [+ first-occurrence group
// ranks], from events in any order.
//
// Replaces the JAX package's Pallas TPU kernels
//   K3  clair3_rna_tpu/ops/fused_scatter.py:131 _kernel, launched from :194
//       fused_scatter (the fused pass's flat-event wire): counts f32
//       [32, W] and group ranks f32 [8, W], 2^30 = empty;
//   K4  clair3_rna_tpu/ops/pileup_kernel.py:36 _kernel, launched from :81
//       _pallas_counts (the pure-array builder's channel counts): int32
//       [length_pad, 32], position-major.
// They compute the same outputs, not the same schedule. The TPU kernels
// turn counting into one-hot bf16 matmuls over a visit list of (tile,
// event block) pairs, which needs the events bucketed by tile on the host.
// Here the events come in any order (the staging's, read-major) and are
// bucketed by 256-position tile on the card, then counted per tile in
// shared memory:
//   1. bucket_count: each CTA histograms the tiles of its slice of the
//      events in shared memory (one atomic per distinct tile of a warp, so
//      the lanes of a read, which share a tile, cost one) and claims its
//      range inside each tile with one global atomicAdd per tile it
//      touched;
//   2. bucket_scan: one CTA turns the tile totals into tile offsets;
//   3. bucket_scatter: each CTA walks its slice again and writes each live
//      event, packed (K4 2 B: position in tile, channel; K3 8 B: position
//      in tile, channel, group, rank), into its tile's range; the order
//      inside a tile is free. Inert events are dropped here;
//   4. count_tile / scatter_tile: a cluster of CLUSTER CTAs owns one tile
//      (two: on an H100, K4's 782 CTAs then fit one wave and its tile pass
//      ran 1.7x faster than with four). Each CTA accumulates its share of
//      the tile's events in shared memory (channel-major; K4's rows 257
//      words apart, so its atomics spread over the banks), then reduces its
//      share of the tile's positions over the cluster through distributed
//      shared memory, reading whole rows, and writes them once (K4 through
//      a padded position-major block, since its output is position-major).
// Passes 1 and 3 read the events with 16-byte loads (4 positions, 4 ranks)
// and one 4-byte load of 4 channel (and group) bytes, streamed past L2;
// slices are sized for one wave of resident CTAs. They keep one and two
// shared words per tile, so they take the tiles in ranges of at most
// RANGE_TILES (1.57 M positions; a 100 kb chunk is one range), one grid
// row per range, each row reading the events again: any width works.
//
// Integer atomics commute, so the result is exact and the same for any
// event order and any schedule. Inert events: a position outside [0, W)
// (K4: [0, length_pad)) or a channel outside [0, 32) counts nothing and
// takes no rank; a group outside [0, 6) (star 6, pad 7) takes no rank but
// its event still counts. Empty groups and groups 6 and 7 read 2^30.
//
// Bound on an H100: bytes. K3 reads 10 B/event (pos 4, chan 1, group 1,
// rank 4) and writes 40 x 4 = 160 B/position; K4 reads 5 B/event and
// writes 32 x 4 = 128 B/position; each once, over 3.35 TB/s. The integer
// work (a few compares and atomics per event) is far below the compute
// peak. The bucketing moves more than the bound counts (the events read
// twice, the packed events written and read once), and buys shared-memory
// atomics for it: one global L2 atomic per event ran slower for both
// kernels on an H100 (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int QUAD = 4;                         // events per vector load
constexpr long long SLICE_QUANTUM = QUAD * THREADS;
constexpr int C_PAD = 32;
constexpr int G_RANK = 6;
constexpr int G_PAD = 8;
constexpr int RANK_INF = 1 << 30;
constexpr int POS_TILE = 256;
constexpr int TILE_SHIFT = 8;
constexpr int CLUSTER = 2;
constexpr int K4_STRIDE = POS_TILE + 1;
constexpr int SCAN_THREADS = 1024;
// tiles per bucketing range: bucket_scatter's two shared words per tile
// within the 48 KB a kernel gets without opting in to more
constexpr int RANGE_TILES = 48 * 1024 / (2 * sizeof(int));

__device__ __forceinline__ int byte_at(int word, int k) {
  return static_cast<int>(static_cast<int8_t>(word >> (8 * k)));
}

// Events per CTA: a multiple of SLICE_QUANTUM, rounded down so that the grid
// covers at least `waves` waves of resident CTAs (of `kernel` with `smem`
// bytes of dynamic shared memory) once there are events enough.
template <typename Kernel>
cudaError_t slice_events(Kernel kernel, long long n_events, int waves,
                         size_t smem, long long* slice, long long* n_ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)waves * sms * (per_sm > 0 ? per_sm : 1);
  long long s = n_events / resident / SLICE_QUANTUM * SLICE_QUANTUM;
  *slice = s > SLICE_QUANTUM ? s : SLICE_QUANTUM;
  *n_ctas = ((n_events & ~3LL) + *slice - 1) / *slice;
  if (*n_ctas == 0 && (n_events & 3)) *n_ctas = 1;   // the ragged end alone
  return cudaSuccess;
}

template <bool K3>
struct Events {
  const int32_t* pos;
  const int8_t* chan;
  const int8_t* group;   // K3 only
  const int32_t* rank;   // K3 only
  long long n;
  long long limit;       // positions [0, limit) are live
};

template <bool K3>
using Packed = typename std::conditional<K3, uint2, uint16_t>::type;

// Adds the number of lanes with the same key to s[key], one shared atomic
// per distinct key >= 0 of the warp; returns s[key]'s old value plus this
// lane's rank among its peers (meaningless for key < 0). All 32 lanes call.
__device__ __forceinline__ int warp_add(int* s, int key) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (key >= 0 && lane == leader) base = atomicAdd(&s[key], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// f(p, c, g, r) for every event of this CTA's slice, with whole warps
// iterating together (lanes past the end get p = -1, an inert event), so
// that f may use warp primitives. The ragged end goes to warp 0 of the
// first CTA of each grid row.
template <bool K3, typename F>
__device__ __forceinline__ void for_each_event(const Events<K3>& ev,
                                               long long slice, F f) {
  const long long lo = blockIdx.x * slice;
  const long long end = (ev.n & ~3LL) / QUAD;
  const long long hi = min((lo + slice) / QUAD, end);
  const int lane = threadIdx.x & 31;
  for (long long qw = lo / QUAD + (threadIdx.x - lane); qw < hi; qw += THREADS) {
    const long long q = qw + lane;
    int p[QUAD] = {-1, -1, -1, -1}, c[QUAD] = {}, g[QUAD] = {}, r[QUAD] = {};
    if (q < hi) {
      const int4 pv = __ldcs(reinterpret_cast<const int4*>(ev.pos) + q);
      const int cw = __ldcs(reinterpret_cast<const int*>(ev.chan) + q);
      p[0] = pv.x; p[1] = pv.y; p[2] = pv.z; p[3] = pv.w;
      if constexpr (K3) {
        const int4 rv = __ldcs(reinterpret_cast<const int4*>(ev.rank) + q);
        const int gw = __ldcs(reinterpret_cast<const int*>(ev.group) + q);
        r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
#pragma unroll
        for (int k = 0; k < QUAD; ++k) g[k] = byte_at(gw, k);
      }
#pragma unroll
      for (int k = 0; k < QUAD; ++k) c[k] = byte_at(cw, k);
    }
#pragma unroll
    for (int k = 0; k < QUAD; ++k) f(p[k], c[k], g[k], r[k]);
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const long long e = end * QUAD + lane;
    const bool on = lane < (ev.n & 3);
    f(on ? ev.pos[e] : -1, on ? (int)ev.chan[e] : 0,
      (K3 && on) ? (int)ev.group[e] : 0, (K3 && on) ? ev.rank[e] : 0);
  }
}

// This grid row's tiles: [*t0, *t0 + *n).
__device__ __forceinline__ void range_of_row(int n_tiles, int* t0, int* n) {
  *t0 = blockIdx.y * RANGE_TILES;
  *n = min(n_tiles - *t0, RANGE_TILES);
}

// A live event's tile, relative to this row's range [t0, t0 + n); -1 for
// an inert event or one outside the range.
template <bool K3>
__device__ __forceinline__ int tile_key(const Events<K3>& ev, int p, int c,
                                        int t0, int n) {
  const bool live = (unsigned)p < (unsigned long long)ev.limit &&
                    (unsigned)c < C_PAD;
  const int t = (p >> TILE_SHIFT) - t0;
  return live && (unsigned)t < (unsigned)n ? t : -1;
}

template <bool K3>
__global__ void __launch_bounds__(THREADS)
bucket_count_kernel(Events<K3> ev, long long slice, int n_tiles,
                    int* __restrict__ tile_count, int* __restrict__ cta_base) {
  extern __shared__ int s_hist[];
  int t0, n;
  range_of_row(n_tiles, &t0, &n);
  for (int t = threadIdx.x; t < n; t += THREADS) s_hist[t] = 0;
  __syncthreads();
  for_each_event(ev, slice, [&](int p, int c, int, int) {
    warp_add(s_hist, tile_key(ev, p, c, t0, n));
  });
  __syncthreads();
  int* base = cta_base + (long long)blockIdx.x * n_tiles + t0;
  for (int t = threadIdx.x; t < n; t += THREADS) {
    const int h = s_hist[t];
    base[t] = h ? atomicAdd(&tile_count[t0 + t], h) : 0;
  }
}

// One CTA: tile_off[t] = sum of tile_count[:t], tile_off[n_tiles] = total.
__global__ void __launch_bounds__(SCAN_THREADS)
bucket_scan_kernel(const int* __restrict__ tile_count, int n_tiles,
                   int* __restrict__ tile_off) {
  __shared__ int s_warp[SCAN_THREADS / 32];
  const int tid = threadIdx.x;
  const int per = (n_tiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(tid * per, n_tiles), hi = min(lo + per, n_tiles);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += tile_count[t];
  const int lane = tid & 31, w = tid >> 5;
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int v = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    s_warp[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (w ? s_warp[w - 1] : 0);
  for (int t = lo; t < hi; ++t) {
    tile_off[t] = run;
    run += tile_count[t];
  }
  if (tid == SCAN_THREADS - 1) tile_off[n_tiles] = run;
}

template <bool K3>
__global__ void __launch_bounds__(THREADS)
bucket_scatter_kernel(Events<K3> ev, long long slice, int n_tiles,
                      const int* __restrict__ tile_off,
                      const int* __restrict__ cta_base,
                      Packed<K3>* __restrict__ sorted) {
  extern __shared__ int s_mem[];
  int t0, n;
  range_of_row(n_tiles, &t0, &n);
  int* s_base = s_mem;
  int* s_fill = s_mem + n;
  const int* base = cta_base + (long long)blockIdx.x * n_tiles + t0;
  for (int t = threadIdx.x; t < n; t += THREADS) {
    s_base[t] = tile_off[t0 + t] + base[t];
    s_fill[t] = 0;
  }
  __syncthreads();
  for_each_event(ev, slice, [&](int p, int c, int g, int r) {
    const int key = tile_key(ev, p, c, t0, n);
    const int slot = warp_add(s_fill, key);
    if (key < 0) return;
    const int x = (p & (POS_TILE - 1)) | (c << 8);
    if constexpr (K3)
      sorted[s_base[key] + slot] = make_uint2(x | ((g & 0xff) << 16), r);
    else
      sorted[s_base[key] + slot] = static_cast<uint16_t>(x);
  });
}

// This CTA's share of its tile's events: [*lo, *hi).
__device__ __forceinline__ void cluster_range(const int* tile_off, int tile,
                                              int rank, int* lo, int* hi) {
  const int e0 = tile_off[tile], e1 = tile_off[tile + 1];
  const int span = (e1 - e0 + CLUSTER - 1) / CLUSTER;
  *lo = min(e0 + rank * span, e1);
  *hi = min(*lo + span, e1);
}

// K4: one cluster per tile -> out[p * 32 + c], position-major. The
// cluster reduction reads each remote image row by row (contiguous, as
// distributed shared memory wants it) into a local position-major block,
// which is then written out whole.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
count_tile_kernel(const uint16_t* __restrict__ sorted,
                  const int* __restrict__ tile_off, long long length_pad,
                  int* __restrict__ out) {
  constexpr int N_POS = POS_TILE / CLUSTER;     // this CTA's positions
  constexpr int OUT_POS = 64;                   // per write-out block
  __shared__ int s_counts[C_PAD * K4_STRIDE];   // [channel][position]
  __shared__ int s_out[OUT_POS * (C_PAD + 1)];  // [position][channel]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int tile = blockIdx.x / CLUSTER;
  for (int i = threadIdx.x; i < C_PAD * K4_STRIDE; i += THREADS) s_counts[i] = 0;
  __syncthreads();
  int lo, hi;
  cluster_range(tile_off, tile, rank, &lo, &hi);
  for (int e = lo + threadIdx.x; e < hi; e += THREADS) {
    const int v = sorted[e];
    atomicAdd(&s_counts[(v >> 8) * K4_STRIDE + (v & (POS_TILE - 1))], 1);
  }
  cluster.sync();
  // this CTA's share of the positions, summed over the cluster
  for (int b = 0; b < N_POS; b += OUT_POS) {
    for (int j = threadIdx.x; j < OUT_POS * C_PAD; j += THREADS) {
      const int c = j / OUT_POS, p = j % OUT_POS;
      int sum = 0;
#pragma unroll
      for (int k = 0; k < CLUSTER; ++k)
        sum += cluster.map_shared_rank(s_counts, k)[c * K4_STRIDE +
                                                    rank * N_POS + b + p];
      s_out[p * (C_PAD + 1) + c] = sum;
    }
    __syncthreads();
    const long long p0 = (long long)tile * POS_TILE + rank * N_POS + b;
    for (int j = threadIdx.x; j < OUT_POS * C_PAD; j += THREADS) {
      const int p = j / C_PAD, c = j % C_PAD;
      if (p0 + p < length_pad)
        out[(p0 + p) * C_PAD + c] = s_out[p * (C_PAD + 1) + c];
    }
    __syncthreads();
  }
  cluster.sync();   // keep this CTA's image alive for the others' reads
}

// K3: one cluster per tile -> counts[c * W + p], grank[g * W + p].
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
scatter_tile_kernel(const uint2* __restrict__ sorted,
                    const int* __restrict__ tile_off, long long width,
                    float* __restrict__ counts, float* __restrict__ grank) {
  __shared__ int s_counts[C_PAD * POS_TILE];
  __shared__ int s_rank[G_RANK * POS_TILE];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int tile = blockIdx.x / CLUSTER;
  for (int i = threadIdx.x; i < C_PAD * POS_TILE; i += THREADS) s_counts[i] = 0;
  for (int i = threadIdx.x; i < G_RANK * POS_TILE; i += THREADS)
    s_rank[i] = RANK_INF;
  __syncthreads();
  int lo, hi;
  cluster_range(tile_off, tile, rank, &lo, &hi);
  for (int e = lo + threadIdx.x; e < hi; e += THREADS) {
    const uint2 v = sorted[e];
    const int p = v.x & (POS_TILE - 1);
    const int c = (v.x >> 8) & 0xff;
    const int g = static_cast<int8_t>(v.x >> 16);
    atomicAdd(&s_counts[c * POS_TILE + p], 1);
    if ((unsigned)g < G_RANK)
      atomicMin(&s_rank[g * POS_TILE + p], static_cast<int>(v.y));
  }
  cluster.sync();
  constexpr int N_POS = POS_TILE / CLUSTER;
  for (int j = threadIdx.x; j < N_POS * (C_PAD + G_PAD); j += THREADS) {
    const int row = j / N_POS, p = rank * N_POS + j % N_POS;
    const long long gp = (long long)tile * POS_TILE + p;
    float v;
    if (row < C_PAD) {
      int sum = 0;
#pragma unroll
      for (int k = 0; k < CLUSTER; ++k)
        sum += cluster.map_shared_rank(s_counts, k)[row * POS_TILE + p];
      v = (float)sum;
    } else if (row - C_PAD < G_RANK) {
      int m = RANK_INF;
#pragma unroll
      for (int k = 0; k < CLUSTER; ++k)
        m = min(m, cluster.map_shared_rank(s_rank, k)[(row - C_PAD) * POS_TILE + p]);
      v = (float)m;
    } else {
      v = (float)RANK_INF;
    }
    if (gp < width) {
      if (row < C_PAD) counts[row * width + gp] = v;
      else grank[(row - C_PAD) * width + gp] = v;
    }
  }
  cluster.sync();
}

// The bucketing's launch shape and scratch, carved from one buffer: the
// packed sorted events first (16-byte aligned), then tile_count, tile_off
// and cta_base (int32).
template <bool K3>
struct BucketPlan {
  long long slice, n_ctas;
  int n_tiles, n_ranges;
  size_t smem_count, smem_scatter;
  size_t sorted_bytes, bytes;
};

template <bool K3>
cudaError_t bucket_plan(long long n_events, long long limit,
                        BucketPlan<K3>* plan) {
  // events index int32 tile ranges; positions are int32
  if (n_events < 0 || n_events > INT_MAX || limit <= 0 ||
      limit > (long long)INT_MAX + 1)
    return cudaErrorInvalidValue;
  plan->n_tiles = (int)((limit + POS_TILE - 1) / POS_TILE);
  plan->n_ranges = (plan->n_tiles + RANGE_TILES - 1) / RANGE_TILES;
  const int range = min(plan->n_tiles, RANGE_TILES);
  plan->smem_count = range * sizeof(int);
  plan->smem_scatter = 2 * range * sizeof(int);
  cudaError_t err = slice_events(bucket_scatter_kernel<K3>, n_events, 1,
                                 plan->smem_scatter, &plan->slice,
                                 &plan->n_ctas);
  if (err != cudaSuccess) return err;
  plan->sorted_bytes =
      ((n_events * sizeof(Packed<K3>) + 15) / 16) * 16;
  plan->bytes = plan->sorted_bytes +
                sizeof(int) * (2 * (size_t)plan->n_tiles + 1 +
                               (size_t)plan->n_ctas * plan->n_tiles);
  return cudaSuccess;
}

// Enqueues passes 1-3; on return *sorted and *tile_off lie in `scratch`.
template <bool K3>
cudaError_t bucket_events(const Events<K3>& ev, void* scratch,
                          size_t scratch_bytes, cudaStream_t s,
                          const Packed<K3>** sorted, const int** tile_off,
                          int* n_tiles) {
  BucketPlan<K3> plan;
  cudaError_t err = bucket_plan(ev.n, ev.limit, &plan);
  if (err != cudaSuccess) return err;
  if (scratch_bytes < plan.bytes) return cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  Packed<K3>* out = reinterpret_cast<Packed<K3>*>(base);
  int* tile_count = reinterpret_cast<int*>(base + plan.sorted_bytes);
  int* off = tile_count + plan.n_tiles;
  int* cta_base = off + plan.n_tiles + 1;
  err = cudaMemsetAsync(tile_count, 0, plan.n_tiles * sizeof(int), s);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)plan.n_ctas, (unsigned)plan.n_ranges);
  if (plan.n_ctas > 0)
    bucket_count_kernel<K3><<<grid, THREADS, plan.smem_count, s>>>(
        ev, plan.slice, plan.n_tiles, tile_count, cta_base);
  bucket_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(tile_count, plan.n_tiles, off);
  if (plan.n_ctas > 0)
    bucket_scatter_kernel<K3><<<grid, THREADS, plan.smem_scatter, s>>>(
        ev, plan.slice, plan.n_tiles, off, cta_base, out);
  *sorted = out;
  *tile_off = off;
  *n_tiles = plan.n_tiles;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each enqueues the whole operation on
// `stream` (a memset and launches), does not synchronise, allocates
// nothing, and returns the first error (or cudaGetLastError()). pos and
// rank must be 16-byte aligned, chan and group 4-byte aligned; `scratch`
// holds scatter_scratch_bytes(...) bytes, 16-byte aligned.

extern "C" long long scatter_scratch_bytes(int k3, long long n_events,
                                           long long limit) {
  if (k3) {
    BucketPlan<true> plan;
    if (bucket_plan(n_events, limit, &plan) != cudaSuccess) return -1;
    return (long long)plan.bytes;
  }
  BucketPlan<false> plan;
  if (bucket_plan(n_events, limit, &plan) != cudaSuccess) return -1;
  return (long long)plan.bytes;
}

extern "C" int fused_scatter_launch(const void* pos, const void* chan,
                                    const void* group, const void* rank,
                                    long long n_events, long long width,
                                    void* counts, void* grank, void* scratch,
                                    long long scratch_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Events<true> ev{static_cast<const int32_t*>(pos),
                        static_cast<const int8_t*>(chan),
                        static_cast<const int8_t*>(group),
                        static_cast<const int32_t*>(rank), n_events, width};
  const uint2* sorted = nullptr;
  const int* tile_off = nullptr;
  int n_tiles = 0;
  cudaError_t err = bucket_events(ev, scratch, (size_t)scratch_bytes, s,
                                  &sorted, &tile_off, &n_tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_tile_kernel<<<(unsigned)n_tiles * CLUSTER, THREADS, 0, s>>>(
      sorted, tile_off, width, static_cast<float*>(counts),
      static_cast<float*>(grank));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pileup_counts_launch(const void* pos, const void* chan,
                                    long long n_events, long long length_pad,
                                    void* out, void* scratch,
                                    long long scratch_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Events<false> ev{static_cast<const int32_t*>(pos),
                         static_cast<const int8_t*>(chan), nullptr, nullptr,
                         n_events, length_pad};
  const uint16_t* sorted = nullptr;
  const int* tile_off = nullptr;
  int n_tiles = 0;
  cudaError_t err = bucket_events(ev, scratch, (size_t)scratch_bytes, s,
                                  &sorted, &tile_off, &n_tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_tile_kernel<<<(unsigned)n_tiles * CLUSTER, THREADS, 0, s>>>(
      sorted, tile_off, length_pad, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
