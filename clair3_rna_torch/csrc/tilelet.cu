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
// accumulators in VMEM between grid steps. Outputs go straight to genome
// order (counts[c * W + pos], grank[g * W + pos]), so neither the v2
// kernel's plane weave nor the nibble kernel's even/odd interleave exists.
//
// What bounds it on an H100. Bytes: each row is read once (96 or 128 B
// plus 6 B of rank, strand, hp) and 40 f32 are written per position (160
// B/position: ~21 MB for a 100 kb chunk, W = 131,072), over 3.35 TB/s.
// Then the decode: one compare-and-add per (row, slot, code) costs more
// integer instructions than the bytes allow. And on a deep tile (hundreds
// of rows on ~325x coverage, thousands at real lrRNA gene depth) the time is
// the serial walk over the tile's rows, unless they are split: one SM
// issues ~100 instructions a row, so 20,000 rows take it ~0.3 ms at best.
//
// The design:
// - A warp owns a whole 256-position row; lane l owns positions 8l..8l+7,
//   so one 2-byte crumb load + one validity byte (v2) or one 4-byte nibble
//   load serves 8 slots. A slot's count is one shift and one add: per
//   position, four 8-bit counters (one per base) in one 32-bit word, fwd
//   and rev (and hp1/hp2 phased) in separate words chosen by warp-uniform
//   branches on the row's strand (hp). An invalid slot shifts by >= 32,
//   which PTX's shl clamps to 0.
// - Min rank, exact for any row order: a warp walks its rows in runs of
//   ascending rank (real staging is rank-ascending within a tile, so one
//   run per tile). Within a run, a (position, base)'s min rank is that of
//   its first row, so a slot only records the run-local index of that row
//   in an 8-bit lane (one and-not, one or, one multiply-add). A row whose
//   rank drops below the run's last, or the 256th row, ends the run: the
//   run's counters and first indices are flushed into the CTA's shared
//   int32 image (shared atomics; the index becomes the row's rank, kept in
//   a per-warp ring in shared memory).
// - The rows of a tile are split across the CTA's 4 warps (row j of a
//   stage to warp j % 4) and, where the tile is deep, across the CTAs of a
//   cluster. The cluster size CS (1, 2, 4 or 8) comes from the deepest
//   tile's row count, which the host staging knows for free: the fewest
//   CTAs that keep each under ~192 rows. A cluster takes a group of CS
//   consecutive tiles and splits each tile by its own rows (1 .. CS ways),
//   packing the splits into rounds of CS CTAs, widest first; so one deep
//   gene among shallow tiles is split and the shallow tiles are not, and a
//   chunk with no deep tile runs one CTA a tile with no cluster at all.
//   Each CTA takes a contiguous share of its tile's rows. At the tile's end
//   each warp's packed counters are summed in shared memory (16-bit
//   lanes), then each CTA writes its share of the tile's 40 x 64 float4
//   outputs, summing the images of the tile's CTAs through distributed
//   shared memory. No global atomics: every output is written once, so the
//   result is exact and deterministic.
// - Staging is asynchronous and double-buffered: cp.async copies the next
//   stage (128 rows on the v2 wire, 64 on the nibble wire; a tile's rows
//   are one contiguous byte range) while the current one decodes.
// - With more groups than fit the card at once the grid is one persistent
//   wave striding over them, so one tile's streaming stores drain while
//   the next tile decodes; with fewer, each group's rounds spread over
//   several clusters. An empty tile writes its constants and does nothing
//   else.
// Rows must be tile-sorted: tile t owns rows [row_off[t], row_off[t+1]),
// and row_off[n_tiles] <= n_rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int POS_TILE = 256;
constexpr int QUADS = POS_TILE / 4;   // float4 columns of one channel row
constexpr int C_PAD = 32;
constexpr int G_PAD = 8;
constexpr int OUT_ROWS = C_PAD + G_PAD;
constexpr int NW = 4;                 // warps per CTA
constexpr int NT = NW * 32;
// rows per staged buffer: a typical tile's rows in one v2 stage; the
// nibble wire's 128-byte rows take smaller stages, so more CTAs fit an SM
constexpr int STAGE_V2 = 128;
constexpr int STAGE_NIBBLE = 64;
constexpr int RUN_MAX = 255;          // rows per run: 8-bit lanes
constexpr int RANK_INF = 1 << 30;
constexpr int MAX_CLUSTER = 8;        // CTAs a cluster (portable limit)
// rows a CTA takes of a tile before the tile is split further
constexpr int ROWS_PER_CTA = 192;

template <bool V2, bool PHASED>
struct Layout {
  static constexpr int kCode = V2 ? POS_TILE / 4 : POS_TILE / 2;
  static constexpr int kValid = V2 ? POS_TILE / 8 : 0;
  static constexpr int kTypes = PHASED ? 4 : 2;   // fwd, rev[, hp1, hp2]
  static constexpr int kRows = V2 ? STAGE_V2 : STAGE_NIBBLE;
  static constexpr int kMeta = kRows + 16;  // strand / hp bytes of a stage
  // one stage buffer: codes, validity, rank, strand, hp (16 B multiples)
  static constexpr int kOffValid = kRows * kCode;
  static constexpr int kOffRank = kOffValid + kRows * kValid;
  static constexpr int kOffStrand = kOffRank + kRows * 4;
  static constexpr int kOffHp = kOffStrand + kMeta;
  static constexpr int kStage = kOffHp + kMeta;
  // the CTA's tile image: int32 counts [kTypes * 4][256], ranks [4][256],
  // and the warps' packed counters [NW][kTypes][256]
  static constexpr int kOffAcc = 2 * kStage;
  static constexpr int kOffRacc = kOffAcc + kTypes * 4 * POS_TILE * 4;
  static constexpr int kOffPart = kOffRacc + 4 * POS_TILE * 4;
  // each warp's ranks of its run's rows, by run-local index
  static constexpr int kOffRing = kOffPart + NW * kTypes * POS_TILE * 4;
  static constexpr int kBytes = kOffRing + NW * (RUN_MAX + 1) * 4;
};

__device__ __forceinline__ uint32_t shl_clamp(uint32_t x, uint32_t s) {
  uint32_t r;  // PTX shl: a shift of 32 or more gives 0
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One CTA's share of a round: tile `tile` (>= n_tiles: none), split `s`
// ways, part `part`, rows [lo, hi). `wide` is cluster-uniform: the round
// holds a split tile, so the whole cluster syncs.
struct Item {
  int tile, s, part, lo, hi;
  bool wide;
};

// A group of CS consecutive tiles, taken by a cluster of CS CTAs. Each
// tile is split s = 1, 2, .. CS ways by its own rows (log2 s in 2 bits a
// tile; s CTAs take at most ROWS_PER_CTA rows each unless s = CS), and the
// splits are packed into rounds of CS CTAs, widest first, so no tile
// straddles two rounds. The tiles' row offsets stay in registers.
template <int CS>
struct Group {
  static constexpr int LG_MAX = CS >= 8 ? 3 : CS >= 4 ? 2 : CS >= 2 ? 1 : 0;
  int t0, n;         // first tile, tiles in the group
  int off[CS + 1];   // row_off[t0 ..]
  uint32_t lg;
  int rounds, n_wide;     // rounds; CTA slots of the split tiles

  __device__ void load(const int32_t* row_off, int n_tiles, int g) {
    t0 = g * CS;
    n = min(CS, n_tiles - t0);
#pragma unroll
    for (int i = 0; i <= CS; ++i) off[i] = row_off[min(t0 + i, n_tiles)];
    lg = 0;
    n_wide = 0;
    int slots = 0;
#pragma unroll
    for (int i = 0; i < CS; ++i) {
      const int rows = off[i + 1] - off[i];
      int l = 0;
      while (l < LG_MAX && rows > (ROWS_PER_CTA << l)) ++l;
      if (i < n) {
        lg |= static_cast<uint32_t>(l) << (2 * i);
        slots += 1 << l;
        if (l) n_wide += 1 << l;
      }
    }
    rounds = (slots + CS - 1) / CS;
  }
  // CTA `cr`'s share of round k
  __device__ Item at(int k, int cr, int n_tiles) const {
    Item it{n_tiles, 1, 0, 0, 0, k * CS < n_wide};
    const int p = k * CS + cr;  // the CTA's slot in the packing
    int a = 0, b = 0;
    if (n_wide == 0) {  // no split: slot p is tile t0 + p
#pragma unroll
      for (int i = 0; i < CS; ++i)
        if (i == p && i < n) {
          it.tile = t0 + i;
          a = off[i];
          b = off[i + 1];
        }
    } else {
      int o = 0;
      bool found = false;
#pragma unroll
      for (int l = LG_MAX; l >= 0; --l)
#pragma unroll
        for (int i = 0; i < CS; ++i) {
          if (i >= n || static_cast<int>((lg >> (2 * i)) & 3u) != l) continue;
          if (!found && p < o + (1 << l)) {
            found = true;
            it.tile = t0 + i;
            it.s = 1 << l;
            it.part = p - o;
            a = off[i];
            b = off[i + 1];
          }
          o += 1 << l;
        }
    }
    const int per = (b - a + it.s - 1) / it.s;
    it.lo = min(a + it.part * per, b);
    it.hi = min(it.lo + per, b);
    return it;
  }
};

// The rounds a cluster takes. With more clusters than groups, m = n_cl /
// n_groups clusters share each group's rounds (cluster cl takes group cl %
// n_groups, rounds k0, k0 + m, ... with k0 = cl / n_groups < m); with
// fewer (a persistent wave), cluster cl takes groups cl, cl + n_cl, ...,
// all rounds of each.
template <int CS>
struct Walk {
  const int32_t* row_off;
  int n_tiles, n_groups, n_cl, m, k0, cr;
  Group<CS> grp;
  int g, k;

  __device__ Walk(const int32_t* ro, int nt, int n_cl_, int cl, int cr_)
      : row_off(ro), n_tiles(nt), n_groups((nt + CS - 1) / CS),
        n_cl(n_cl_), cr(cr_) {
    grp.t0 = grp.n = grp.rounds = grp.n_wide = 0;
    grp.lg = 0;
    m = max(1, n_cl / n_groups);
    k0 = cl / n_groups;
    g = k0 < m ? cl % n_groups : n_groups;
    k = k0;
    if (g < n_groups) grp.load(row_off, n_tiles, g);
    settle();
  }
  __device__ void settle() {  // on to the next round this cluster takes
    while (g < n_groups && k >= grp.rounds) {
      g += n_cl;
      k = k0;
      if (g < n_groups) grp.load(row_off, n_tiles, g);
    }
  }
  __device__ bool done() const { return g >= n_groups; }
  __device__ Item item() const { return grp.at(k, cr, n_tiles); }
  __device__ void next() {
    k += m;
    settle();
  }
};

// Output channel row c (0..31) -> row of the tile image, or -1 (constant).
template <bool PHASED>
__device__ __forceinline__ int image_row(int c) {
  if (c < 4) return c;
  if (c >= 9 && c < 13) return 4 + c - 9;
  if (PHASED && c >= 18 && c < 22) return 8 + c - 18;
  if (PHASED && c >= 24 && c < 28) return 12 + c - 24;
  return -1;
}

template <bool V2, bool PHASED, int CS>
__global__ void __launch_bounds__(NT)
tilelet_kernel(const uint8_t* __restrict__ codes,
               const uint8_t* __restrict__ valid,
               const int32_t* __restrict__ row_off,
               const int32_t* __restrict__ rank,
               const int8_t* __restrict__ strand,
               const int8_t* __restrict__ hp, long long n_rows, int n_tiles,
               long long width, float* __restrict__ counts,
               float* __restrict__ grank) {
  using L = Layout<V2, PHASED>;
  constexpr int kT = L::kTypes;
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* acc = reinterpret_cast<int32_t*>(smem + L::kOffAcc);
  int32_t* racc = reinterpret_cast<int32_t*>(smem + L::kOffRacc);
  uint32_t* part = reinterpret_cast<uint32_t*>(smem + L::kOffPart);

  cg::cluster_group cluster = cg::this_cluster();
  const int cr = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / CS;
  const int n_cl = gridDim.x / CS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool has_hp = PHASED && hp != nullptr;

  for (int i = tid; i < kT * 4 * POS_TILE; i += NT) acc[i] = 0;
  for (int i = tid; i < 4 * POS_TILE; i += NT) racc[i] = RANK_INF;
  __syncthreads();

  // --- the stage stream: issue the next stage into buffer `buf` ----------
  Walk<CS> sw(row_off, n_tiles, n_cl, cl, cr);  // the rounds being staged
  Item si = sw.item();
  int ir = si.lo;
  auto issue_next = [&](int buf) {
    while (!sw.done() && ir >= si.hi) {
      sw.next();
      si = sw.item();
      ir = si.lo;
    }
    if (!sw.done()) {
      const int r0 = ir, n = min(L::kRows, si.hi - ir);
      ir += n;
      uint8_t* s = smem + buf * L::kStage;
      const uint8_t* gc = codes + static_cast<long long>(r0) * L::kCode;
      for (int i = tid; i < n * L::kCode / 16; i += NT)
        cp_async16(s + 16 * i, gc + 16 * i);
      if (V2) {
        const uint8_t* gv = valid + static_cast<long long>(r0) * L::kValid;
        for (int i = tid; i < n * L::kValid / 16; i += NT)
          cp_async16(s + L::kOffValid + 16 * i, gv + 16 * i);
      }
      for (int i = tid; i < n; i += NT)
        cp_async4(s + L::kOffRank + 4 * i, rank + r0 + i);
      // strand / hp bytes from the aligned word holding row r0; a word
      // that runs past the arrays' end (n_rows % 4 != 0) goes byte by byte
      const int w0 = r0 >> 2, nw = ((r0 + n + 3) >> 2) - w0;
      for (int i = tid; i < nw; i += NT) {
        const long long b = 4LL * (w0 + i);
        uint8_t* ds = s + L::kOffStrand + 4 * i;
        uint8_t* dh = s + L::kOffHp + 4 * i;
        if (b + 4 <= n_rows) {
          cp_async4(ds, strand + b);
          if (has_hp) cp_async4(dh, hp + b);
        } else {
          for (int k = 0; k < 4; ++k) {
            ds[k] = b + k < n_rows ? strand[b + k] : 0;
            if (has_hp) dh[k] = b + k < n_rows ? hp[b + k] : 0;
          }
        }
      }
    }
    cp_async_commit();
  };

  // --- per-warp run state ------------------------------------------------
  uint32_t cnt[kT][8];   // 8-bit counter per base, per position
  uint32_t seen[8];      // 0x01 per base seen in this run
  uint32_t first[8];     // run-local index (1..255) of a base's first row
  int run_n = 0;         // rows in this run
  int run_hi = INT_MIN;  // rank of the run's last row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int t = 0; t < kT; ++t) cnt[t][i] = 0;
    seen[i] = 0;
    first[i] = 0;
  }
  const int pos0 = 8 * lane;
  int32_t* ring =
      reinterpret_cast<int32_t*>(smem + L::kOffRing) + warp * (RUN_MAX + 1);

  auto flush_counts = [&]() {  // rare: a run of 255 rows or a rank drop
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t w = cnt[t][i];
        if (w) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t b = (w >> (8 * k)) & 255u;
            if (b)
              atomicAdd(&acc[(t * 4 + k) * POS_TILE + pos0 + i],
                        static_cast<int>(b));
          }
        }
        cnt[t][i] = 0;
      }
  };
  auto flush_ranks = [&]() {
    __syncwarp();  // lane 0 wrote the ring
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t f = first[i];
      if (f) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t b = (f >> (8 * k)) & 255u;
          if (b) atomicMin(&racc[k * POS_TILE + pos0 + i], ring[b - 1]);
        }
      }
      first[i] = 0;
      seen[i] = 0;
    }
    __syncwarp();  // before lane 0 writes the next run's ring
    run_n = 0;
    run_hi = INT_MIN;
  };

  // one row's inputs from a stage
  struct Raw {
    uint32_t code, nv;  // the lane's crumbs (v2) or nibbles; ~validity
    int rk, st, h;
  };
  auto load_row = [&](const uint8_t* s, int soff, int j) {
    Raw r;
    if (V2) {
      r.code = *reinterpret_cast<const uint16_t*>(s + j * L::kCode + 2 * lane);
      r.nv = ~static_cast<uint32_t>(s[L::kOffValid + j * L::kValid + lane]);
    } else {
      r.code = *reinterpret_cast<const uint32_t*>(s + j * L::kCode + 4 * lane);
      r.nv = 0;
    }
    r.rk = reinterpret_cast<const int32_t*>(s + L::kOffRank)[j];
    r.st = reinterpret_cast<const int8_t*>(s + L::kOffStrand)[soff + j];
    r.h = has_hp ? reinterpret_cast<const int8_t*>(s + L::kOffHp)[soff + j]
                 : 0;
    return r;
  };

  // one row's 8 increments: 1 << (8 * base) per valid slot, else 0
  auto row_inc = [&](const Raw& r, uint32_t* inc) {
    uint32_t sh[2];  // 8 shift amounts, one a byte: 8 * base, +32 if invalid
    if (V2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t x = (r.code >> (8 * h)) & 0xFFu;  // 4 crumbs
        sh[h] = (((x << 3) | (x << 9) | (x << 15) | (x << 21)) & 0x18181818u) |
                ((((r.nv >> (4 * h)) & 0xFu) * 0x04081020u) & 0x20202020u);
      }
    } else {
      // byte m holds slots 2m (high nibble) and 2m + 1: 8 * nibble
      const uint32_t even = (r.code >> 1) & 0x78787878u;
      const uint32_t odd = (r.code << 3) & 0x78787878u;
      sh[0] = __byte_perm(even, odd, 0x5140);
      sh[1] = __byte_perm(even, odd, 0x7362);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      inc[i] = shl_clamp(1u, __byte_perm(sh[i >> 2], 0, 0x4440 | (i & 3)));
  };

  // add one row (rank rk, strand st, hp h) to the warp's run
  auto row_add = [&](int rk, int st, int h, const uint32_t* inc) {
    if (run_n == RUN_MAX || rk < run_hi) {  // warp-uniform
      flush_counts();
      flush_ranks();
    }
    if (lane == 0) ring[run_n] = rk;
    ++run_n;
    run_hi = rk;
    if (st == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) cnt[0][i] += inc[i];
    } else if (st == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) cnt[1][i] += inc[i];
    }
    if (PHASED) {
      if (h == 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) cnt[kT - 2][i] += inc[i];
      } else if (h == 2) {
#pragma unroll
        for (int i = 0; i < 8; ++i) cnt[kT - 1][i] += inc[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t fresh = inc[i] & ~seen[i];
      seen[i] |= inc[i];
      first[i] += fresh * static_cast<uint32_t>(run_n);
    }
  };

  // the warp's rows of one stage
  auto decode = [&](const uint8_t* s, int r0, int n) {
    const int soff = r0 & 3;
    for (int j = warp; j < n; j += NW) {
      const Raw r = load_row(s, soff, j);
      uint32_t inc[8];
      row_inc(r, inc);
      row_add(r.rk, r.st, r.h, inc);
    }
  };

  // --- the walk ----------------------------------------------------------
  int buf = 0;
  issue_next(0);
  for (Walk<CS> w(row_off, n_tiles, n_cl, cl, cr); !w.done(); w.next()) {
    const Item it = w.item();
    for (int r0 = it.lo; r0 < it.hi; r0 += L::kRows) {
      const int n = min(L::kRows, it.hi - r0);
      issue_next(buf ^ 1);
      cp_async_wait<1>();
      __syncthreads();
      decode(smem + buf * L::kStage, r0, n);
      __syncthreads();
      buf ^= 1;
    }

    // a round with a split tile syncs the whole cluster (each such tile's
    // s CTAs read each other's images); `wide` is cluster-uniform
    const int t = it.tile, cs = it.s;
    const bool own = t < n_tiles;
    const bool live = own && row_off[t + 1] > row_off[t];  // tile-uniform
    auto round_sync = [&]() {
      if (it.wide) cluster.sync();
      else __syncthreads();
    };
    if (live) {
      // each warp: its run's ranks into the image, its counters into part
      flush_ranks();
#pragma unroll
      for (int k = 0; k < kT; ++k) {
        uint4* dst =
            reinterpret_cast<uint4*>(part + (warp * kT + k) * POS_TILE + pos0);
        dst[0] = make_uint4(cnt[k][0], cnt[k][1], cnt[k][2], cnt[k][3]);
        dst[1] = make_uint4(cnt[k][4], cnt[k][5], cnt[k][6], cnt[k][7]);
#pragma unroll
        for (int i = 0; i < 8; ++i) cnt[k][i] = 0;
      }
      __syncthreads();
      // sum the warps' 8-bit lanes as 16-bit lanes (bases 0/2 and 1/3)
      for (int item = tid; item < kT * QUADS; item += NT) {
        const int k = item / QUADS, q = item % QUADS;
        uint32_t even[4] = {0, 0, 0, 0}, odd[4] = {0, 0, 0, 0};
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const uint4 x = reinterpret_cast<const uint4*>(
              part + (w * kT + k) * POS_TILE)[q];
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            even[i] += xs[i] & 0x00FF00FFu;
            odd[i] += (xs[i] >> 8) & 0x00FF00FFu;
          }
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          int4* a = reinterpret_cast<int4*>(acc + (k * 4 + b) * POS_TILE) + q;
          const uint32_t* src = (b & 1) ? odd : even;
          const int sh = (b & 2) ? 16 : 0;
          int4 v = *a;
          v.x += (src[0] >> sh) & 0xFFFF;
          v.y += (src[1] >> sh) & 0xFFFF;
          v.z += (src[2] >> sh) & 0xFFFF;
          v.w += (src[3] >> sh) & 0xFFFF;
          *a = v;
        }
      }
    }
    if (live || it.wide) round_sync();
    if (own) {
      // this CTA's share of the tile's columns (QUADS / cs float4 columns),
      // all OUT_ROWS rows: thread -> (column, first row), rows strided;
      // the tile's CTAs are cluster ranks cr - part .. cr - part + cs - 1
      const long long col = static_cast<long long>(t) * POS_TILE;
      const int nq = QUADS / cs;
      const int q = it.part * nq + tid % nq;
      const int rstep = NT / nq;
      for (int c = tid / nq; c < OUT_ROWS; c += rstep) {
        const int row = c < C_PAD ? image_row<PHASED>(c) : c - C_PAD;
        int4 v = c < C_PAD
                     ? make_int4(0, 0, 0, 0)
                     : make_int4(RANK_INF, RANK_INF, RANK_INF, RANK_INF);
        if (live && row >= 0 && row < (c < C_PAD ? kT * 4 : 4)) {
          const int32_t* img = c < C_PAD ? acc : racc;
          if (cs == 1) {
            v = reinterpret_cast<const int4*>(img + row * POS_TILE)[q];
          } else {
            for (int r = cr - it.part; r < cr - it.part + cs; ++r) {
              const int4 x = reinterpret_cast<const int4*>(
                  cluster.map_shared_rank(img, r) + row * POS_TILE)[q];
              if (c < C_PAD) {
                v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
              } else {
                v.x = min(v.x, x.x); v.y = min(v.y, x.y);
                v.z = min(v.z, x.z); v.w = min(v.w, x.w);
              }
            }
          }
        }
        float* out = c < C_PAD ? counts + c * width : grank + row * width;
        __stcs(reinterpret_cast<float4*>(out + col) + q,
               make_float4(static_cast<float>(v.x), static_cast<float>(v.y),
                           static_cast<float>(v.z), static_cast<float>(v.w)));
      }
    }
    if (live || it.wide) round_sync();  // the image has been read: reset it
    if (live) {
      for (int i = tid; i < kT * 4 * POS_TILE; i += NT) acc[i] = 0;
      for (int i = tid; i < 4 * POS_TILE; i += NT) racc[i] = RANK_INF;
      __syncthreads();
    }
  }
  cp_async_wait<0>();
}

// Per device and instantiation, set once: the shared-memory opt-in (a
// property of the device's context) and how many clusters fit at once.
struct DeviceInfo {
  bool ready = false;
  cudaError_t err = cudaSuccess;
  int clusters = 0;
};

struct Args {
  const void *codes, *valid, *row_off, *rank, *strand, *hp;
  long long n_rows;
  int n_tiles;
  long long width;
  void *counts, *grank;
  cudaStream_t stream;
};

template <bool V2, bool PHASED, int CS>
int launch(const Args& a) {
  using L = Layout<V2, PHASED>;
  auto kernel = tilelet_kernel<V2, PHASED, CS>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  static std::mutex mu;
  static DeviceInfo info[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceInfo& d = info[dev];
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!d.ready) {
      d.err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
      if (d.err == cudaSuccess)
        d.err = cudaOccupancyMaxActiveClusters(&d.clusters, kernel, &cfg);
      if (d.err == cudaSuccess && d.clusters < 1)
        d.err = cudaErrorInvalidConfiguration;
      d.ready = true;
    }
  }
  if (d.err != cudaSuccess) return static_cast<int>(d.err);
  // More groups than fit at once: one persistent wave striding over them.
  // Fewer: m clusters a group (at most its CS rounds), m from one wave.
  const int n_groups = (a.n_tiles + CS - 1) / CS;
  const int clusters =
      n_groups >= d.clusters
          ? d.clusters
          : n_groups * std::min(CS, (d.clusters + n_groups - 1) / n_groups);
  cfg.gridDim = dim3(clusters * CS);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint8_t*>(a.codes),
      static_cast<const uint8_t*>(a.valid),
      static_cast<const int32_t*>(a.row_off),
      static_cast<const int32_t*>(a.rank),
      static_cast<const int8_t*>(a.strand), static_cast<const int8_t*>(a.hp),
      a.n_rows, a.n_tiles, a.width, static_cast<float*>(a.counts),
      static_cast<float*>(a.grank));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool V2, bool PHASED>
int launch_cs(const Args& a, int cs) {
  switch (cs) {
    case 1: return launch<V2, PHASED, 1>(a);
    case 2: return launch<V2, PHASED, 2>(a);
    case 4: return launch<V2, PHASED, 4>(a);
    default: return launch<V2, PHASED, MAX_CLUSTER>(a);
  }
}

}  // namespace

// Plain C entry point for ctypes. Enqueues one kernel on `stream`, does not
// synchronise, allocates nothing; returns the launch's CUDA error (0 = ok).
// codes/valid 16-byte aligned; rank, strand, hp 4-byte aligned (strand and
// hp are read in aligned 4-byte words, the last partial word byte by byte);
// hp may be null (all 0); counts and grank 16-byte aligned; row_off int32
// [n_tiles + 1] with row_off[n_tiles] <= n_rows, the rows' count.
// max_rows, the deepest tile's rows, sets the cluster size: the fewest CTAs
// that keep each under ROWS_PER_CTA rows, at most MAX_CLUSTER; < 0 (not
// known) takes MAX_CLUSTER, which any depth runs well on.
extern "C" int tilelet_expand_launch(int wire_v2, int phased,
                                     const void* codes, const void* valid,
                                     const void* row_off, const void* rank,
                                     const void* strand, const void* hp,
                                     long long n_rows, int n_tiles,
                                     long long width, int max_rows,
                                     void* counts, void* grank,
                                     void* stream) {
  if (n_tiles <= 0) return 0;
  int cs = MAX_CLUSTER;
  if (max_rows >= 0) {
    cs = 1;
    while (cs < MAX_CLUSTER && max_rows > ROWS_PER_CTA * cs) cs *= 2;
  }
  const Args a{codes, valid, row_off, rank, strand, hp, n_rows, n_tiles,
               width, counts, grank, static_cast<cudaStream_t>(stream)};
  if (wire_v2)
    return phased ? launch_cs<true, true>(a, cs) : launch_cs<true, false>(a, cs);
  return phased ? launch_cs<false, true>(a, cs) : launch_cs<false, false>(a, cs);
}
