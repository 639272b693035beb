// Native host-side BAM decode + pileup event extraction.
//
// The TPU-native analogue of the reference's htslib dependency: the reference
// leans on samtools/htslib (C) for BAM -> mpileup text
// (src/create_tensor_pileup.py:438-451); here the equivalent native component
// decodes BAM (BGZF/zlib inflate + record parse) and expands CIGARs directly
// into the packed event arrays consumed by the vectorized/TPU channel-count
// builder (clair3_rna_torch/pileup/events.py documents the array semantics;
// this produces identical arrays, differential-tested in
// tests/test_native_events.py).
//
// Build: g++ -O3 -shared -fPIC pileup_native.cc -o libpileup_native.so -lz

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

struct RecordView {
  int32_t ref_id;
  int32_t pos;
  uint16_t flag;
  uint8_t mapq;
  int32_t end;          // reference end (exclusive)
  const uint8_t* body;  // record body (after block_size)
  int32_t body_len;
};

// BAI index (SAM spec 5.2): per-reference bin -> virtual-offset chunks plus a
// 16 kb linear index. Mirrors clair3_rna_torch/io/bai.py exactly.
struct BaiIndex {
  std::vector<std::unordered_map<uint32_t, std::vector<std::pair<uint64_t, uint64_t>>>> bins;
  std::vector<std::vector<uint64_t>> linear;
};

struct BamFile {
  std::string path;
  bool indexed = false;                // bounded-memory region mode (.bai)
  std::vector<uint8_t> data;           // whole decompressed stream (legacy)
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lens;
  std::vector<RecordView> records;     // legacy mode: coordinate order
  // legacy region queries skip the record prefix via binary search on this
  // nondecreasing running max of (ref_id, end): without it every chunk of a
  // long contig rescans all earlier records (quadratic over a whole genome)
  std::vector<std::pair<int32_t, int64_t>> cummax_end;
  BaiIndex index;                      // indexed mode
  std::atomic<int64_t> bytes_read{0};  // compressed bytes touched (indexed)
};

constexpr int CIGAR_M = 0, CIGAR_I = 1, CIGAR_D = 2, CIGAR_N = 3, CIGAR_S = 4,
              CIGAR_H = 5, CIGAR_P = 6, CIGAR_EQ = 7, CIGAR_X = 8;

inline bool consumes_ref(int op) {
  return op == CIGAR_M || op == CIGAR_D || op == CIGAR_N || op == CIGAR_EQ ||
         op == CIGAR_X;
}

const char SEQ_NT16[] = "=ACMGRSVTWYHKDBN";

// base code: A=0 C=1 G=2 T=3, else -1 (N etc. enter no channel)
inline int8_t code_of_nt16(uint8_t nt16) {
  switch (nt16) {
    case 1: return 0;   // A
    case 2: return 1;   // C
    case 4: return 2;   // G
    case 8: return 3;   // T
    default: return -1;
  }
}

// BGZF members are independent deflate streams whose uncompressed size is
// recorded in the 4-byte ISIZE footer (BGZF caps members at 64 KiB, so ISIZE
// is exact). Scan the member headers serially (cheap), size the output with a
// prefix sum, then inflate members in parallel straight into their slots.
bool bgzf_decompress_all(const uint8_t* src, size_t n, std::vector<uint8_t>* out) {
  struct Member {
    size_t payload_off, payload_len, dst_off, dst_len;
  };
  std::vector<Member> members;
  size_t pos = 0, total = 0;
  while (pos + 18 <= n) {
    if (src[pos] != 0x1f || src[pos + 1] != 0x8b) return false;
    uint16_t xlen;
    memcpy(&xlen, src + pos + 10, 2);
    size_t extra = pos + 12;
    int32_t bsize = -1;
    size_t i = extra;
    while (i + 4 <= extra + xlen) {
      uint8_t si1 = src[i], si2 = src[i + 1];
      uint16_t slen;
      memcpy(&slen, src + i + 2, 2);
      if (si1 == 0x42 && si2 == 0x43 && slen == 2) {
        uint16_t v;
        memcpy(&v, src + i + 4, 2);
        bsize = v + 1;
      }
      i += 4 + slen;
    }
    if (bsize < 0 || pos + bsize > n) return false;
    uint32_t isize;
    memcpy(&isize, src + pos + bsize - 4, 4);
    members.push_back({pos + 12 + xlen, bsize - 12ul - xlen - 8ul, total, isize});
    total += isize;
    pos += bsize;
  }
  out->resize(total);
  uint8_t* dst = out->data();

  std::atomic<bool> ok{true};
  auto inflate_range = [&](size_t lo, size_t hi) {
    z_stream zs{};
    if (inflateInit2(&zs, -15) != Z_OK) {
      ok.store(false);
      return;
    }
    for (size_t b = lo; b < hi && ok.load(std::memory_order_relaxed); ++b) {
      const Member& m = members[b];
      if (m.dst_len == 0) continue;
      if (inflateReset(&zs) != Z_OK) {
        ok.store(false);
        break;
      }
      zs.next_in = const_cast<uint8_t*>(src + m.payload_off);
      zs.avail_in = static_cast<uInt>(m.payload_len);
      zs.next_out = dst + m.dst_off;
      zs.avail_out = static_cast<uInt>(m.dst_len);
      if (inflate(&zs, Z_FINISH) != Z_STREAM_END || zs.avail_out != 0) {
        ok.store(false);
        break;
      }
    }
    inflateEnd(&zs);
  };

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int n_threads = std::max(1, std::min<int>(hw, members.size() / 16));
  if (n_threads == 1) {
    inflate_range(0, members.size());
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) {
      size_t lo = members.size() * t / n_threads;
      size_t hi = members.size() * (t + 1) / n_threads;
      threads.emplace_back(inflate_range, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  return ok.load();
}

// --- streaming BGZF block reader (bounded memory; indexed mode) -------------

struct BgzfBlockStream {
  FILE* f;
  uint64_t coffset;       // compressed offset of the next block
  int64_t bytes_read = 0;  // compressed bytes consumed through this stream

  BgzfBlockStream(FILE* file, uint64_t off) : f(file), coffset(off) {
    fseek(f, static_cast<long>(off), SEEK_SET);
  }

  // Inflate the next block, appending to *out; records the block's compressed
  // offset and its start offset within *out. False at EOF / non-BGZF bytes.
  bool next(std::vector<uint8_t>* out, uint64_t* block_coffset,
            size_t* block_buf_off) {
    uint8_t hdr[12];
    if (fread(hdr, 1, 12, f) != 12) return false;
    if (hdr[0] != 0x1f || hdr[1] != 0x8b) return false;
    uint16_t xlen;
    memcpy(&xlen, hdr + 10, 2);
    std::vector<uint8_t> extra(xlen);
    if (xlen && fread(extra.data(), 1, xlen, f) != xlen) return false;
    int32_t bsize = -1;
    for (size_t i = 0; i + 4 <= xlen;) {
      uint16_t slen;
      memcpy(&slen, extra.data() + i + 2, 2);
      if (extra[i] == 0x42 && extra[i + 1] == 0x43 && slen == 2) {
        uint16_t v;
        memcpy(&v, extra.data() + i + 4, 2);
        bsize = v + 1;
      }
      i += 4 + slen;
    }
    if (bsize < 0 || bsize < 12 + xlen + 8) return false;
    size_t payload_len = bsize - 12 - xlen - 8;
    std::vector<uint8_t> payload(payload_len + 8);
    if (fread(payload.data(), 1, payload_len + 8, f) != payload_len + 8)
      return false;
    uint32_t isize;
    memcpy(&isize, payload.data() + payload_len + 4, 4);
    *block_coffset = coffset;
    *block_buf_off = out->size();
    size_t old = out->size();
    out->resize(old + isize);
    if (isize) {
      z_stream zs{};
      if (inflateInit2(&zs, -15) != Z_OK) return false;
      zs.next_in = payload.data();
      zs.avail_in = static_cast<uInt>(payload_len);
      zs.next_out = out->data() + old;
      zs.avail_out = isize;
      int r = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (r != Z_STREAM_END || zs.avail_out != 0) return false;
    }
    coffset += bsize;
    bytes_read += bsize;
    return true;
  }
};

// --- BAI binning arithmetic (identical to io/bai.py) -------------------------

constexpr uint32_t BAI_MAX_BIN = 37449;
constexpr int LINEAR_SHIFT = 14;

uint32_t bai_reg2bin(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (beg >> 14);
  if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (beg >> 17);
  if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (beg >> 20);
  if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (beg >> 23);
  if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (beg >> 26);
  return 0;
}

void bai_reg2bins(int64_t beg, int64_t end, std::vector<uint32_t>* bins) {
  --end;
  bins->push_back(0);
  static const int shifts[] = {26, 23, 20, 17, 14};
  static const uint32_t offsets[] = {1, 9, 73, 585, 4681};
  for (int l = 0; l < 5; ++l)
    for (int64_t k = offsets[l] + (beg >> shifts[l]);
         k <= offsets[l] + (end >> shifts[l]); ++k)
      bins->push_back(static_cast<uint32_t>(k));
}

bool bai_load(const std::string& path, BaiIndex* idx) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(size);
  if (fread(data.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return false;
  }
  fclose(f);
  if (size < 8 || memcmp(data.data(), "BAI\x01", 4) != 0) return false;
  int32_t n_ref;
  memcpy(&n_ref, data.data() + 4, 4);
  size_t off = 8;
  const size_t n = data.size();
  idx->bins.assign(n_ref, {});
  idx->linear.assign(n_ref, {});
  for (int r = 0; r < n_ref; ++r) {
    if (off + 4 > n) return false;
    int32_t n_bin;
    memcpy(&n_bin, data.data() + off, 4);
    off += 4;
    for (int b = 0; b < n_bin; ++b) {
      if (off + 8 > n) return false;
      uint32_t bin_id;
      int32_t n_chunk;
      memcpy(&bin_id, data.data() + off, 4);
      memcpy(&n_chunk, data.data() + off + 4, 4);
      off += 8;
      if (off + 16ull * n_chunk > n) return false;
      if (bin_id <= BAI_MAX_BIN) {
        auto& chunks = idx->bins[r][bin_id];
        chunks.reserve(n_chunk);
        for (int c = 0; c < n_chunk; ++c) {
          uint64_t vbeg, vend;
          memcpy(&vbeg, data.data() + off + 16ull * c, 8);
          memcpy(&vend, data.data() + off + 16ull * c + 8, 8);
          chunks.emplace_back(vbeg, vend);
        }
      }
      off += 16ull * n_chunk;
    }
    if (off + 4 > n) return false;
    int32_t n_intv;
    memcpy(&n_intv, data.data() + off, 4);
    off += 4;
    if (off + 8ull * n_intv > n) return false;
    idx->linear[r].resize(n_intv);
    memcpy(idx->linear[r].data(), data.data() + off, 8ull * n_intv);
    off += 8ull * n_intv;
  }
  return true;
}

// Merged, sorted voffset chunks possibly containing records overlapping
// [beg, end), pruned by the linear index (mirror of BaiIndex.query).
std::vector<std::pair<uint64_t, uint64_t>> bai_query(const BaiIndex& idx,
                                                     int32_t ref_id,
                                                     int64_t beg, int64_t end) {
  std::vector<std::pair<uint64_t, uint64_t>> chunks;
  if (ref_id < 0 || static_cast<size_t>(ref_id) >= idx.bins.size())
    return chunks;
  const auto& bmap = idx.bins[ref_id];
  const auto& lin = idx.linear[ref_id];
  size_t win = static_cast<size_t>(beg >> LINEAR_SHIFT);
  uint64_t min_off = lin.empty() ? 0
                     : (win < lin.size() ? lin[win] : lin.back());
  std::vector<uint32_t> bins;
  bai_reg2bins(beg, end, &bins);
  for (uint32_t b : bins) {
    auto it = bmap.find(b);
    if (it == bmap.end()) continue;
    for (const auto& ch : it->second)
      if (ch.second > min_off)
        chunks.emplace_back(std::max(ch.first, min_off), ch.second);
  }
  std::sort(chunks.begin(), chunks.end());
  std::vector<std::pair<uint64_t, uint64_t>> merged;
  for (const auto& ch : chunks) {
    if (!merged.empty() && (ch.first >> 16) <= (merged.back().second >> 16))
      merged.back().second = std::max(merged.back().second, ch.second);
    else
      merged.push_back(ch);
  }
  return merged;
}

int32_t reference_span(const uint8_t* body) {
  uint8_t l_read_name = body[8];
  uint16_t n_cigar;
  memcpy(&n_cigar, body + 12, 2);
  const uint8_t* cig = body + 32 + l_read_name;
  int32_t span = 0;
  for (int k = 0; k < n_cigar; ++k) {
    uint32_t v;
    memcpy(&v, cig + 4 * k, 4);
    int op = v & 0xF;
    if (consumes_ref(op)) span += v >> 4;
  }
  return span;
}

// --- region record loading ---------------------------------------------------
//
// The one entry point both extractors use. Legacy mode: filter the in-RAM
// record list. Indexed mode: query the BAI, inflate ONLY the covering BGZF
// blocks, and parse records out of the freshly inflated buffer -- memory and
// I/O scale with the region, matching htslib's `samtools mpileup -r` behavior
// (src/create_tensor_pileup.py:438-451).

struct RegionRecords {
  std::vector<uint8_t> buf;          // owns inflated bytes (indexed mode)
  std::vector<RecordView> records;   // filtered, overlap [start, end)
};

bool load_region_records(BamFile* bam, int32_t ref_id, int64_t start,
                         int64_t end, int32_t min_mq, int32_t exclude_flags,
                         RegionRecords* rr) {
  auto keep = [&](const RecordView& rv) {
    return !(rv.flag & exclude_flags) && rv.mapq >= min_mq && rv.end > start;
  };
  if (!bam->indexed) {
    // skip the prefix that cannot overlap: cummax_end is nondecreasing in
    // (ref_id, end), so the first possibly-overlapping record is found by
    // binary search instead of a scan from record 0 (per-chunk rescans of
    // long contigs were quadratic otherwise)
    size_t lo = std::lower_bound(bam->cummax_end.begin(),
                                 bam->cummax_end.end(),
                                 std::make_pair(ref_id, start + 1))
                - bam->cummax_end.begin();
    for (size_t i = lo; i < bam->records.size(); ++i) {
      const RecordView& rv = bam->records[i];
      if (rv.ref_id != ref_id) {
        if (rv.ref_id > ref_id && ref_id >= 0) break;
        continue;
      }
      if (rv.pos >= end) break;
      if (keep(rv)) rr->records.push_back(rv);
    }
    return true;
  }

  auto chunks = bai_query(bam->index, ref_id, start, end);
  if (chunks.empty()) return true;
  FILE* f = fopen(bam->path.c_str(), "rb");
  if (!f) return false;

  // pass 1: inflate all chunks' blocks into one stable buffer
  struct Seg { size_t parse_from; uint64_t vend; };
  std::vector<Seg> segs;
  std::vector<std::pair<size_t, uint64_t>> bmap;  // buf offset -> coffset
  for (const auto& ch : chunks) {
    uint64_t clo = ch.first >> 16, cend = ch.second >> 16;
    uint16_t ubeg = ch.first & 0xFFFF, uend = ch.second & 0xFFFF;
    BgzfBlockStream bs(f, clo);
    size_t first_block_off = rr->buf.size();
    uint64_t bco;
    size_t boff;
    while (bs.coffset < cend || (bs.coffset == cend && uend > 0)) {
      if (!bs.next(&rr->buf, &bco, &boff)) break;
      bmap.emplace_back(boff, bco);
    }
    bam->bytes_read += bs.bytes_read;
    segs.push_back({first_block_off + ubeg, ch.second});
  }
  fclose(f);

  // pass 2: parse records per segment (buffer is final -- pointers stable)
  size_t bi = 0;
  for (const Seg& seg : segs) {
    size_t p = seg.parse_from;
    while (p + 4 <= rr->buf.size()) {
      while (bi + 1 < bmap.size() && bmap[bi + 1].first <= p) ++bi;
      uint64_t voff = (bmap[bi].second << 16) | (p - bmap[bi].first);
      if (voff >= seg.vend) break;
      int32_t block_size;
      memcpy(&block_size, rr->buf.data() + p, 4);
      if (block_size <= 0 || p + 4 + block_size > rr->buf.size()) break;
      const uint8_t* body = rr->buf.data() + p + 4;
      RecordView rv;
      memcpy(&rv.ref_id, body, 4);
      memcpy(&rv.pos, body + 4, 4);
      memcpy(&rv.flag, body + 14, 2);
      rv.mapq = body[9];
      rv.body = body;
      rv.body_len = block_size;
      p += 4 + block_size;
      if (rv.ref_id != ref_id) continue;
      if (rv.pos >= end) return true;  // coordinate-sorted: done
      rv.end = rv.pos + reference_span(body);
      if (keep(rv)) rr->records.push_back(rv);
    }
  }
  return true;
}

template <typename T>
T* steal(std::vector<T>& v) {
  T* p = static_cast<T*>(malloc(v.size() * sizeof(T) + 1));
  memcpy(p, v.data(), v.size() * sizeof(T));
  return p;
}

int parse_hp_tag(const uint8_t* tags, const uint8_t* end) {
  const uint8_t* p = tags;
  while (p + 3 <= end) {
    char t0 = p[0], t1 = p[1], typ = p[2];
    p += 3;
    int64_t val = 0;
    bool is_hp = (t0 == 'H' && t1 == 'P');
    switch (typ) {
      case 'A': case 'c': val = static_cast<int8_t>(*p); p += 1; break;
      case 'C': val = *p; p += 1; break;
      case 's': { int16_t v; memcpy(&v, p, 2); val = v; p += 2; break; }
      case 'S': { uint16_t v; memcpy(&v, p, 2); val = v; p += 2; break; }
      case 'i': { int32_t v; memcpy(&v, p, 4); val = v; p += 4; break; }
      case 'I': { uint32_t v; memcpy(&v, p, 4); val = v; p += 4; break; }
      case 'f': p += 4; break;
      case 'Z': case 'H':
        while (p < end && *p) ++p;
        ++p;
        break;
      case 'B': {
        char sub = static_cast<char>(*p);
        uint32_t count;
        memcpy(&count, p + 1, 4);
        p += 5;
        int sz = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
        p += static_cast<int64_t>(count) * sz;
        break;
      }
      default:
        return 0;  // unknown tag type: bail
    }
    if (is_hp && typ != 'f' && typ != 'Z' && typ != 'H' && typ != 'B') {
      if (val >= 0 && val <= 2) return static_cast<int>(val);
      return 0;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

static bool open_indexed(BamFile* bam) {
  std::string bai1 = bam->path + ".bai";
  std::string stem = bam->path;
  size_t dot = stem.rfind('.');
  std::string bai2 =
      (dot == std::string::npos ? stem : stem.substr(0, dot)) + ".bai";
  if (!bai_load(bai1, &bam->index) && !bai_load(bai2, &bam->index))
    return false;
  FILE* f = fopen(bam->path.c_str(), "rb");
  if (!f) return false;
  // inflate only as many leading blocks as the header needs
  BgzfBlockStream bs(f, 0);
  std::vector<uint8_t> hbuf;
  uint64_t bco;
  size_t boff;
  auto need = [&](size_t n) {
    while (hbuf.size() < n)
      if (!bs.next(&hbuf, &bco, &boff)) return false;
    return true;
  };
  bool ok = need(12) && memcmp(hbuf.data(), "BAM\x01", 4) == 0;
  if (ok) {
    int32_t l_text;
    memcpy(&l_text, hbuf.data() + 4, 4);
    size_t off = 8 + l_text;
    ok = need(off + 4);
    int32_t n_ref = 0;
    if (ok) {
      memcpy(&n_ref, hbuf.data() + off, 4);
      off += 4;
    }
    for (int i = 0; ok && i < n_ref; ++i) {
      ok = need(off + 4);
      if (!ok) break;
      int32_t l_name;
      memcpy(&l_name, hbuf.data() + off, 4);
      ok = need(off + 8 + l_name);
      if (!ok) break;
      bam->ref_names.emplace_back(
          reinterpret_cast<const char*>(hbuf.data() + off + 4), l_name - 1);
      int32_t l_ref;
      memcpy(&l_ref, hbuf.data() + off + 4 + l_name, 4);
      bam->ref_lens.push_back(l_ref);
      off += 8 + l_name;
    }
  }
  bam->bytes_read += bs.bytes_read;
  fclose(f);
  if (!ok || bam->index.bins.size() != bam->ref_names.size()) {
    bam->ref_names.clear();
    bam->ref_lens.clear();
    return false;
  }
  bam->indexed = true;
  return true;
}

void* bam_open(const char* path) {
  auto* bam = new BamFile();
  bam->path = path;
  if (open_indexed(bam)) return bam;

  FILE* f = fopen(path, "rb");
  if (!f) {
    delete bam;
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(size);
  if (fread(raw.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    delete bam;
    return nullptr;
  }
  fclose(f);

  if (!bgzf_decompress_all(raw.data(), raw.size(), &bam->data) ||
      bam->data.size() < 12 || memcmp(bam->data.data(), "BAM\x01", 4) != 0) {
    delete bam;
    return nullptr;
  }
  const uint8_t* d = bam->data.data();
  size_t n = bam->data.size();
  int32_t l_text;
  memcpy(&l_text, d + 4, 4);
  size_t off = 8 + l_text;
  int32_t n_ref;
  memcpy(&n_ref, d + off, 4);
  off += 4;
  for (int i = 0; i < n_ref; ++i) {
    int32_t l_name;
    memcpy(&l_name, d + off, 4);
    bam->ref_names.emplace_back(reinterpret_cast<const char*>(d + off + 4),
                                l_name - 1);
    int32_t l_ref;
    memcpy(&l_ref, d + off + 4 + l_name, 4);
    bam->ref_lens.push_back(l_ref);
    off += 8 + l_name;
  }
  while (off + 4 <= n) {
    int32_t block_size;
    memcpy(&block_size, d + off, 4);
    off += 4;
    if (block_size <= 0 || off + block_size > n) break;
    const uint8_t* body = d + off;
    RecordView rv;
    memcpy(&rv.ref_id, body, 4);
    memcpy(&rv.pos, body + 4, 4);
    memcpy(&rv.flag, body + 14, 2);
    rv.mapq = body[9];
    rv.body = body;
    rv.body_len = block_size;
    rv.end = rv.pos + reference_span(body);
    bam->records.push_back(rv);
    off += block_size;
  }
  bam->cummax_end.reserve(bam->records.size());
  std::pair<int32_t, int64_t> running{-2, -1};
  for (const RecordView& rv : bam->records) {
    std::pair<int32_t, int64_t> key{rv.ref_id, rv.end};
    if (key > running) running = key;
    bam->cummax_end.push_back(running);
  }
  return bam;
}

void bam_close(void* handle) { delete static_cast<BamFile*>(handle); }

int32_t bam_n_refs(void* handle) {
  return static_cast<int32_t>(static_cast<BamFile*>(handle)->ref_names.size());
}

const char* bam_ref_name(void* handle, int32_t i) {
  return static_cast<BamFile*>(handle)->ref_names[i].c_str();
}

int64_t bam_ref_len(void* handle, int32_t i) {
  return static_cast<BamFile*>(handle)->ref_lens[i];
}

int64_t bam_n_records(void* handle) {
  auto* bam = static_cast<BamFile*>(handle);
  if (bam->indexed) return -1;  // unknown without a full scan
  return static_cast<int64_t>(bam->records.size());
}

int32_t bam_is_indexed(void* handle) {
  return static_cast<BamFile*>(handle)->indexed ? 1 : 0;
}

// compressed bytes inflated so far (indexed mode); the bounded-I/O proof
int64_t bam_bytes_read(void* handle) {
  return static_cast<BamFile*>(handle)->bytes_read.load();
}

// Streaming BAI builder (samtools-index equivalent): one block-by-block pass,
// memory bounded by the rolling parse buffer + the index itself. Returns
// 0 ok, 1 open/read error, 2 not a BAM, 3 not coordinate-sorted, 4 write
// error. Mirrors clair3_rna_torch/io/bai.py IndexBuilder bit-for-bit.
int32_t bam_build_index(const char* bam_path, const char* bai_path) {
  FILE* f = fopen(bam_path, "rb");
  if (!f) return 1;
  BgzfBlockStream bs(f, 0);
  std::vector<uint8_t> buf;
  std::vector<std::pair<size_t, uint64_t>> bmap;  // abs buf offset -> coffset
  size_t abs_base = 0;  // absolute uncompressed offset of buf[0]
  uint64_t bco;
  size_t boff;
  bool eof = false;
  auto need = [&](size_t abs_target) {
    while (abs_base + buf.size() < abs_target) {
      size_t before = buf.size();
      if (!bs.next(&buf, &bco, &boff)) {
        eof = true;
        return false;
      }
      bmap.emplace_back(abs_base + before, bco);
    }
    return true;
  };

  if (!need(12) || memcmp(buf.data(), "BAM\x01", 4) != 0) {
    fclose(f);
    return 2;
  }
  int32_t l_text;
  memcpy(&l_text, buf.data() + 4, 4);
  size_t p = 8 + l_text;  // absolute offset cursor
  if (!need(p + 4)) {
    fclose(f);
    return 2;
  }
  int32_t n_ref;
  memcpy(&n_ref, buf.data() + p, 4);
  p += 4;
  for (int i = 0; i < n_ref; ++i) {
    if (!need(p + 4)) { fclose(f); return 2; }
    int32_t l_name;
    memcpy(&l_name, buf.data() + p, 4);
    if (!need(p + 8 + l_name)) { fclose(f); return 2; }
    p += 8 + l_name;
  }

  std::vector<std::unordered_map<uint32_t,
      std::vector<std::pair<uint64_t, uint64_t>>>> bins(n_ref);
  std::vector<std::vector<uint64_t>> linear(n_ref);
  uint64_t n_no_coor = 0;
  int32_t last_ref = -1;
  int64_t last_pos = -1;
  size_t bi = 0;

  auto voffset_at = [&](size_t abs) -> uint64_t {
    while (bi + 1 < bmap.size() && bmap[bi + 1].first <= abs) ++bi;
    return (bmap[bi].second << 16) | (abs - bmap[bi].first);
  };

  for (;;) {
    if (!need(p + 4)) break;  // clean EOF
    uint64_t vbeg = voffset_at(p);
    int32_t block_size;
    memcpy(&block_size, buf.data() + (p - abs_base), 4);
    if (block_size <= 0 || !need(p + 4 + block_size)) { fclose(f); return 2; }
    const uint8_t* body = buf.data() + (p - abs_base) + 4;
    p += 4 + block_size;
    uint64_t vend = voffset_at(p);
    int32_t ref_id, pos;
    memcpy(&ref_id, body, 4);
    memcpy(&pos, body + 4, 4);
    if (ref_id < 0) {
      ++n_no_coor;
    } else {
      if (ref_id < last_ref || (ref_id == last_ref && pos < last_pos)) {
        fclose(f);
        return 3;
      }
      last_ref = ref_id;
      last_pos = pos;
      int64_t rec_end = pos + reference_span(body);
      if (rec_end <= pos) rec_end = pos + 1;
      uint32_t b = bai_reg2bin(pos, rec_end);
      auto& chunks = bins[ref_id][b];
      if (!chunks.empty() && chunks.back().second == vbeg)
        chunks.back().second = vend;
      else
        chunks.emplace_back(vbeg, vend);
      auto& lin = linear[ref_id];
      for (int64_t w = pos >> LINEAR_SHIFT; w <= (rec_end - 1) >> LINEAR_SHIFT;
           ++w) {
        if (static_cast<size_t>(w) >= lin.size()) lin.resize(w + 1, 0);
        if (lin[w] == 0 || vbeg < lin[w]) lin[w] = vbeg;
      }
    }
    // compact the rolling buffer so memory stays bounded
    if (p - abs_base > (8u << 20)) {
      size_t keep_from;  // start of the block containing p
      while (bi + 1 < bmap.size() && bmap[bi + 1].first <= p) ++bi;
      keep_from = bmap[bi].first;
      buf.erase(buf.begin(), buf.begin() + (keep_from - abs_base));
      abs_base = keep_from;
      bmap.erase(bmap.begin(), bmap.begin() + bi);
      bi = 0;
    }
  }
  fclose(f);

  // fill linear-index holes with the previous known offset (htslib behavior)
  for (auto& lin : linear) {
    uint64_t last = 0;
    for (auto& v : lin) {
      if (v == 0)
        v = last;
      else
        last = v;
    }
  }

  FILE* out = fopen(bai_path, "wb");
  if (!out) return 4;
  auto w32 = [&](int32_t v) { fwrite(&v, 4, 1, out); };
  auto w64 = [&](uint64_t v) { fwrite(&v, 8, 1, out); };
  fwrite("BAI\x01", 1, 4, out);
  w32(n_ref);
  for (int r = 0; r < n_ref; ++r) {
    std::vector<uint32_t> keys;
    keys.reserve(bins[r].size());
    for (const auto& kv : bins[r]) keys.push_back(kv.first);
    std::sort(keys.begin(), keys.end());
    w32(static_cast<int32_t>(keys.size()));
    for (uint32_t b : keys) {
      const auto& chunks = bins[r][b];
      fwrite(&b, 4, 1, out);
      w32(static_cast<int32_t>(chunks.size()));
      for (const auto& ch : chunks) {
        w64(ch.first);
        w64(ch.second);
      }
    }
    w32(static_cast<int32_t>(linear[r].size()));
    for (uint64_t v : linear[r]) w64(v);
  }
  w64(n_no_coor);
  bool ok = fclose(out) == 0;
  return ok ? 0 : 4;
}

struct EventsOut {
  int64_t n_base;
  int32_t* base_pos;
  int8_t* base_code;
  int8_t* base_strand;
  int64_t* base_rank;
  int8_t* base_hp;
  int64_t n_star;
  int32_t* star_pos;
  int8_t* star_strand;
  int8_t* star_hp;
  int64_t n_ins;
  int32_t* ins_pos;
  int8_t* ins_strand;
  int64_t* ins_rank;
  int8_t* ins_hp;
  int32_t* ins_allele;
  int64_t n_ins_seq;
  char* ins_seq_blob;      // '\0'-separated allele sequences
  int64_t ins_seq_blob_len;
  int64_t n_del;
  int32_t* del_pos;
  int8_t* del_strand;
  int64_t* del_rank;
  int8_t* del_hp;
  int32_t* del_len;
  // dense per-position arrays over [start, end)
  int32_t* read_start_count;
  int32_t* read_end_count;
  int32_t* skip_fwd_count;
  int32_t* skip_rev_count;
  int32_t* cover_count;
};

EventsOut* extract_events_native(void* handle, int32_t ref_id, int64_t start,
                                 int64_t end, int32_t min_mq, int32_t min_bq,
                                 int32_t exclude_flags) {
  auto* bam = static_cast<BamFile*>(handle);
  int64_t width = end - start;

  std::vector<int32_t> base_pos;
  std::vector<int8_t> base_code, base_strand, base_hp;
  std::vector<int64_t> base_rank;
  std::vector<int32_t> star_pos;
  std::vector<int8_t> star_strand, star_hp;
  std::vector<int32_t> ins_pos, ins_allele;
  std::vector<int8_t> ins_strand, ins_hp;
  std::vector<int64_t> ins_rank;
  std::vector<int32_t> del_pos, del_len;
  std::vector<int8_t> del_strand, del_hp;
  std::vector<int64_t> del_rank;
  std::vector<int32_t> read_start_count(width, 0), read_end_count(width, 0),
      skip_fwd(width, 0), skip_rev(width, 0), cover_diff(width + 1, 0);
  std::unordered_map<std::string, int32_t> allele_ids;
  std::string ins_blob;
  int64_t n_alleles = 0;

  base_pos.reserve(1 << 20);
  base_code.reserve(1 << 20);
  base_strand.reserve(1 << 20);
  base_rank.reserve(1 << 20);
  base_hp.reserve(1 << 20);

  RegionRecords region;
  if (!load_region_records(bam, ref_id, start, end, min_mq, exclude_flags,
                           &region))
    return nullptr;
  for (size_t read_index = 0; read_index < region.records.size();
       ++read_index) {
    const RecordView& rv = region.records[read_index];
    int64_t rank = 2 * static_cast<int64_t>(read_index);
    int8_t strand = (rv.flag & 0x10) ? 1 : 0;

    const uint8_t* body = rv.body;
    uint8_t l_read_name = body[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, body + 12, 2);
    int32_t l_seq;
    memcpy(&l_seq, body + 16, 4);
    const uint8_t* cig = body + 32 + l_read_name;
    const uint8_t* seq = cig + 4 * n_cigar;
    const uint8_t* qual = seq + (l_seq + 1) / 2;
    const uint8_t* tags = qual + l_seq;
    int8_t hp = static_cast<int8_t>(parse_hp_tag(tags, body + rv.body_len));

    // read start/end marks + cover range
    if (rv.pos >= start && rv.pos < end) read_start_count[rv.pos - start] += 1;
    if (rv.end - 1 >= start && rv.end - 1 < end)
      read_end_count[rv.end - 1 - start] += 1;
    int64_t clo = rv.pos > start ? rv.pos : start;
    int64_t chi = rv.end < end ? rv.end : end;
    if (clo < chi) {
      cover_diff[clo - start] += 1;
      cover_diff[chi - start] -= 1;
    }

    int64_t qpos = 0, rpos = rv.pos;
    for (int k = 0; k < n_cigar; ++k) {
      uint32_t v;
      memcpy(&v, cig + 4 * k, 4);
      int op = v & 0xF;
      int64_t len = v >> 4;
      if (op == CIGAR_M || op == CIGAR_EQ || op == CIGAR_X) {
        int64_t lo = rpos > start ? rpos : start;
        int64_t hi = (rpos + len) < end ? (rpos + len) : end;
        for (int64_t p = lo; p < hi; ++p) {
          int64_t qi = qpos + (p - rpos);
          uint8_t byte = seq[qi >> 1];
          uint8_t nt16 = (qi & 1) ? (byte & 0xF) : (byte >> 4);
          int8_t code = code_of_nt16(nt16);
          if (code < 0) continue;
          if (min_bq > 0) {
            uint8_t q = qual[qi];
            if (q != 0xFF && q < min_bq) continue;
          }
          base_pos.push_back(static_cast<int32_t>(p));
          base_code.push_back(code);
          base_strand.push_back(strand);
          base_rank.push_back(rank);
          base_hp.push_back(hp);
        }
        // indel attached to the last base of this match segment
        int64_t attach = rpos + len - 1;
        if (attach >= start && attach < end && k + 1 < n_cigar) {
          uint32_t nv;
          memcpy(&nv, cig + 4 * (k + 1), 4);
          int nop = nv & 0xF;
          int64_t nlen = nv >> 4;
          if (nop == CIGAR_I) {
            std::string allele;
            allele.reserve(nlen);
            for (int64_t j = 0; j < nlen; ++j) {
              int64_t qi = qpos + len + j;
              uint8_t byte = seq[qi >> 1];
              uint8_t nt16 = (qi & 1) ? (byte & 0xF) : (byte >> 4);
              allele.push_back(SEQ_NT16[nt16]);
            }
            auto it = allele_ids.find(allele);
            int32_t id;
            if (it == allele_ids.end()) {
              id = static_cast<int32_t>(n_alleles++);
              allele_ids.emplace(allele, id);
              ins_blob += allele;
              ins_blob.push_back('\0');
            } else {
              id = it->second;
            }
            ins_pos.push_back(static_cast<int32_t>(attach));
            ins_strand.push_back(strand);
            ins_rank.push_back(rank + 1);
            ins_hp.push_back(hp);
            ins_allele.push_back(id);
          } else if (nop == CIGAR_D) {
            del_pos.push_back(static_cast<int32_t>(attach));
            del_strand.push_back(strand);
            del_rank.push_back(rank + 1);
            del_hp.push_back(hp);
            del_len.push_back(static_cast<int32_t>(nlen));
          }
        }
        qpos += len;
        rpos += len;
      } else if (op == CIGAR_D) {
        int64_t lo = rpos > start ? rpos : start;
        int64_t hi = (rpos + len) < end ? (rpos + len) : end;
        for (int64_t p = lo; p < hi; ++p) {
          star_pos.push_back(static_cast<int32_t>(p));
          star_strand.push_back(strand);
          star_hp.push_back(hp);
        }
        rpos += len;
      } else if (op == CIGAR_N) {
        int64_t lo = rpos > start ? rpos : start;
        int64_t hi = (rpos + len) < end ? (rpos + len) : end;
        if (lo < hi) {
          auto& target = strand ? skip_rev : skip_fwd;
          for (int64_t p = lo; p < hi; ++p) target[p - start] += 1;
        }
        rpos += len;
      } else if (op == CIGAR_I || op == CIGAR_S) {
        qpos += len;
      }
      // H and P consume nothing
    }
  }

  // cover prefix sum
  std::vector<int32_t> cover(width);
  int32_t acc = 0;
  for (int64_t i = 0; i < width; ++i) {
    acc += cover_diff[i];
    cover[i] = acc;
  }

  auto* out = new EventsOut();
  out->n_base = static_cast<int64_t>(base_pos.size());
  out->base_pos = steal(base_pos);
  out->base_code = steal(base_code);
  out->base_strand = steal(base_strand);
  out->base_rank = steal(base_rank);
  out->base_hp = steal(base_hp);
  out->n_star = static_cast<int64_t>(star_pos.size());
  out->star_pos = steal(star_pos);
  out->star_strand = steal(star_strand);
  out->star_hp = steal(star_hp);
  out->n_ins = static_cast<int64_t>(ins_pos.size());
  out->ins_pos = steal(ins_pos);
  out->ins_strand = steal(ins_strand);
  out->ins_rank = steal(ins_rank);
  out->ins_hp = steal(ins_hp);
  out->ins_allele = steal(ins_allele);
  out->n_ins_seq = n_alleles;
  out->ins_seq_blob_len = static_cast<int64_t>(ins_blob.size());
  out->ins_seq_blob = static_cast<char*>(malloc(ins_blob.size() + 1));
  memcpy(out->ins_seq_blob, ins_blob.data(), ins_blob.size());
  out->ins_seq_blob[ins_blob.size()] = '\0';
  out->n_del = static_cast<int64_t>(del_pos.size());
  out->del_pos = steal(del_pos);
  out->del_strand = steal(del_strand);
  out->del_rank = steal(del_rank);
  out->del_hp = steal(del_hp);
  out->del_len = steal(del_len);
  out->read_start_count = steal(read_start_count);
  out->read_end_count = steal(read_end_count);
  out->skip_fwd_count = steal(skip_fwd);
  out->skip_rev_count = steal(skip_rev);
  out->cover_count = steal(cover);
  return out;
}

// ---------------------------------------------------------------------------
// Dense tile build: accumulate the channel-count image directly, so Python
// never materializes per-base event arrays. Channel layout matches
// clair3_rna_torch/config.py CHANNELS (+ PHASED_CHANNELS when phased).
// ---------------------------------------------------------------------------

struct TileOut {
  int64_t width;
  int32_t n_channels;
  int32_t* counts;        // [width * n_channels]
  int32_t* group_count;   // [width * 6] A C G T I D (case-merged)
  int64_t* group_rank;    // [width * 6] min first-occurrence rank
  int32_t* max_del_length;  // [width]
  int32_t* read_start_count;
  int32_t* read_end_count;
  int32_t* skip_fwd_count;
  int32_t* skip_rev_count;
  int32_t* cover_count;
  // sparse ins/del details for alt_info reconstruction
  int64_t n_ins;
  int32_t* ins_pos;
  int8_t* ins_strand;
  int64_t* ins_rank;
  int32_t* ins_allele;
  int64_t n_ins_seq;
  char* ins_seq_blob;
  int64_t ins_seq_blob_len;
  int64_t n_del;
  int32_t* del_pos;
  int8_t* del_strand;
  int64_t* del_rank;
  int32_t* del_len;
};

namespace {
constexpr int CH_A = 0, CH_I = 4, CH_I1 = 5, CH_D = 6, CH_D1 = 7, CH_STAR = 8,
              CH_a = 9, CH_i = 13, CH_i1 = 14, CH_d = 15, CH_d1 = 16,
              CH_HASH = 17;
constexpr int64_t RANK_INF = int64_t(1) << 60;
}

namespace {

// Per-thread sparse outputs for one position subrange [sub_lo, sub_hi).
struct TileShard {
  std::vector<int32_t> ins_pos, ins_allele;
  std::vector<int8_t> ins_strand;
  std::vector<int64_t> ins_rank;
  std::vector<int32_t> del_pos, del_len;
  std::vector<int8_t> del_strand;
  std::vector<int64_t> del_rank;
  std::unordered_map<std::string, int32_t> allele_ids;  // local ids
  std::vector<std::string> allele_seqs;
  std::vector<int32_t> cover_diff;  // local, width sub_hi - sub_lo + 1
};

// Process all records overlapping [sub_lo, sub_hi), writing the dense images
// only inside that subrange. Dense arrays are shared across threads: each
// thread owns a disjoint position slice, so writes never race. Records
// spanning a boundary are re-walked by both owners with clipped inner loops.
void tile_worker(const std::vector<const RecordView*>& recs,
                 const std::vector<int64_t>& ranks, int64_t start,
                 int64_t sub_lo, int64_t sub_hi, int32_t min_bq,
                 int32_t n_channels, int32_t phased, int32_t* counts,
                 int32_t* group_count, int64_t* group_rank,
                 int32_t* max_del_length, int32_t* read_start_count,
                 int32_t* read_end_count, int32_t* skip_fwd, int32_t* skip_rev,
                 TileShard* shard) {
  shard->cover_diff.assign(sub_hi - sub_lo + 1, 0);
  for (size_t ri = 0; ri < recs.size(); ++ri) {
    const RecordView& rv = *recs[ri];
    if (rv.pos >= sub_hi) break;
    if (rv.end <= sub_lo) continue;
    int64_t rank = ranks[ri];
    int8_t strand = (rv.flag & 0x10) ? 1 : 0;

    const uint8_t* body = rv.body;
    uint8_t l_read_name = body[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, body + 12, 2);
    int32_t l_seq;
    memcpy(&l_seq, body + 16, 4);
    const uint8_t* cig = body + 32 + l_read_name;
    const uint8_t* seq = cig + 4 * n_cigar;
    const uint8_t* qual = seq + (l_seq + 1) / 2;
    const uint8_t* tags = qual + l_seq;
    int hp = phased ? parse_hp_tag(tags, body + rv.body_len) : 0;

    if (rv.pos >= sub_lo && rv.pos < sub_hi)
      read_start_count[rv.pos - start] += 1;
    if (rv.end - 1 >= sub_lo && rv.end - 1 < sub_hi)
      read_end_count[rv.end - 1 - start] += 1;
    int64_t clo = rv.pos > sub_lo ? rv.pos : sub_lo;
    int64_t chi = rv.end < sub_hi ? rv.end : sub_hi;
    if (clo < chi) {
      shard->cover_diff[clo - sub_lo] += 1;
      shard->cover_diff[chi - sub_lo] -= 1;
    }

    int64_t qpos = 0, rpos = rv.pos;
    for (int k = 0; k < n_cigar; ++k) {
      uint32_t v;
      memcpy(&v, cig + 4 * k, 4);
      int op = v & 0xF;
      int64_t len = v >> 4;
      if (op == CIGAR_M || op == CIGAR_EQ || op == CIGAR_X) {
        int64_t lo = rpos > sub_lo ? rpos : sub_lo;
        int64_t hi = (rpos + len) < sub_hi ? (rpos + len) : sub_hi;
        for (int64_t p = lo; p < hi; ++p) {
          int64_t qi = qpos + (p - rpos);
          uint8_t byte = seq[qi >> 1];
          uint8_t nt16 = (qi & 1) ? (byte & 0xF) : (byte >> 4);
          int8_t code = code_of_nt16(nt16);
          if (code < 0) continue;
          if (min_bq > 0) {
            uint8_t q = qual[qi];
            if (q != 0xFF && q < min_bq) continue;
          }
          int64_t w = p - start;
          counts[w * n_channels + code + (strand ? 9 : 0)] += 1;
          // group_count[w*6+code] is derived after the pass as
          // counts[code] + counts[code+9] (case-merged), saving one
          // read-modify-write per base in this hottest loop
          int64_t& gr = group_rank[w * 6 + code];
          if (rank < gr) gr = rank;
          if (phased && hp >= 1 && hp <= 2)
            counts[w * n_channels + 18 + (hp - 1) * 6 + code] += 1;
        }
        int64_t attach = rpos + len - 1;
        if (attach >= sub_lo && attach < sub_hi && k + 1 < n_cigar) {
          uint32_t nv;
          memcpy(&nv, cig + 4 * (k + 1), 4);
          int nop = nv & 0xF;
          int64_t nlen = nv >> 4;
          int64_t w = attach - start;
          if (nop == CIGAR_I) {
            std::string allele;
            allele.reserve(nlen);
            for (int64_t j = 0; j < nlen; ++j) {
              int64_t qi = qpos + len + j;
              uint8_t byte = seq[qi >> 1];
              uint8_t nt16 = (qi & 1) ? (byte & 0xF) : (byte >> 4);
              allele.push_back(SEQ_NT16[nt16]);
            }
            auto it = shard->allele_ids.find(allele);
            int32_t id;
            if (it == shard->allele_ids.end()) {
              id = static_cast<int32_t>(shard->allele_seqs.size());
              shard->allele_ids.emplace(allele, id);
              shard->allele_seqs.push_back(allele);
            } else {
              id = it->second;
            }
            counts[w * n_channels + (strand ? CH_i : CH_I)] += 1;
            int64_t& gr = group_rank[w * 6 + 4];
            if (rank + 1 < gr) gr = rank + 1;
            if (phased && hp >= 1 && hp <= 2)
              counts[w * n_channels + 18 + (hp - 1) * 6 + 4] += 1;
            shard->ins_pos.push_back(static_cast<int32_t>(attach));
            shard->ins_strand.push_back(strand);
            shard->ins_rank.push_back(rank + 1);
            shard->ins_allele.push_back(id);
          } else if (nop == CIGAR_D) {
            counts[w * n_channels + (strand ? CH_d : CH_D)] += 1;
            int64_t& gr = group_rank[w * 6 + 5];
            if (rank + 1 < gr) gr = rank + 1;
            if (phased && hp >= 1 && hp <= 2)
              counts[w * n_channels + 18 + (hp - 1) * 6 + 5] += 1;
            if (nlen > max_del_length[w])
              max_del_length[w] = static_cast<int32_t>(nlen);
            shard->del_pos.push_back(static_cast<int32_t>(attach));
            shard->del_strand.push_back(strand);
            shard->del_rank.push_back(rank + 1);
            shard->del_len.push_back(static_cast<int32_t>(nlen));
          }
        }
        qpos += len;
        rpos += len;
      } else if (op == CIGAR_D) {
        int64_t lo = rpos > sub_lo ? rpos : sub_lo;
        int64_t hi = (rpos + len) < sub_hi ? (rpos + len) : sub_hi;
        for (int64_t p = lo; p < hi; ++p)
          counts[(p - start) * n_channels + (strand ? CH_HASH : CH_STAR)] += 1;
        rpos += len;
      } else if (op == CIGAR_N) {
        int64_t lo = rpos > sub_lo ? rpos : sub_lo;
        int64_t hi = (rpos + len) < sub_hi ? (rpos + len) : sub_hi;
        int32_t* target = strand ? skip_rev : skip_fwd;
        for (int64_t p = lo; p < hi; ++p) target[p - start] += 1;
        rpos += len;
      } else if (op == CIGAR_I || op == CIGAR_S) {
        qpos += len;
      }
    }
  }

  // I1/i1, D1/d1 for this subrange: every event at an owned position lives in
  // this shard, so local allele ids are sufficient for per-allele grouping.
  {
    std::unordered_map<int64_t, int32_t> per_allele;
    int64_t n_local = static_cast<int64_t>(shard->allele_seqs.size());
    per_allele.reserve(shard->ins_pos.size() * 2);
    for (size_t i = 0; i < shard->ins_pos.size(); ++i) {
      int64_t key = ((int64_t(shard->ins_pos[i] - start) * 2
                      + shard->ins_strand[i]) * (n_local ? n_local : 1))
                    + shard->ins_allele[i];
      per_allele[key] += 1;
    }
    for (const auto& kv : per_allele) {
      int64_t ps = kv.first / (n_local ? n_local : 1);
      int64_t w = ps / 2;
      int strand = static_cast<int>(ps % 2);
      int32_t& slot = counts[w * n_channels + (strand ? CH_i1 : CH_I1)];
      if (kv.second > slot) slot = kv.second;
    }
  }
  {
    std::unordered_map<int64_t, int32_t> per_len;
    per_len.reserve(shard->del_pos.size() * 2);
    for (size_t i = 0; i < shard->del_pos.size(); ++i) {
      int64_t key = (int64_t(shard->del_pos[i] - start) * 2
                     + shard->del_strand[i]) * 100001 + shard->del_len[i];
      per_len[key] += 1;
    }
    for (const auto& kv : per_len) {
      int64_t ps = kv.first / 100001;
      int64_t w = ps / 2;
      int strand = static_cast<int>(ps % 2);
      int32_t& slot = counts[w * n_channels + (strand ? CH_d1 : CH_D1)];
      if (kv.second > slot) slot = kv.second;
    }
  }
}

int tile_thread_count(int64_t width, size_t n_records) {
  const char* env = getenv("CLAIR3_RNA_TORCH_NATIVE_THREADS");
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int t = env ? atoi(env) : (hw > 0 ? hw : 1);
  if (t < 1) t = 1;
  if (t > 64) t = 64;
  // below ~64kb of positions or very few reads, thread spawn overhead wins
  int64_t by_width = width / 65536;
  int64_t by_records = static_cast<int64_t>(n_records / 512);
  int64_t cap = by_width < by_records ? by_width : by_records;
  if (cap < 1) cap = 1;
  return t < cap ? t : static_cast<int>(cap);
}

}  // namespace

TileOut* build_tile_native(void* handle, int32_t ref_id, int64_t start,
                           int64_t end, int32_t min_mq, int32_t min_bq,
                           int32_t exclude_flags, int32_t phased) {
  auto* bam = static_cast<BamFile*>(handle);
  int64_t width = end - start;
  int32_t n_channels = 18 + (phased ? 12 : 0);

  std::vector<int32_t> counts(width * n_channels, 0);
  std::vector<int32_t> group_count(width * 6, 0);
  std::vector<int64_t> group_rank(width * 6, RANK_INF);
  std::vector<int32_t> max_del_length(width, 0);
  std::vector<int32_t> read_start_count(width, 0), read_end_count(width, 0),
      skip_fwd(width, 0), skip_rev(width, 0);

  // filter pass: global rank order must match the reference's mpileup read
  // order regardless of how the position axis is partitioned
  RegionRecords region;
  if (!load_region_records(bam, ref_id, start, end, min_mq, exclude_flags,
                           &region))
    return nullptr;
  std::vector<const RecordView*> recs;
  std::vector<int64_t> ranks;
  recs.reserve(region.records.size());
  ranks.reserve(region.records.size());
  for (const RecordView& rv : region.records) {
    ranks.push_back(2 * static_cast<int64_t>(recs.size()));
    recs.push_back(&rv);
  }

  int n_threads = tile_thread_count(width, recs.size());
  std::vector<TileShard> shards(n_threads);
  std::vector<int64_t> bounds(n_threads + 1);
  for (int t = 0; t <= n_threads; ++t)
    bounds[t] = start + width * t / n_threads;

  if (n_threads == 1) {
    tile_worker(recs, ranks, start, start, end, min_bq, n_channels, phased,
                counts.data(), group_count.data(), group_rank.data(),
                max_del_length.data(), read_start_count.data(),
                read_end_count.data(), skip_fwd.data(), skip_rev.data(),
                &shards[0]);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) {
      threads.emplace_back(tile_worker, std::cref(recs), std::cref(ranks),
                           start, bounds[t], bounds[t + 1], min_bq, n_channels,
                           phased, counts.data(), group_count.data(),
                           group_rank.data(), max_del_length.data(),
                           read_start_count.data(), read_end_count.data(),
                           skip_fwd.data(), skip_rev.data(), &shards[t]);
    }
    for (auto& th : threads) th.join();
  }

  // merge shards: remap thread-local insertion allele ids into one global
  // table (deterministic: shards visited in position order, local ids in
  // first-occurrence order)
  std::vector<int32_t> ins_pos, ins_allele;
  std::vector<int8_t> ins_strand;
  std::vector<int64_t> ins_rank;
  std::vector<int32_t> del_pos, del_len;
  std::vector<int8_t> del_strand;
  std::vector<int64_t> del_rank;
  std::unordered_map<std::string, int32_t> allele_ids;
  std::string ins_blob;
  int64_t n_alleles = 0;
  for (TileShard& shard : shards) {
    std::vector<int32_t> remap(shard.allele_seqs.size());
    for (size_t i = 0; i < shard.allele_seqs.size(); ++i) {
      const std::string& allele = shard.allele_seqs[i];
      auto it = allele_ids.find(allele);
      if (it == allele_ids.end()) {
        remap[i] = static_cast<int32_t>(n_alleles);
        allele_ids.emplace(allele, static_cast<int32_t>(n_alleles));
        ins_blob += allele;
        ins_blob.push_back('\0');
        ++n_alleles;
      } else {
        remap[i] = it->second;
      }
    }
    for (size_t i = 0; i < shard.ins_pos.size(); ++i) {
      ins_pos.push_back(shard.ins_pos[i]);
      ins_strand.push_back(shard.ins_strand[i]);
      ins_rank.push_back(shard.ins_rank[i]);
      ins_allele.push_back(remap[shard.ins_allele[i]]);
    }
    del_pos.insert(del_pos.end(), shard.del_pos.begin(), shard.del_pos.end());
    del_strand.insert(del_strand.end(), shard.del_strand.begin(),
                      shard.del_strand.end());
    del_rank.insert(del_rank.end(), shard.del_rank.begin(),
                    shard.del_rank.end());
    del_len.insert(del_len.end(), shard.del_len.begin(), shard.del_len.end());
  }

  // derive the case-merged pileup_dict group counts from the channel image
  // (fwd + rev per base, I + i, D + d); counts is still pre-negation here
  for (int64_t w = 0; w < width; ++w) {
    const int32_t* c = counts.data() + w * n_channels;
    int32_t* g = group_count.data() + w * 6;
    g[0] = c[0] + c[9];
    g[1] = c[1] + c[10];
    g[2] = c[2] + c[11];
    g[3] = c[3] + c[12];
    g[4] = c[CH_I] + c[CH_i];
    g[5] = c[CH_D] + c[CH_d];
  }

  // cover prefix sums are subrange-local: every read overlapping a subrange
  // contributed its clipped interval there, so each shard's running sum
  // starts from zero at its own sub_lo
  std::vector<int32_t> cover(width);
  for (int t = 0; t < n_threads; ++t) {
    int32_t acc = 0;
    int64_t sub_lo = bounds[t] - start, sub_hi = bounds[t + 1] - start;
    for (int64_t i = sub_lo; i < sub_hi; ++i) {
      acc += shards[t].cover_diff[i - sub_lo];
      cover[i] = acc;
    }
  }

  auto* out = new TileOut();
  out->width = width;
  out->n_channels = n_channels;
  out->counts = steal(counts);
  out->group_count = steal(group_count);
  out->group_rank = steal(group_rank);
  out->max_del_length = steal(max_del_length);
  out->read_start_count = steal(read_start_count);
  out->read_end_count = steal(read_end_count);
  out->skip_fwd_count = steal(skip_fwd);
  out->skip_rev_count = steal(skip_rev);
  out->cover_count = steal(cover);
  out->n_ins = static_cast<int64_t>(ins_pos.size());
  out->ins_pos = steal(ins_pos);
  out->ins_strand = steal(ins_strand);
  out->ins_rank = steal(ins_rank);
  out->ins_allele = steal(ins_allele);
  out->n_ins_seq = n_alleles;
  out->ins_seq_blob_len = static_cast<int64_t>(ins_blob.size());
  out->ins_seq_blob = static_cast<char*>(malloc(ins_blob.size() + 1));
  memcpy(out->ins_seq_blob, ins_blob.data(), ins_blob.size());
  out->ins_seq_blob[ins_blob.size()] = '\0';
  out->n_del = static_cast<int64_t>(del_pos.size());
  out->del_pos = steal(del_pos);
  out->del_strand = steal(del_strand);
  out->del_rank = steal(del_rank);
  out->del_len = steal(del_len);
  return out;
}

// Per-position derived features + candidate mask (the C++ port of
// pileup/builder.py finalize_features + candidate_mask_from +
// negated_counts; differential-tested against the Python implementations by
// tests/test_native_events.py). Negation is applied IN PLACE on t->counts,
// so the returned counts are the emit-ready channel image
// (src/create_tensor_pileup.py:296-297).
struct FinalizeOut {
  int32_t* depth;
  uint8_t* covered;
  int32_t* ins_total;
  int32_t* del_total;
  int32_t* star_total;
  int32_t* alt_count;
  int32_t* ref_count;
  int32_t* max_skip;
  int8_t* eff_ref_code;
  uint8_t* cand_mask;
};

FinalizeOut* finalize_tile_native(TileOut* t, const int8_t* ref_codes,
                                  double snp_af, double indel_af,
                                  int32_t min_coverage, int32_t fast_mode,
                                  int32_t call_snp_only) {
  const int64_t width = t->width;
  const int nch = t->n_channels;
  auto* f = new FinalizeOut();
  f->depth = static_cast<int32_t*>(malloc(width * 4 + 1));
  f->covered = static_cast<uint8_t*>(malloc(width + 1));
  f->ins_total = static_cast<int32_t*>(malloc(width * 4 + 1));
  f->del_total = static_cast<int32_t*>(malloc(width * 4 + 1));
  f->star_total = static_cast<int32_t*>(malloc(width * 4 + 1));
  f->alt_count = static_cast<int32_t*>(malloc(width * 4 + 1));
  f->ref_count = static_cast<int32_t*>(malloc(width * 4 + 1));
  f->max_skip = static_cast<int32_t*>(malloc(width * 4 + 1));
  f->eff_ref_code = static_cast<int8_t*>(malloc(width + 1));
  f->cand_mask = static_cast<uint8_t*>(malloc(width + 1));

  const bool zero_af = (snp_af == 0.0) || (indel_af == 0.0);
  constexpr int64_t RANK_CAP = int64_t(1) << 31;

  for (int64_t w = 0; w < width; ++w) {
    const int32_t* gc = t->group_count + w * 6;
    const int64_t* gr = t->group_rank + w * 6;
    int32_t* cnt = t->counts + w * nch;

    const int32_t ins_total = cnt[CH_I] + cnt[CH_i];
    const int32_t del_total = cnt[CH_D] + cnt[CH_d];
    const int32_t star_total = cnt[CH_STAR] + cnt[CH_HASH];
    const int32_t base_total = gc[0] + gc[1] + gc[2] + gc[3];
    const int32_t depth = base_total + star_total;
    const int8_t rc = ref_codes[w];
    const int8_t eff = rc >= 0 ? rc : 0;
    const int32_t alt_count = base_total - gc[eff];
    int64_t rcount = int64_t(depth) - (del_total + star_total) - ins_total
                     - alt_count;
    if (rcount < 0) rcount = 0;
    int32_t ms = t->read_start_count[w];
    if (t->read_end_count[w] > ms) ms = t->read_end_count[w];
    if (t->skip_fwd_count[w] > ms) ms = t->skip_fwd_count[w];
    if (t->skip_rev_count[w] > ms) ms = t->skip_rev_count[w];
    const uint8_t covered = t->cover_count[w] > 0;

    // pass_af (src/create_tensor_pileup.py:267-299,535-556); doubles match
    // the Python float64 comparisons bit-for-bit
    const double denom = depth > 0 ? double(depth) : 1.0;
    bool pass_snp = false;
    for (int code = 0; code < 4; ++code) {
      if (code == eff) continue;
      const int32_t nr = gc[code];
      if (double(nr) / denom >= snp_af && (!fast_mode || nr >= 4)) {
        pass_snp = true;
        break;
      }
    }
    const bool pass_indel = (double(ins_total) / denom >= indel_af)
                            || (double(del_total) / denom >= indel_af);
    // Counter-stable top group: maximize (count, -first_occurrence_rank)
    int best = 0;
    int64_t best_key = INT64_MIN;
    for (int g = 0; g < 6; ++g) {
      int64_t key = INT64_MIN;
      if (gc[g] != 0) {
        int64_t r = gr[g] < RANK_CAP ? gr[g] : RANK_CAP;
        key = (int64_t(gc[g]) << 32) - r;
      }
      if (key > best_key) {
        best_key = key;
        best = g;
      }
    }
    const bool pass_top = gc[best] > 0 && best != eff;
    bool pass_af = call_snp_only ? pass_snp
                                 : (pass_top || pass_snp || pass_indel);
    if (zero_af) pass_af = pass_af || depth > 0;

    f->depth[w] = depth;
    f->covered[w] = covered;
    f->ins_total[w] = ins_total;
    f->del_total[w] = del_total;
    f->star_total[w] = star_total;
    f->alt_count[w] = alt_count;
    f->ref_count[w] = static_cast<int32_t>(rcount);
    f->max_skip[w] = ms;
    f->eff_ref_code[w] = eff;
    f->cand_mask[w] = covered && rc >= 0 && pass_af && depth >= min_coverage;

    // ref-channel negation, in place, after the sums that read the originals
    const int32_t fwd_sum = cnt[0] + cnt[1] + cnt[2] + cnt[3];
    const int32_t rev_sum = cnt[9] + cnt[10] + cnt[11] + cnt[12];
    cnt[eff] = -fwd_sum;
    cnt[eff + 9] = -rev_sum;
  }
  return f;
}

void free_finalize_native(FinalizeOut* f) {
  if (!f) return;
  free(f->depth);
  free(f->covered);
  free(f->ins_total);
  free(f->del_total);
  free(f->star_total);
  free(f->alt_count);
  free(f->ref_count);
  free(f->max_skip);
  free(f->eff_ref_code);
  free(f->cand_mask);
  delete f;
}

void free_tile_native(TileOut* out) {
  if (!out) return;
  free(out->counts); free(out->group_count); free(out->group_rank);
  free(out->max_del_length);
  free(out->read_start_count); free(out->read_end_count);
  free(out->skip_fwd_count); free(out->skip_rev_count); free(out->cover_count);
  free(out->ins_pos); free(out->ins_strand); free(out->ins_rank);
  free(out->ins_allele); free(out->ins_seq_blob);
  free(out->del_pos); free(out->del_strand); free(out->del_rank);
  free(out->del_len);
  delete out;
}

// ---------------------------------------------------------------------------
// Packed-read extraction: the device-side CIGAR-expansion wire format.
//
// Instead of materializing one 11-byte event per aligned base (the
// extract_events_native output the round-2 fused path shipped to HBM), this
// emits "tilelet" rows: for each (read, 512-position tile) pair the read's
// aligned base codes are written nibble-packed at their tile-relative
// offsets. The wire cost is ~0.5-0.9 B/base (vs 11 B/event), and the work
// here is a LUT-store per base -- no per-base vector pushes -- so extraction
// runs at count-kernel speed. Star placeholders, insertions and deletions
// (sparse, ~1% of events in RNA data) stay as flat event arrays; the device
// kernel (ops/tilelet.py) expands tilelets into the channel-count image.
// Replaces the reference's per-read expansion loop
// (src/create_tensor_pileup.py:485-611,113-176) on the device side.
// ---------------------------------------------------------------------------

struct PackedOut {
  int64_t n_rows;           // tilelet rows, sorted by tile
  int64_t n_tiles;          // ceil(width / 512)
  int64_t n_base;           // base codes written (event accounting)
  uint8_t* tl_codes;        // [n_rows * 256] nibble-packed: even offset in the
                            // high nibble, odd in the low; 0xF = empty
  int32_t* tl_tile;         // [n_rows] tile index (nondecreasing)
  int32_t* tl_rank;         // [n_rows] 2 * read_index
  int8_t* tl_strand;        // [n_rows]
  int8_t* tl_hp;            // [n_rows]
  // sparse events (identical semantics to EventsOut)
  int64_t n_star;
  int32_t* star_pos;
  int8_t* star_strand;
  int8_t* star_hp;
  int64_t n_ins;
  int32_t* ins_pos;
  int8_t* ins_strand;
  int64_t* ins_rank;
  int8_t* ins_hp;
  int32_t* ins_allele;
  int64_t n_ins_seq;
  char* ins_seq_blob;
  int64_t ins_seq_blob_len;
  int64_t n_del;
  int32_t* del_pos;
  int8_t* del_strand;
  int64_t* del_rank;
  int8_t* del_hp;
  int32_t* del_len;
  // dense per-position arrays over [start, end)
  int32_t* read_start_count;
  int32_t* read_end_count;
  int32_t* skip_fwd_count;
  int32_t* skip_rev_count;
  int32_t* cover_count;
};

struct PackedRowMeta { int32_t rank; int8_t strand; int8_t hp; };

// Per-thread outputs of packed_worker for one TILE-ALIGNED position slice
// [sub_lo, sub_hi). Tile rows live in shard-local arenas (each tile is
// wholly owned by exactly one slice); sparse events carry their rank so the
// merge can restore the single-thread read-major order with a stable sort
// (stars get a rank column here for ordering only -- it is not exported).
struct PackedShard {
  std::vector<std::vector<uint8_t>> tile_codes;   // [tile_hi - tile_lo]
  std::vector<std::vector<PackedRowMeta>> tile_meta;
  std::vector<int64_t> star_rank;
  std::vector<int32_t> star_pos;
  std::vector<int8_t> star_strand, star_hp;
  std::vector<int64_t> ins_rank;
  std::vector<int32_t> ins_pos, ins_allele;       // shard-local allele ids
  std::vector<int8_t> ins_strand, ins_hp;
  std::vector<std::string> allele_seqs;
  std::unordered_map<std::string, int32_t> allele_ids;
  std::vector<int64_t> del_rank;
  std::vector<int32_t> del_pos, del_len;
  std::vector<int8_t> del_strand, del_hp;
  std::vector<int32_t> cover_diff;                // local [sub_hi-sub_lo+1]
  int64_t n_base = 0;
};

// Walk every record overlapping [sub_lo, sub_hi) with clipped inner loops.
// Dense arrays (read_start/end, skips) are shared: each thread owns a
// disjoint position slice, so writes never race; boundary-spanning reads
// are re-walked by both owners (same pattern as tile_worker).
static void packed_worker(const std::vector<RecordView>& records,
                          int64_t start, int64_t sub_lo, int64_t sub_hi,
                          int64_t tile_lo, int32_t min_bq,
                          int32_t* read_start_count, int32_t* read_end_count,
                          int32_t* skip_fwd, int32_t* skip_rev,
                          PackedShard* shard) {
  constexpr int TILE_SHIFT = 8;       // keep in sync with ops/tilelet.py
  constexpr int TILE = 1 << TILE_SHIFT;
  constexpr int TILE_BYTES = TILE / 2;
  shard->cover_diff.assign(sub_hi - sub_lo + 1, 0);
  auto& tile_codes = shard->tile_codes;
  auto& tile_meta = shard->tile_meta;

  for (size_t read_index = 0; read_index < records.size(); ++read_index) {
    const RecordView& rv = records[read_index];
    if (rv.pos >= sub_hi) break;     // records are position-sorted
    if (rv.end <= sub_lo) continue;
    const int32_t rank = static_cast<int32_t>(2 * read_index);
    const int8_t strand = (rv.flag & 0x10) ? 1 : 0;

    const uint8_t* body = rv.body;
    uint8_t l_read_name = body[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, body + 12, 2);
    int32_t l_seq;
    memcpy(&l_seq, body + 16, 4);
    const uint8_t* cig = body + 32 + l_read_name;
    const uint8_t* seq = cig + 4 * n_cigar;
    const uint8_t* qual = seq + (l_seq + 1) / 2;
    const uint8_t* tags = qual + l_seq;
    const int8_t hp = static_cast<int8_t>(parse_hp_tag(tags, body + rv.body_len));

    if (rv.pos >= sub_lo && rv.pos < sub_hi)
      read_start_count[rv.pos - start] += 1;
    if (rv.end - 1 >= sub_lo && rv.end - 1 < sub_hi)
      read_end_count[rv.end - 1 - start] += 1;
    int64_t clo = rv.pos > sub_lo ? rv.pos : sub_lo;
    int64_t chi = rv.end < sub_hi ? rv.end : sub_hi;
    if (clo < chi) {
      shard->cover_diff[clo - sub_lo] += 1;
      shard->cover_diff[chi - sub_lo] -= 1;
    }

    // a read visits tiles in nondecreasing order; one row per (read, tile)
    int64_t cur_tile = -1;
    uint8_t* cur_row = nullptr;

    int64_t qpos = 0, rpos = rv.pos;
    for (int k = 0; k < n_cigar; ++k) {
      uint32_t v;
      memcpy(&v, cig + 4 * k, 4);
      int op = v & 0xF;
      int64_t len = v >> 4;
      if (op == CIGAR_M || op == CIGAR_EQ || op == CIGAR_X) {
        int64_t lo = rpos > sub_lo ? rpos : sub_lo;
        int64_t hi = (rpos + len) < sub_hi ? (rpos + len) : sub_hi;
        int64_t p = lo;
        while (p < hi) {
          const int64_t off = p - start;
          const int64_t t = off >> TILE_SHIFT;
          const int64_t tl = t - tile_lo;   // shard-local arena index
          if (t != cur_tile) {
            cur_tile = t;
            tile_codes[tl].resize(tile_codes[tl].size() + TILE_BYTES, 0xFF);
            tile_meta[tl].push_back({rank, strand, hp});
            cur_row = tile_codes[tl].data() + tile_codes[tl].size() - TILE_BYTES;
          }
          const int64_t tile_hi_abs = start + ((t + 1) << TILE_SHIFT);
          const int64_t run_hi = hi < tile_hi_abs ? hi : tile_hi_abs;
          for (; p < run_hi; ++p) {
            const int64_t qi = qpos + (p - rpos);
            const uint8_t byte = seq[qi >> 1];
            const uint8_t nt16 = (qi & 1) ? (byte & 0xF) : (byte >> 4);
            int8_t code = code_of_nt16(nt16);
            if (code >= 0 && min_bq > 0) {
              const uint8_t q = qual[qi];
              if (q != 0xFF && q < min_bq) code = -1;
            }
            if (code < 0) continue;  // slot stays 0xF (empty)
            const int64_t o = (p - start) & (TILE - 1);
            uint8_t& b = cur_row[o >> 1];
            if (o & 1)
              b = (b & 0xF0) | static_cast<uint8_t>(code);
            else
              b = (b & 0x0F) | static_cast<uint8_t>(code << 4);
            ++shard->n_base;
          }
        }
        int64_t attach = rpos + len - 1;
        if (attach >= sub_lo && attach < sub_hi && k + 1 < n_cigar) {
          uint32_t nv;
          memcpy(&nv, cig + 4 * (k + 1), 4);
          int nop = nv & 0xF;
          int64_t nlen = nv >> 4;
          if (nop == CIGAR_I) {
            std::string allele;
            allele.reserve(nlen);
            for (int64_t j = 0; j < nlen; ++j) {
              const int64_t qi = qpos + len + j;
              const uint8_t byte = seq[qi >> 1];
              const uint8_t nt16 = (qi & 1) ? (byte & 0xF) : (byte >> 4);
              allele.push_back(SEQ_NT16[nt16]);
            }
            auto it = shard->allele_ids.find(allele);
            int32_t id;
            if (it == shard->allele_ids.end()) {
              id = static_cast<int32_t>(shard->allele_seqs.size());
              shard->allele_ids.emplace(allele, id);
              shard->allele_seqs.push_back(allele);
            } else {
              id = it->second;
            }
            shard->ins_pos.push_back(static_cast<int32_t>(attach));
            shard->ins_strand.push_back(strand);
            shard->ins_rank.push_back(rank + 1);
            shard->ins_hp.push_back(hp);
            shard->ins_allele.push_back(id);
          } else if (nop == CIGAR_D) {
            shard->del_pos.push_back(static_cast<int32_t>(attach));
            shard->del_strand.push_back(strand);
            shard->del_rank.push_back(rank + 1);
            shard->del_hp.push_back(hp);
            shard->del_len.push_back(static_cast<int32_t>(nlen));
          }
        }
        qpos += len;
        rpos += len;
      } else if (op == CIGAR_D) {
        int64_t lo = rpos > sub_lo ? rpos : sub_lo;
        int64_t hi = (rpos + len) < sub_hi ? (rpos + len) : sub_hi;
        for (int64_t p = lo; p < hi; ++p) {
          shard->star_rank.push_back(rank);
          shard->star_pos.push_back(static_cast<int32_t>(p));
          shard->star_strand.push_back(strand);
          shard->star_hp.push_back(hp);
        }
        rpos += len;
      } else if (op == CIGAR_N) {
        int64_t lo = rpos > sub_lo ? rpos : sub_lo;
        int64_t hi = (rpos + len) < sub_hi ? (rpos + len) : sub_hi;
        if (lo < hi) {
          auto& target = strand ? skip_rev : skip_fwd;
          int32_t* tgt = target;
          for (int64_t p = lo; p < hi; ++p) tgt[p - start] += 1;
        }
        rpos += len;
      } else if (op == CIGAR_I || op == CIGAR_S) {
        qpos += len;
      }
    }
  }
}

PackedOut* extract_packed_native(void* handle, int32_t ref_id, int64_t start,
                                 int64_t end, int32_t min_mq, int32_t min_bq,
                                 int32_t exclude_flags) {
  constexpr int TILE_SHIFT = 8;       // keep in sync with ops/tilelet.py
  constexpr int TILE = 1 << TILE_SHIFT;
  constexpr int TILE_BYTES = TILE / 2;
  auto* bam = static_cast<BamFile*>(handle);
  const int64_t width = end - start;
  const int64_t n_tiles = width > 0 ? (width + TILE - 1) / TILE : 0;

  std::vector<int32_t> read_start_count(width, 0), read_end_count(width, 0),
      skip_fwd(width, 0), skip_rev(width, 0);

  RegionRecords region;
  if (!load_region_records(bam, ref_id, start, end, min_mq, exclude_flags,
                           &region))
    return nullptr;

  // position-sliced threading with TILE-ALIGNED bounds: every (read, tile)
  // row belongs to exactly one slice, so concatenating shard arenas in
  // slice order reproduces the single-thread tile-major row order exactly.
  // Gate: 32 kb of positions and 256 reads per slice (cheaper than the
  // tile builder's 64 kb gate -- this pass writes ~1 B/base arenas, so
  // there is ~2x more work per position than the in-place count)
  const char* thr_env = getenv("CLAIR3_RNA_TORCH_NATIVE_THREADS");
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int n_threads = thr_env ? atoi(thr_env) : (hw > 0 ? hw : 1);
  if (n_threads > 64) n_threads = 64;
  int64_t cap = width / 32768;
  int64_t by_records = static_cast<int64_t>(region.records.size() / 256);
  if (by_records < cap) cap = by_records;
  if (cap < 1) cap = 1;
  if (n_threads > cap) n_threads = static_cast<int>(cap);
  if (n_threads > n_tiles && n_tiles > 0)
    n_threads = static_cast<int>(n_tiles);
  if (n_threads < 1) n_threads = 1;
  std::vector<PackedShard> shards(n_threads);
  std::vector<int64_t> tile_bounds(n_threads + 1);
  for (int t = 0; t <= n_threads; ++t)
    tile_bounds[t] = n_tiles * t / n_threads;
  auto sub_lo_of = [&](int t) { return start + tile_bounds[t] * TILE; };
  auto sub_hi_of = [&](int t) {
    int64_t hi = start + tile_bounds[t + 1] * TILE;
    return hi < end ? hi : end;
  };
  for (int t = 0; t < n_threads; ++t) {
    int64_t nt = tile_bounds[t + 1] - tile_bounds[t];
    shards[t].tile_codes.resize(nt);
    shards[t].tile_meta.resize(nt);
  }
  if (n_threads == 1) {
    packed_worker(region.records, start, start, end, 0, min_bq,
                  read_start_count.data(), read_end_count.data(),
                  skip_fwd.data(), skip_rev.data(), &shards[0]);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t)
      threads.emplace_back(packed_worker, std::cref(region.records), start,
                           sub_lo_of(t), sub_hi_of(t), tile_bounds[t], min_bq,
                           read_start_count.data(), read_end_count.data(),
                           skip_fwd.data(), skip_rev.data(), &shards[t]);
    for (auto& th : threads) th.join();
  }

  int64_t n_base = 0;
  for (const PackedShard& s : shards) n_base += s.n_base;

  // rows: shard arenas in slice order == global tile order
  int64_t n_rows = 0;
  for (const PackedShard& s : shards)
    for (const auto& meta : s.tile_meta)
      n_rows += static_cast<int64_t>(meta.size());
  auto* out = new PackedOut();
  out->n_rows = n_rows;
  out->n_tiles = n_tiles;
  out->n_base = n_base;
  out->tl_codes = static_cast<uint8_t*>(malloc(n_rows * TILE_BYTES + 1));
  out->tl_tile = static_cast<int32_t*>(malloc(n_rows * 4 + 1));
  out->tl_rank = static_cast<int32_t*>(malloc(n_rows * 4 + 1));
  out->tl_strand = static_cast<int8_t*>(malloc(n_rows + 1));
  out->tl_hp = static_cast<int8_t*>(malloc(n_rows + 1));
  int64_t r = 0;
  for (int sh = 0; sh < n_threads; ++sh) {
    PackedShard& s = shards[sh];
    for (size_t tl = 0; tl < s.tile_meta.size(); ++tl) {
      const auto& meta = s.tile_meta[tl];
      if (meta.empty()) continue;
      const int64_t t = tile_bounds[sh] + static_cast<int64_t>(tl);
      memcpy(out->tl_codes + r * TILE_BYTES, s.tile_codes[tl].data(),
             meta.size() * TILE_BYTES);
      for (const PackedRowMeta& m : meta) {
        out->tl_tile[r] = static_cast<int32_t>(t);
        out->tl_rank[r] = m.rank;
        out->tl_strand[r] = m.strand;
        out->tl_hp[r] = m.hp;
        ++r;
      }
      s.tile_codes[tl].clear();
      s.tile_codes[tl].shrink_to_fit();
    }
  }

  // sparse events: concatenate shards (each shard is rank-nondecreasing),
  // then stable-sort by rank to restore the exact single-thread read-major
  // order; insertion allele ids are reassigned in first-occurrence order of
  // the RESTORED order, reproducing single-thread ids bit-for-bit
  struct StarRef { int64_t rank; int sh; int64_t i; };
  struct InsRef { int64_t rank; int sh; int64_t i; };
  struct DelRef { int64_t rank; int sh; int64_t i; };
  std::vector<StarRef> star_refs;
  std::vector<InsRef> ins_refs;
  std::vector<DelRef> del_refs;
  for (int sh = 0; sh < n_threads; ++sh) {
    const PackedShard& s = shards[sh];
    for (int64_t i = 0; i < static_cast<int64_t>(s.star_pos.size()); ++i)
      star_refs.push_back({s.star_rank[i], sh, i});
    for (int64_t i = 0; i < static_cast<int64_t>(s.ins_pos.size()); ++i)
      ins_refs.push_back({s.ins_rank[i], sh, i});
    for (int64_t i = 0; i < static_cast<int64_t>(s.del_pos.size()); ++i)
      del_refs.push_back({s.del_rank[i], sh, i});
  }
  std::stable_sort(star_refs.begin(), star_refs.end(),
                   [](const StarRef& a, const StarRef& b) {
                     return a.rank < b.rank;
                   });
  std::stable_sort(ins_refs.begin(), ins_refs.end(),
                   [](const InsRef& a, const InsRef& b) {
                     return a.rank < b.rank;
                   });
  std::stable_sort(del_refs.begin(), del_refs.end(),
                   [](const DelRef& a, const DelRef& b) {
                     return a.rank < b.rank;
                   });

  std::vector<int32_t> star_pos;
  std::vector<int8_t> star_strand, star_hp;
  star_pos.reserve(star_refs.size());
  for (const StarRef& ref : star_refs) {
    const PackedShard& s = shards[ref.sh];
    star_pos.push_back(s.star_pos[ref.i]);
    star_strand.push_back(s.star_strand[ref.i]);
    star_hp.push_back(s.star_hp[ref.i]);
  }

  std::vector<int32_t> ins_pos, ins_allele;
  std::vector<int8_t> ins_strand, ins_hp;
  std::vector<int64_t> ins_rank;
  std::unordered_map<std::string, int32_t> allele_ids;
  std::string ins_blob;
  int64_t n_alleles = 0;
  ins_pos.reserve(ins_refs.size());
  for (const InsRef& ref : ins_refs) {
    const PackedShard& s = shards[ref.sh];
    const std::string& allele = s.allele_seqs[s.ins_allele[ref.i]];
    auto it = allele_ids.find(allele);
    int32_t id;
    if (it == allele_ids.end()) {
      id = static_cast<int32_t>(n_alleles++);
      allele_ids.emplace(allele, id);
      ins_blob += allele;
      ins_blob.push_back('\0');
    } else {
      id = it->second;
    }
    ins_pos.push_back(s.ins_pos[ref.i]);
    ins_strand.push_back(s.ins_strand[ref.i]);
    ins_rank.push_back(s.ins_rank[ref.i]);
    ins_hp.push_back(s.ins_hp[ref.i]);
    ins_allele.push_back(id);
  }

  std::vector<int32_t> del_pos, del_len;
  std::vector<int8_t> del_strand, del_hp;
  std::vector<int64_t> del_rank;
  del_pos.reserve(del_refs.size());
  for (const DelRef& ref : del_refs) {
    const PackedShard& s = shards[ref.sh];
    del_pos.push_back(s.del_pos[ref.i]);
    del_strand.push_back(s.del_strand[ref.i]);
    del_rank.push_back(s.del_rank[ref.i]);
    del_hp.push_back(s.del_hp[ref.i]);
    del_len.push_back(s.del_len[ref.i]);
  }

  // cover prefix sums are slice-local (every read overlapping a slice
  // contributed its clipped interval there), same as build_tile_native
  std::vector<int32_t> cover(width);
  for (int t = 0; t < n_threads; ++t) {
    int32_t acc = 0;
    int64_t lo = sub_lo_of(t) - start, hi = sub_hi_of(t) - start;
    for (int64_t i = lo; i < hi; ++i) {
      acc += shards[t].cover_diff[i - lo];
      cover[i] = acc;
    }
  }

  out->n_star = static_cast<int64_t>(star_pos.size());
  out->star_pos = steal(star_pos);
  out->star_strand = steal(star_strand);
  out->star_hp = steal(star_hp);
  out->n_ins = static_cast<int64_t>(ins_pos.size());
  out->ins_pos = steal(ins_pos);
  out->ins_strand = steal(ins_strand);
  out->ins_rank = steal(ins_rank);
  out->ins_hp = steal(ins_hp);
  out->ins_allele = steal(ins_allele);
  out->n_ins_seq = n_alleles;
  out->ins_seq_blob_len = static_cast<int64_t>(ins_blob.size());
  out->ins_seq_blob = static_cast<char*>(malloc(ins_blob.size() + 1));
  memcpy(out->ins_seq_blob, ins_blob.data(), ins_blob.size());
  out->ins_seq_blob[ins_blob.size()] = '\0';
  out->n_del = static_cast<int64_t>(del_pos.size());
  out->del_pos = steal(del_pos);
  out->del_strand = steal(del_strand);
  out->del_rank = steal(del_rank);
  out->del_hp = steal(del_hp);
  out->del_len = steal(del_len);
  out->read_start_count = steal(read_start_count);
  out->read_end_count = steal(read_end_count);
  out->skip_fwd_count = steal(skip_fwd);
  out->skip_rev_count = steal(skip_rev);
  out->cover_count = steal(cover);
  return out;
}

void free_packed_native(PackedOut* out) {
  if (!out) return;
  free(out->tl_codes); free(out->tl_tile); free(out->tl_rank);
  free(out->tl_strand); free(out->tl_hp);
  free(out->star_pos); free(out->star_strand); free(out->star_hp);
  free(out->ins_pos); free(out->ins_strand); free(out->ins_rank);
  free(out->ins_hp); free(out->ins_allele); free(out->ins_seq_blob);
  free(out->del_pos); free(out->del_strand); free(out->del_rank);
  free(out->del_hp); free(out->del_len);
  free(out->read_start_count); free(out->read_end_count);
  free(out->skip_fwd_count); free(out->skip_rev_count); free(out->cover_count);
  delete out;
}

void free_events_native(EventsOut* out) {
  if (!out) return;
  free(out->base_pos); free(out->base_code); free(out->base_strand);
  free(out->base_rank); free(out->base_hp);
  free(out->star_pos); free(out->star_strand); free(out->star_hp);
  free(out->ins_pos); free(out->ins_strand); free(out->ins_rank);
  free(out->ins_hp); free(out->ins_allele); free(out->ins_seq_blob);
  free(out->del_pos); free(out->del_strand); free(out->del_rank);
  free(out->del_hp); free(out->del_len);
  free(out->read_start_count); free(out->read_end_count);
  free(out->skip_fwd_count); free(out->skip_rev_count); free(out->cover_count);
  delete out;
}

}  // extern "C"

// --- phase + haplotag on raw records ------------------------------------------
//
// The builtin phaser's two passes over the BAM (phasing/pipeline.py), with no
// record made into a Python object. Both walk a contig's records exactly as
// io/bam.py's BamReader.fetch(ctg) yields them: over the BAI chunks it
// queries (passed in), stopping where it stops, and dropping the records it
// drops (reference end 0). The scan returns each kept read's name and its
// (het site, allele) pairs, as phase.read_alleles gives them. The rewrite
// writes the bytes BamWriter.write writes -- its normalisation, not a copy of
// the input -- in io/bgzf.py's blocks, deflated on a pool of threads. Where
// the Python reader or writer would raise, or meet input this code does not
// copy (a B-array tag, a truncated record), a call returns HT_UNSUPPORTED
// and the caller redoes the stage on the Python path.

namespace {

constexpr int32_t HT_OK = 0, HT_IO = 1, HT_UNSUPPORTED = 2;
constexpr size_t BGZF_BLOCK_DATA = 65280;  // io/bgzf.py _MAX_BLOCK_DATA
const uint8_t BGZF_EOF_BLOCK[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0, 0x42, 0x43,
    0x02, 0, 0x1b, 0, 0x03, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// Python's strict bytes.decode(): false where it raises; *chars counts the
// code points.
bool utf8_valid(const uint8_t* s, size_t n, size_t* chars = nullptr) {
  size_t i = 0, count = 0;
  while (i < n) {
    uint8_t b = s[i];
    size_t len;
    uint32_t cp;
    if (b < 0x80) {
      len = 1, cp = b;
    } else if (b >= 0xC2 && b <= 0xDF) {
      len = 2, cp = b & 0x1F;
    } else if (b >= 0xE0 && b <= 0xEF) {
      len = 3, cp = b & 0x0F;
    } else if (b >= 0xF0 && b <= 0xF4) {
      len = 4, cp = b & 0x07;
    } else {
      return false;
    }
    if (i + len > n) return false;
    for (size_t k = 1; k < len; ++k) {
      if ((s[i + k] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (s[i + k] & 0x3F);
    }
    if ((len == 3 && (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF))) ||
        (len == 4 && (cp < 0x10000 || cp > 0x10FFFF)))
      return false;
    i += len;
    ++count;
  }
  if (chars) *chars = count;
  return true;
}

// The fields of one record as io/bam.py's _decode_record reads them; false
// where it would raise or read past the record.
struct RecordLayout {
  int32_t ref_id, pos, l_seq;
  uint8_t mapq;
  uint16_t n_cigar, flag;
  size_t name_len;
  const uint8_t *name, *cigar, *seq, *qual, *tags, *end;
  int64_t ref_span;
};

bool layout_of(const uint8_t* body, int32_t len, RecordLayout* r) {
  if (len < 32) return false;
  memcpy(&r->ref_id, body, 4);
  memcpy(&r->pos, body + 4, 4);
  uint8_t l_read_name = body[8];
  r->mapq = body[9];
  memcpy(&r->n_cigar, body + 12, 2);
  memcpy(&r->flag, body + 14, 2);
  memcpy(&r->l_seq, body + 16, 4);
  if (r->l_seq < 0) return false;
  size_t off = 32;
  r->name = body + off;
  r->name_len = l_read_name ? l_read_name - 1 : 0;  // buf[32:32 + l - 1]
  off += l_read_name;
  r->cigar = body + off;
  off += 4 * size_t(r->n_cigar);
  r->seq = body + off;
  off += (size_t(r->l_seq) + 1) / 2;
  r->qual = body + off;
  off += size_t(r->l_seq);
  if (off > size_t(len)) return false;
  r->tags = body + off;
  r->end = body + len;
  if (!utf8_valid(r->name, r->name_len)) return false;
  r->ref_span = 0;
  for (int k = 0; k < r->n_cigar; ++k) {
    uint32_t v;
    memcpy(&v, r->cigar + 4 * k, 4);
    if ((v & 0xF) > CIGAR_X) return false;  // CONSUMES_REF[op] raises
    if (consumes_ref(v & 0xF)) r->ref_span += v >> 4;
  }
  return true;
}

// A record's tags as the Python dict holds them (a repeated key keeps its
// first place and its last value), each kept as BamWriter._encode_tags
// encodes it: its type byte and payload.
struct TagList {
  struct Tag {
    uint8_t key[2];
    bool unencodable;  // a B array, an int outside int32: the writer raises
    uint32_t off, len;
  };
  std::vector<Tag> tags;
  std::vector<uint8_t> data;

  void clear() {
    tags.clear();
    data.clear();
  }
  // -> the tag's index
  size_t set(const uint8_t* key, const uint8_t* enc, size_t n, bool bad) {
    Tag t{{key[0], key[1]}, bad, uint32_t(data.size()), uint32_t(n)};
    data.insert(data.end(), enc, enc + n);
    for (size_t i = 0; i < tags.size(); ++i)
      if (tags[i].key[0] == key[0] && tags[i].key[1] == key[1]) {
        tags[i] = t;
        return i;
      }
    tags.push_back(t);
    return tags.size() - 1;
  }
  // more bytes onto the value just set
  void extend(size_t i, const uint8_t* p, size_t n) {
    data.insert(data.end(), p, p + n);
    tags[i].len += uint32_t(n);
  }
  void set_int(const uint8_t* key, int64_t v) {
    uint8_t enc[5];
    if (v >= -128 && v <= 127) {
      enc[0] = 'c', enc[1] = uint8_t(int8_t(v));
      set(key, enc, 2, false);
    } else {
      int32_t w = int32_t(v);
      enc[0] = 'i';
      memcpy(enc + 1, &w, 4);
      set(key, enc, 5, v < INT32_MIN || v > INT32_MAX);
    }
  }
};

// _parse_tags then _encode_tags' value rules over the tag bytes [p, end).
// False where _parse_tags raises (a value past the record, a Z string with
// no NUL, bytes that do not decode, a B array of an unknown subtype).
bool parse_tags(const uint8_t* p, const uint8_t* end, TagList* out) {
  out->clear();
  while (p + 3 <= end) {
    const uint8_t* key = p;
    if (!utf8_valid(key, 2)) return false;
    uint8_t typ = p[2];
    p += 3;
    size_t left = size_t(end - p);
    switch (typ) {
      case 'A': {  // chr(byte), encoded back as UTF-8
        if (left < 1) return false;
        uint8_t enc[3] = {'A', p[0], 0};
        size_t n = 2;
        if (p[0] >= 0x80) enc[1] = 0xC0 | (p[0] >> 6), enc[2] = 0x80 | (p[0] & 0x3F), n = 3;
        out->set(key, enc, n, false);
        p += 1;
        break;
      }
      case 'c': case 'C': {
        if (left < 1) return false;
        out->set_int(key, typ == 'c' ? int64_t(int8_t(p[0])) : int64_t(p[0]));
        p += 1;
        break;
      }
      case 's': case 'S': {
        if (left < 2) return false;
        int16_t s;
        uint16_t u;
        memcpy(&s, p, 2);
        memcpy(&u, p, 2);
        out->set_int(key, typ == 's' ? int64_t(s) : int64_t(u));
        p += 2;
        break;
      }
      case 'i': case 'I': {
        if (left < 4) return false;
        int32_t s;
        uint32_t u;
        memcpy(&s, p, 4);
        memcpy(&u, p, 4);
        out->set_int(key, typ == 'i' ? int64_t(s) : int64_t(u));
        p += 4;
        break;
      }
      case 'f': {  // struct's float -> double -> float round trip
        if (left < 4) return false;
        float f;
        memcpy(&f, p, 4);
        float g = static_cast<float>(static_cast<double>(f));
        uint8_t enc[5] = {'f'};
        memcpy(enc + 1, &g, 4);
        out->set(key, enc, 5, false);
        p += 4;
        break;
      }
      case 'Z': case 'H': {  // a str: one character is written as an A tag
        const uint8_t* nul =
            static_cast<const uint8_t*>(memchr(p, 0, left));
        if (!nul) return false;
        size_t n = size_t(nul - p), chars;
        if (!utf8_valid(p, n, &chars)) return false;
        const uint8_t type = chars == 1 ? 'A' : 'Z';
        out->extend(out->set(key, &type, 1, false), p,
                    chars == 1 ? n : n + 1);  // a Z string keeps its NUL
        p = nul + 1;
        break;
      }
      case 'B': {
        if (left < 5) return false;
        uint8_t sub = p[0];
        uint32_t count;
        memcpy(&count, p + 1, 4);
        size_t size = (sub == 'c' || sub == 'C') ? 1
                      : (sub == 's' || sub == 'S') ? 2
                      : (sub == 'i' || sub == 'I' || sub == 'f') ? 4 : 0;
        if (!size || size * count > left - 5) return false;
        out->set(key, p, 0, true);
        p += 5 + size * count;
        break;
      }
      default:  // an unknown type ends the parse, dropping what follows
        return true;
    }
  }
  return true;
}

// One BGZF block read from the file, not yet inflated.
struct RawBlock {
  uint64_t coff;
  std::vector<uint8_t> payload;  // raw deflate
  uint32_t isize;
};

// The block at the file's position: 1 read, 0 the file's end (fewer than
// 12 bytes, where io/bgzf.py BgzfReader ends too), -1 a bad block.
int read_raw_block(FILE* f, uint64_t coff, RawBlock* b) {
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return 0;
  if (hdr[0] != 0x1f || hdr[1] != 0x8b) return -1;
  uint16_t xlen;
  memcpy(&xlen, hdr + 10, 2);
  std::vector<uint8_t> extra(xlen);
  if (xlen && fread(extra.data(), 1, xlen, f) != xlen) return -1;
  int32_t bsize = -1;
  for (size_t i = 0; i + 4 <= xlen;) {
    uint16_t slen;
    memcpy(&slen, extra.data() + i + 2, 2);
    if (extra[i] == 0x42 && extra[i + 1] == 0x43 && slen == 2) {
      uint16_t v;
      memcpy(&v, extra.data() + i + 4, 2);
      bsize = v + 1;
    }
    i += 4 + slen;
  }
  if (bsize < 12 + xlen + 8) return -1;
  size_t n = bsize - 12 - xlen - 8;
  b->coff = coff;
  b->payload.resize(n + 8);
  if (fread(b->payload.data(), 1, n + 8, f) != n + 8) return -1;
  memcpy(&b->isize, b->payload.data() + n + 4, 4);
  b->payload.resize(n);
  return 1;
}

// Records from a virtual offset on, with io/bgzf.py BgzfReader's offsets: a
// record's end offset names the block that held its last byte, so one that
// ends a block ends at (block << 16) | the block's length. Blocks are read
// ahead and inflated on several threads; a bad block counts only once the
// walk needs its bytes, as it does for the Python reader.
class RecordStream {
 public:
  explicit RecordStream(FILE* f) : f_(f) {}

  bool seek(uint64_t voff) {
    buf_.clear();
    blocks_.clear();
    abs_base_ = cur_ = 0;
    bad_ = eof_ = pending_bad_ = false;
    next_coff_ = voff >> 16;
    fseek(f_, static_cast<long>(next_coff_), SEEK_SET);
    size_t first = 0;
    if (!load(1, &first)) return !bad_;  // at the end: the stream yields nothing
    cur_ = voff & 0xFFFF;
    return cur_ <= first;
  }

  // 1: a record (body, len valid until the next call; vend its end's
  // offset); 0: the stream ended; -1: a bad block or a truncated record.
  int next(const uint8_t** body, int32_t* len, uint64_t* vend) {
    if (cur_ - abs_base_ > (1u << 20)) compact();
    if (!need(4)) return bad_ ? -1 : 0;
    int32_t size;
    memcpy(&size, buf_.data() + (cur_ - abs_base_), 4);
    if (size <= 0 || !need(4 + size_t(size))) return -1;
    *body = buf_.data() + (cur_ - abs_base_) + 4;
    *len = size;
    cur_ += 4 + size_t(size);
    size_t b = blocks_.size() - 1;
    while (blocks_[b].abs >= cur_) --b;
    *vend = (blocks_[b].coff << 16) | (cur_ - blocks_[b].abs);
    return 1;
  }

 private:
  struct Block {
    uint64_t coff;
    size_t abs, len;
  };
  static constexpr size_t kAhead = 64;  // blocks read and inflated at once

  // up to `count` blocks onto the buffer; *first: the first one's length
  bool load(size_t count, size_t* first = nullptr) {
    if (pending_bad_) bad_ = true;
    if (bad_ || eof_) return false;
    std::vector<RawBlock> raw(count);
    size_t n = 0;
    while (n < count) {
      int r = read_raw_block(f_, next_coff_, &raw[n]);
      if (r <= 0) {
        eof_ = r == 0;
        pending_bad_ = r < 0;
        break;
      }
      next_coff_ = static_cast<uint64_t>(ftell(f_));
      ++n;
    }
    if (n == 0) {
      bad_ = pending_bad_;
      return false;
    }
    std::vector<size_t> at(n + 1, buf_.size());
    for (size_t i = 0; i < n; ++i) at[i + 1] = at[i] + raw[i].isize;
    buf_.resize(at[n]);
    std::vector<char> ok(n, 1);
    auto inflate_range = [&](size_t lo, size_t hi) {
      z_stream zs{};
      if (inflateInit2(&zs, -15) != Z_OK) {
        for (size_t i = lo; i < hi; ++i) ok[i] = 0;
        return;
      }
      for (size_t i = lo; i < hi; ++i) {
        if (!raw[i].isize) continue;
        inflateReset(&zs);
        zs.next_in = raw[i].payload.data();
        zs.avail_in = static_cast<uInt>(raw[i].payload.size());
        zs.next_out = buf_.data() + at[i];
        zs.avail_out = raw[i].isize;
        ok[i] = inflate(&zs, Z_FINISH) == Z_STREAM_END && zs.avail_out == 0;
      }
      inflateEnd(&zs);
    };
    int hw = static_cast<int>(std::thread::hardware_concurrency());
    int n_threads = std::max(1, std::min<int>(hw, n / 4));
    if (n_threads == 1) {
      inflate_range(0, n);
    } else {
      std::vector<std::thread> threads;
      for (int t = 0; t < n_threads; ++t)
        threads.emplace_back(inflate_range, n * t / n_threads,
                             n * (t + 1) / n_threads);
      for (auto& th : threads) th.join();
    }
    size_t good = 0;
    while (good < n && ok[good]) ++good;
    if (good < n) {  // keep the blocks before the bad one
      buf_.resize(at[good]);
      pending_bad_ = true;
      eof_ = false;
      if (good == 0) {
        bad_ = true;
        return false;
      }
    }
    for (size_t i = 0; i < good; ++i)
      if (raw[i].isize)
        blocks_.push_back({raw[i].coff, abs_base_ + at[i], raw[i].isize});
    if (first) *first = raw[0].isize;
    return true;
  }
  bool need(size_t n) {
    while (abs_base_ + buf_.size() < cur_ + n)
      if (!load(kAhead)) return false;
    return true;
  }
  void compact() {  // drop the bytes and blocks before the cursor
    buf_.erase(buf_.begin(), buf_.begin() + (cur_ - abs_base_));
    abs_base_ = cur_;
    size_t keep = 0;
    while (keep < blocks_.size() &&
           blocks_[keep].abs + blocks_[keep].len <= cur_)
      ++keep;
    blocks_.erase(blocks_.begin(), blocks_.begin() + keep);
  }

  FILE* f_;
  uint64_t next_coff_ = 0;
  std::vector<uint8_t> buf_;  // inflated bytes from abs_base_ on
  std::vector<Block> blocks_;
  size_t abs_base_ = 0, cur_ = 0;
  bool bad_ = false, eof_ = false, pending_bad_ = false;
};

// fn(record) for each record BamReader.fetch(contig) yields (start 0, end
// ref_end) over its BAI chunks (vbeg, vend pairs). Each record it reads is
// checked as _decode_record would decode it, the one that ends the walk too.
template <class Fn>
int32_t walk_contig(const char* path, const uint64_t* chunks, int64_t n_chunks,
                    int32_t ref_id, int64_t ref_end, Fn&& fn) {
  FILE* f = fopen(path, "rb");
  if (!f) return HT_IO;
  RecordStream rs(f);
  TagList tags;
  int32_t status = HT_OK;
  for (int64_t c = 0; c < n_chunks && status == HT_OK; ++c) {
    if (!rs.seek(chunks[2 * c])) {
      status = HT_UNSUPPORTED;
      break;
    }
    for (;;) {
      const uint8_t* body;
      int32_t len;
      uint64_t voff;
      int r = rs.next(&body, &len, &voff);
      if (r == 0) break;
      RecordLayout rec;
      if (r < 0 || !layout_of(body, len, &rec) ||
          !parse_tags(rec.tags, rec.end, &tags)) {
        status = HT_UNSUPPORTED;
        break;
      }
      if (rec.ref_id != ref_id || rec.pos >= ref_end) {
        fclose(f);
        return HT_OK;  // coordinate-sorted: nothing later is on the contig
      }
      if (rec.pos + rec.ref_span > 0) {
        status = fn(rec, tags);
        if (status != HT_OK) break;
      }
      if (voff >= chunks[2 * c + 1]) break;
    }
  }
  fclose(f);
  return status;
}

// Deflates 65,280-byte blocks on a pool of threads and writes them in order,
// each as io/bgzf.py _build_block builds it; at most `window` blocks are held.
class BgzfPoolWriter {
 public:
  BgzfPoolWriter(FILE* out, int window)
      : out_(out), slots_(std::max(1, window)) {
    for (Slot& s : slots_) s.raw.reserve(BGZF_BLOCK_DATA);
    int hw = static_cast<int>(std::thread::hardware_concurrency());
    int n = std::max(1, std::min<int>(hw, slots_.size()));
    for (int t = 0; t < n; ++t) workers_.emplace_back([this] { work(); });
  }

  ~BgzfPoolWriter() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    work_cv_.notify_all();
    for (auto& th : workers_) th.join();
  }

  void put(const uint8_t* p, size_t n) {
    while (n) {
      if (filled_ - written_ >= slots_.size()) write_oldest();
      Slot& s = slots_[filled_ % slots_.size()];
      size_t take = std::min(n, BGZF_BLOCK_DATA - s.raw.size());
      s.raw.insert(s.raw.end(), p, p + take);
      p += take;
      n -= take;
      if (s.raw.size() == BGZF_BLOCK_DATA) submit();
    }
  }

  // The last partial block, then the EOF block; false on a failed write.
  bool finish() {
    if (filled_ - written_ < slots_.size() &&
        !slots_[filled_ % slots_.size()].raw.empty())
      submit();
    while (written_ < filled_) write_oldest();
    if (fwrite(BGZF_EOF_BLOCK, 1, sizeof BGZF_EOF_BLOCK, out_) !=
        sizeof BGZF_EOF_BLOCK)
      failed_ = true;
    return !failed_;
  }

 private:
  struct Slot {
    std::vector<uint8_t> raw, block;
    bool queued = false, done = false, ok = false;
  };

  void submit() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      size_t i = filled_ % slots_.size();
      slots_[i].queued = true;
      queue_.push_back(i);
    }
    work_cv_.notify_one();
    ++filled_;
  }

  void write_oldest() {
    Slot& s = slots_[written_ % slots_.size()];
    {
      std::unique_lock<std::mutex> lk(mu_);
      done_cv_.wait(lk, [&] { return s.done; });
      s.queued = s.done = false;
    }
    if (!s.ok || fwrite(s.block.data(), 1, s.block.size(), out_) !=
                     s.block.size())
      failed_ = true;
    s.raw.clear();
    ++written_;
  }

  void work() {
    z_stream zs{};
    bool init = deflateInit2(&zs, 6, Z_DEFLATED, -15, 8,
                             Z_DEFAULT_STRATEGY) == Z_OK;
    for (;;) {
      size_t i;
      {
        std::unique_lock<std::mutex> lk(mu_);
        work_cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) break;
        i = queue_.front();
        queue_.pop_front();
      }
      Slot& s = slots_[i];
      bool ok = init && build(&zs, s.raw, &s.block);
      {
        std::lock_guard<std::mutex> lk(mu_);
        s.ok = ok;
        s.done = true;
      }
      done_cv_.notify_all();
    }
    if (init) deflateEnd(&zs);
  }

  // compressobj(6, DEFLATED, -15): compress(data) then flush(), as Python
  // calls deflate; the gzip header with its BC field, then CRC32 and ISIZE.
  static bool build(z_stream* zs, const std::vector<uint8_t>& raw,
                    std::vector<uint8_t>* block) {
    if (deflateReset(zs) != Z_OK) return false;
    size_t bound = deflateBound(zs, raw.size());
    block->resize(18 + bound + 8);
    zs->next_in = const_cast<uint8_t*>(raw.data());
    zs->avail_in = static_cast<uInt>(raw.size());
    zs->next_out = block->data() + 18;
    zs->avail_out = static_cast<uInt>(bound);
    if (deflate(zs, Z_NO_FLUSH) == Z_STREAM_ERROR ||
        deflate(zs, Z_FINISH) != Z_STREAM_END)
      return false;
    size_t payload = zs->total_out;
    size_t bsize = payload + 25;  // the block's size - 1
    if (bsize > 0xFFFF) return false;
    const uint8_t head[16] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0,
                              0, 0xff, 0x06, 0, 0x42, 0x43, 0x02, 0};
    memcpy(block->data(), head, 16);
    uint16_t b16 = static_cast<uint16_t>(bsize);
    memcpy(block->data() + 16, &b16, 2);
    uint32_t crc = static_cast<uint32_t>(
        crc32(crc32(0, Z_NULL, 0), raw.data(), static_cast<uInt>(raw.size())));
    uint32_t isize = static_cast<uint32_t>(raw.size());
    memcpy(block->data() + 18 + payload, &crc, 4);
    memcpy(block->data() + 18 + payload + 4, &isize, 4);
    block->resize(18 + payload + 8);
    return true;
  }

  FILE* out_;
  std::vector<Slot> slots_;
  size_t filled_ = 0, written_ = 0;  // blocks submitted, blocks written
  std::deque<size_t> queue_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable work_cv_, done_cv_;
  bool stop_ = false, failed_ = false;
};

// BamWriter.write's bytes for one record, with `hp` (0: as read) in its HP
// tag; false where the writer would raise.
bool encode_record(const RecordLayout& r, TagList* tags, int hp,
                   std::vector<uint8_t>* out) {
  if (hp) {
    const uint8_t key[2] = {'H', 'P'};
    tags->set_int(key, hp);
  }
  for (const auto& t : tags->tags)
    if (t.unencodable) return false;
  int64_t ref_end = r.pos + r.ref_span;
  if (r.pos < 0) return false;
  uint32_t bin = bai_reg2bin(r.pos, ref_end ? ref_end : r.pos + 1);
  if (bin > 0xFFFF) return false;
  out->clear();
  auto put = [out](const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    out->insert(out->end(), b, b + n);
  };
  int32_t block_size = 0;  // filled in below
  uint8_t l_read_name = static_cast<uint8_t>(r.name_len + 1);
  uint16_t bin16 = static_cast<uint16_t>(bin);
  int32_t no_mate = -1, tlen = 0;
  put(&block_size, 4);
  put(&r.ref_id, 4);
  put(&r.pos, 4);
  put(&l_read_name, 1);
  put(&r.mapq, 1);
  put(&bin16, 2);
  put(&r.n_cigar, 2);
  put(&r.flag, 2);
  put(&r.l_seq, 4);
  put(&no_mate, 4);
  put(&no_mate, 4);
  put(&tlen, 4);
  put(r.name, r.name_len);
  out->push_back(0);
  put(r.cigar, 4 * size_t(r.n_cigar));
  size_t seq_bytes = (size_t(r.l_seq) + 1) / 2;
  put(r.seq, seq_bytes);
  if (r.l_seq & 1) out->back() &= 0xF0;  // the writer pads with code 0
  put(r.qual, size_t(r.l_seq));
  for (const auto& t : tags->tags) {
    put(t.key, 2);
    put(tags->data.data() + t.off, t.len);
  }
  block_size = static_cast<int32_t>(out->size() - 4);
  memcpy(out->data(), &block_size, 4);
  return true;
}

struct HaplotagWriter {
  FILE* out = nullptr;
  std::unique_ptr<BgzfPoolWriter> bgzf;
  std::vector<uint8_t> record;
};

}  // namespace

extern "C" {

struct HetScanOut {
  int64_t n_reads;
  char* name_blob;
  int64_t* name_off;    // n_reads + 1
  int64_t* allele_off;  // n_reads + 1, into allele_site / allele_val
  int32_t* allele_site;
  int8_t* allele_val;   // 0 ref, 1 alt
};

// The phaser's scan of one contig: for every record BamReader.fetch(ctg)
// yields that has no flag of exclude_flags and mapq >= min_mq, its name and
// the (site index, allele) pairs phase.read_alleles gives it over the sorted
// het sites (site_pos; site_ref, site_alt: the VCF's bases as written).
int32_t het_scan_native(const char* bam_path, const uint64_t* chunks,
                        int64_t n_chunks, int32_t ref_id, int64_t ref_end,
                        const int64_t* site_pos, const uint8_t* site_ref,
                        const uint8_t* site_alt, int64_t n_sites,
                        int32_t exclude_flags, int32_t min_mq,
                        HetScanOut** result) {
  std::vector<char> names;
  std::vector<int64_t> name_off{0}, allele_off{0};
  std::vector<int32_t> sites;
  std::vector<int8_t> vals;
  const int64_t* pos_end = site_pos + n_sites;
  int32_t status = walk_contig(
      bam_path, chunks, n_chunks, ref_id, ref_end,
      [&](const RecordLayout& r, TagList&) {
        if ((r.flag & exclude_flags) || r.mapq < min_mq) return HT_OK;
        int64_t qpos = 0, rpos = r.pos;
        for (int k = 0; k < r.n_cigar; ++k) {
          uint32_t v;
          memcpy(&v, r.cigar + 4 * k, 4);
          int op = v & 0xF;
          int64_t len = v >> 4;
          if (op == CIGAR_M || op == CIGAR_EQ || op == CIGAR_X) {
            const int64_t* lo = std::lower_bound(site_pos, pos_end, rpos);
            const int64_t* hi = std::lower_bound(lo, pos_end, rpos + len);
            for (const int64_t* s = lo; s < hi; ++s) {
              int64_t q = qpos + (*s - rpos);
              if (q >= r.l_seq) return HT_UNSUPPORTED;  // seq[q] raises
              uint8_t base = SEQ_NT16[(r.seq[q >> 1] >> ((~q & 1) << 2)) & 0xF];
              int64_t si = s - site_pos;
              if (base == site_alt[si] || base == site_ref[si]) {
                sites.push_back(static_cast<int32_t>(si));
                vals.push_back(base == site_alt[si] ? 1 : 0);
              }
            }
            qpos += len;
            rpos += len;
          } else if (op == CIGAR_D || op == CIGAR_N) {
            rpos += len;
          } else if (op == CIGAR_I || op == CIGAR_S) {
            qpos += len;
          }
        }
        names.insert(names.end(), r.name, r.name + r.name_len);
        name_off.push_back(static_cast<int64_t>(names.size()));
        allele_off.push_back(static_cast<int64_t>(sites.size()));
        return HT_OK;
      });
  if (status != HT_OK) return status;
  auto* out = new HetScanOut();
  out->n_reads = static_cast<int64_t>(name_off.size() - 1);
  out->name_blob = steal(names);
  out->name_off = steal(name_off);
  out->allele_off = steal(allele_off);
  out->allele_site = steal(sites);
  out->allele_val = steal(vals);
  *result = out;
  return HT_OK;
}

void free_het_scan_native(HetScanOut* out) {
  if (!out) return;
  free(out->name_blob); free(out->name_off); free(out->allele_off);
  free(out->allele_site); free(out->allele_val);
  delete out;
}

// The tagged BAM's writer: `header` (BamWriter's header bytes) first, then
// haplotag_rewrite_contig's records; at most window_blocks blocks in memory.
void* haplotag_writer_open(const char* out_path, const uint8_t* header,
                           int64_t header_len, int32_t window_blocks) {
  FILE* out = fopen(out_path, "wb");
  if (!out) return nullptr;
  auto* w = new HaplotagWriter();
  w->out = out;
  w->bgzf = std::make_unique<BgzfPoolWriter>(out, window_blocks);
  w->bgzf->put(header, static_cast<size_t>(header_len));
  return w;
}

// Every record BamReader.fetch(ctg) yields, as BamWriter.write writes it,
// the reads named in names (blob, name_off[n_names + 1]) tagged with their
// hp (1 or 2). counts: records written, of them tagged HP 1, HP 2.
int32_t haplotag_rewrite_contig(void* handle, const char* bam_path,
                                const uint64_t* chunks, int64_t n_chunks,
                                int32_t ref_id, int64_t ref_end,
                                const char* names, const int64_t* name_off,
                                const int8_t* hp, int64_t n_names,
                                int64_t* counts) {
  auto* w = static_cast<HaplotagWriter*>(handle);
  std::unordered_map<std::string_view, int8_t> hp_of;
  hp_of.reserve(static_cast<size_t>(n_names));
  for (int64_t i = 0; i < n_names; ++i)
    hp_of[std::string_view(names + name_off[i],
                           name_off[i + 1] - name_off[i])] = hp[i];
  counts[0] = counts[1] = counts[2] = 0;
  return walk_contig(
      bam_path, chunks, n_chunks, ref_id, ref_end,
      [&](const RecordLayout& r, TagList& tags) {
        auto it = hp_of.find(std::string_view(
            reinterpret_cast<const char*>(r.name), r.name_len));
        int h = it == hp_of.end() ? 0 : it->second;
        if (!encode_record(r, &tags, h, &w->record)) return HT_UNSUPPORTED;
        w->bgzf->put(w->record.data(), w->record.size());
        ++counts[0];
        if (h == 1 || h == 2) ++counts[h];
        return HT_OK;
      });
}

// Flushes the last block and the EOF block, closes the file and frees the
// writer; HT_IO where a write failed.
int32_t haplotag_writer_close(void* handle) {
  auto* w = static_cast<HaplotagWriter*>(handle);
  bool ok = w->bgzf->finish();
  w->bgzf.reset();
  ok = fclose(w->out) == 0 && ok;
  delete w;
  return ok ? HT_OK : HT_IO;
}

}  // extern "C"
