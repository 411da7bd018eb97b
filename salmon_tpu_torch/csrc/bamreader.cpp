// Copied from native/bamreader.cpp of the JAX package (salmon_tpu), unchanged
// below this comment: the port builds it into its own host library
// (salmon_tpu_torch/_native.py) and loads nothing under native/.

// Native BAM/BGZF reader for salmon_tpu's alignment-based mode.
//
// Role of the reference's htslib + BAMQueue producer
// (include/salmon/internal/alignment/BAMQueue.hpp/.tpp, src/io/
// AlignmentIO.cpp): decompress BGZF blocks, parse BAM records, and emit
// flat fixed-width arrays ready to assemble into device batches. No
// htslib dependency — BGZF is plain deflate blocks (RFC1952 member with a
// BC extra field), inflated with zlib.
//
// C ABI (consumed via ctypes from salmon_tpu/alignment/bamio.py):
//   bam_open(path) -> handle          bam_close(handle)
//   bam_n_refs / bam_ref_name / bam_ref_len   -- header access
//   bam_next_batch(handle, cap, seq_cap, ...) -- fill caller arrays
//
// Each record row: refid, pos, flag, mapq, mate_refid, mate_pos, tlen,
// read length, offset+length of decoded seq codes in the shared seq
// buffer, offset+count of cigar ops, AS/NM tag values (INT32_MIN when
// absent), and a 64-bit FNV hash of the read name (adjacent records with
// equal hash+name belong to one fragment; BAM convention keeps a read's
// records contiguous, as the reference requires).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <limits>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

// BGZF blocks are independent raw-deflate members, so decompression
// parallelizes per block — the reference gets the same effect from
// htslib's bgzf_mt thread pool (doc/source/salmon.rst:83-97 notes
// alignment mode saturates on BAM decompression). The consumer thread
// reads raw compressed blocks (cheap fread) and keeps up to DEPTH of
// them inflating on a small worker pool; next_block() delivers them
// strictly in stream order.
struct InflateJob {
  std::vector<uint8_t> cdata;
  std::vector<uint8_t> out;
  uint32_t isize{0};
  std::atomic<int> state{0};  // 0 = pending, 1 = done, 2 = error
};

struct BGZFReader {
  FILE* fp{nullptr};
  std::vector<uint8_t> block;   // current inflated block
  size_t block_pos{0};
  bool eof{false};
  bool raw_eof{false};

  static constexpr size_t DEPTH = 48;
  std::deque<std::unique_ptr<InflateJob>> inflight;
  std::deque<InflateJob*> workq;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  bool stopping{false};

  static int n_threads() {
    const char* e = std::getenv("SALMON_TPU_BAM_THREADS");
    if (e) {
      int v = std::atoi(e);
      if (v >= 1) return v;
    }
    unsigned hw = std::thread::hardware_concurrency();
    return hw >= 4 ? 4 : (hw >= 2 ? 2 : 1);
  }

  bool open(const char* path) {
    fp = std::fopen(path, "rb");
    if (!fp) return false;
    int t = n_threads();
    for (int i = 0; i < t; ++i)
      workers.emplace_back([this] { worker_loop(); });
    return true;
  }

  void worker_loop() {
    for (;;) {
      InflateJob* j = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stopping || !workq.empty(); });
        if (workq.empty()) {
          if (stopping) return;
          continue;
        }
        j = workq.front();
        workq.pop_front();
      }
      int st = 1;
      if (j->isize > 0) {
        j->out.resize(j->isize);
        z_stream zs{};
        inflateInit2(&zs, -15);  // raw deflate
        zs.next_in = j->cdata.data();
        zs.avail_in = uInt(j->cdata.size());
        zs.next_out = j->out.data();
        zs.avail_out = j->isize;
        int r = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        if (r != Z_STREAM_END) st = 2;
      }
      j->cdata.clear();
      j->cdata.shrink_to_fit();
      {
        std::lock_guard<std::mutex> lk(mu);
        j->state.store(st);
        cv_done.notify_all();
      }
    }
  }

  // Read one raw BGZF block (header + compressed payload) into a job.
  // Returns nullptr at raw EOF / malformed stream.
  std::unique_ptr<InflateJob> read_raw_block() {
    uint8_t hdr[12];
    if (std::fread(hdr, 1, 12, fp) != 12) return nullptr;
    if (hdr[0] != 0x1f || hdr[1] != 0x8b) return nullptr;
    uint16_t xlen = uint16_t(hdr[10]) | (uint16_t(hdr[11]) << 8);
    std::vector<uint8_t> extra(xlen);
    if (std::fread(extra.data(), 1, xlen, fp) != xlen) return nullptr;
    int bsize = -1;
    for (size_t i = 0; i + 4 <= extra.size();) {
      uint8_t si1 = extra[i], si2 = extra[i + 1];
      uint16_t slen = uint16_t(extra[i + 2]) | (uint16_t(extra[i + 3]) << 8);
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        bsize = (int(extra[i + 4]) | (int(extra[i + 5]) << 8)) + 1;
        break;
      }
      i += 4 + slen;
    }
    if (bsize < 0) return nullptr;
    size_t cdata_len = size_t(bsize) - 12 - xlen - 8;
    auto job = std::make_unique<InflateJob>();
    job->cdata.resize(cdata_len);
    if (std::fread(job->cdata.data(), 1, cdata_len, fp) != cdata_len)
      return nullptr;
    uint8_t tail[8];
    if (std::fread(tail, 1, 8, fp) != 8) return nullptr;
    job->isize = uint32_t(tail[4]) | (uint32_t(tail[5]) << 8) |
                 (uint32_t(tail[6]) << 16) | (uint32_t(tail[7]) << 24);
    return job;
  }

  void fill_pipeline() {
    while (!raw_eof && inflight.size() < DEPTH) {
      auto job = read_raw_block();
      if (!job) { raw_eof = true; break; }
      InflateJob* jp = job.get();
      inflight.emplace_back(std::move(job));
      {
        std::lock_guard<std::mutex> lk(mu);
        workq.push_back(jp);
      }
      cv_work.notify_one();
    }
  }

  // Deliver the next inflated block in stream order. False at EOF.
  bool next_block() {
    for (;;) {
      fill_pipeline();
      if (inflight.empty()) { eof = true; return false; }
      auto job = std::move(inflight.front());
      inflight.pop_front();
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [&] { return job->state.load() != 0; });
      }
      if (job->state.load() == 2) { eof = true; return false; }
      if (job->isize == 0) continue;  // EOF-marker block; keep going
      block = std::move(job->out);
      block_pos = 0;
      return true;
    }
  }

  // Read exactly n bytes spanning blocks. Returns false on EOF.
  bool read(void* out, size_t n) {
    uint8_t* dst = static_cast<uint8_t*>(out);
    while (n > 0) {
      if (block_pos >= block.size()) {
        if (!next_block()) return false;
        continue;
      }
      size_t take = std::min(n, block.size() - block_pos);
      std::memcpy(dst, block.data() + block_pos, take);
      block_pos += take;
      dst += take;
      n -= take;
    }
    return true;
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    workers.clear();
    if (fp) { std::fclose(fp); fp = nullptr; }
  }
};

struct BamFile {
  BGZFReader r;
  std::vector<std::string> ref_names;
  std::vector<int32_t> ref_lens;
  std::string text_header;
  bool ok{false};
  // records deferred to the next batch (FIFO, stream order). Holds a
  // whole read-name group when a group would otherwise straddle a batch
  // boundary (the reference BAMQueue keeps a read's records together).
  std::vector<std::vector<uint8_t>> pending;
  size_t pending_head{0};

  bool pop_pending(std::vector<uint8_t>& rec) {
    if (pending_head >= pending.size()) return false;
    rec.swap(pending[pending_head]);
    ++pending_head;
    if (pending_head >= pending.size()) {
      pending.clear();
      pending_head = 0;
    }
    return true;
  }

  bool open(const char* path) {
    if (!r.open(path)) return false;
    char magic[4];
    if (!r.read(magic, 4) || std::memcmp(magic, "BAM\1", 4) != 0)
      return false;
    int32_t l_text;
    if (!r.read(&l_text, 4)) return false;
    text_header.resize(size_t(l_text));
    if (l_text && !r.read(&text_header[0], size_t(l_text))) return false;
    int32_t n_ref;
    if (!r.read(&n_ref, 4)) return false;
    ref_names.reserve(n_ref);
    ref_lens.reserve(n_ref);
    for (int32_t i = 0; i < n_ref; ++i) {
      int32_t l_name, l_ref;
      if (!r.read(&l_name, 4)) return false;
      std::string nm(size_t(l_name), '\0');
      if (!r.read(&nm[0], size_t(l_name))) return false;
      nm.pop_back();  // trailing NUL
      if (!r.read(&l_ref, 4)) return false;
      ref_names.push_back(nm);
      ref_lens.push_back(l_ref);
    }
    ok = true;
    return true;
  }
};

// BAM 4-bit seq codes -> our 2-bit codes (A=0 C=1 G=2 T=3, other=4)
const uint8_t SEQ4_TO_CODE[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                                  3, 4, 4, 4, 4, 4, 4, 4};

uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= uint8_t(s[i]);
    h *= 1099511628211ull;
  }
  return h;
}

}  // namespace

extern "C" {

void* bam_open(const char* path) {
  auto* bf = new BamFile();
  if (!bf->open(path)) { delete bf; return nullptr; }
  return bf;
}

void bam_close(void* h) {
  auto* bf = static_cast<BamFile*>(h);
  bf->r.close();
  delete bf;
}

int32_t bam_n_refs(void* h) {
  return int32_t(static_cast<BamFile*>(h)->ref_names.size());
}

const char* bam_ref_name(void* h, int32_t i) {
  return static_cast<BamFile*>(h)->ref_names[size_t(i)].c_str();
}

int32_t bam_ref_len(void* h, int32_t i) {
  return static_cast<BamFile*>(h)->ref_lens[size_t(i)];
}

// NUL-terminated SAM text header (for @PG aligner detection)
const char* bam_text_header(void* h) {
  return static_cast<BamFile*>(h)->text_header.c_str();
}

// Fill caller-allocated arrays with up to `cap` records. The decoded
// read sequences go into seq_buf (capacity seq_cap bytes), CIGAR ops
// into cigar_op/cigar_len (capacity cigar_cap). Returns the number of
// records written; 0 at EOF; -1 if the very first record does not fit
// (caller should grow buffers).
int64_t bam_next_batch(void* h, int64_t cap, int64_t seq_cap,
                       int64_t cigar_cap,
                       int32_t* refid, int32_t* pos, uint16_t* flag,
                       uint8_t* mapq, int32_t* mate_refid,
                       int32_t* mate_pos, int32_t* tlen,
                       int32_t* read_len, int64_t* seq_off,
                       int64_t* cigar_off, int32_t* cigar_n,
                       int32_t* as_tag, int32_t* nm_tag,
                       float* zw_tag,
                       uint64_t* name_hash,
                       uint8_t* seq_buf, uint8_t* cigar_op,
                       uint32_t* cigar_oplen,
                       char* names_buf, int64_t names_cap) {
  auto* bf = static_cast<BamFile*>(h);
  int64_t n = 0;
  int64_t spos = 0, cpos = 0;
  int64_t name_pos = 0;
  std::vector<uint8_t> rec;
  // raw records of the current trailing read-name group, so a group that
  // would straddle the batch boundary can be rolled back into `pending`
  std::vector<std::vector<uint8_t>> group_raw;
  uint64_t group_hash = 0;
  int64_t group_n = 0, group_spos = 0, group_cpos = 0, group_name_pos = 0;
  auto read_next = [&](std::vector<uint8_t>& out) -> bool {
    if (bf->pop_pending(out)) return true;
    int32_t block_size;
    if (!bf->r.read(&block_size, 4)) return false;  // EOF
    out.resize(size_t(block_size));
    return bf->r.read(out.data(), size_t(block_size));
  };
  auto rollback_group = [&](std::vector<uint8_t>* lookahead) {
    // move the trailing group (and the lookahead record continuing it)
    // to the FRONT of pending, preserving stream order
    std::vector<std::vector<uint8_t>> np;
    np.reserve(group_raw.size() + 1 +
               (bf->pending.size() - bf->pending_head));
    for (auto& g : group_raw) np.emplace_back(std::move(g));
    if (lookahead) np.emplace_back(std::move(*lookahead));
    for (size_t i = bf->pending_head; i < bf->pending.size(); ++i)
      np.emplace_back(std::move(bf->pending[i]));
    bf->pending.swap(np);
    bf->pending_head = 0;
    n = group_n;
    spos = group_spos;
    cpos = group_cpos;
    name_pos = group_name_pos;
  };
  while (n < cap) {
    if (!read_next(rec)) break;  // EOF
    const uint8_t* p = rec.data();
    auto rd32 = [&](size_t off) {
      int32_t v; std::memcpy(&v, p + off, 4); return v;
    };
    int32_t refID = rd32(0);
    int32_t pos_ = rd32(4);
    uint8_t l_read_name = p[8];
    uint8_t mapq_ = p[9];
    uint16_t n_cigar;  std::memcpy(&n_cigar, p + 12, 2);
    uint16_t flag_;    std::memcpy(&flag_, p + 14, 2);
    int32_t l_seq = rd32(16);
    int32_t next_refID = rd32(20);
    int32_t next_pos = rd32(24);
    int32_t tlen_ = rd32(28);
    const char* rname = reinterpret_cast<const char*>(p + 32);
    size_t cig_at = 32 + l_read_name;
    size_t seq_at = cig_at + size_t(n_cigar) * 4;
    size_t qual_at = seq_at + size_t(l_seq + 1) / 2;
    size_t tags_at = qual_at + size_t(l_seq);

    size_t rn_len0 = l_read_name ? size_t(l_read_name) - 1 : 0;
    uint64_t h_ = fnv1a(rname, rn_len0);

    if (spos + l_seq > seq_cap || cpos + n_cigar > cigar_cap) {
      if (n == 0) return -1;  // first record too big for buffers
      if (n == group_n || h_ != group_hash || group_n == 0) {
        // record starts (or continues into) a fresh group: defer just it
        bf->pending.insert(bf->pending.begin() + bf->pending_head,
                           std::vector<uint8_t>(rec.begin(), rec.end()));
      } else {
        rollback_group(&rec);  // keep its name group together
      }
      break;
    }

    // track the trailing name group (counters BEFORE this record)
    if (n == 0 || h_ != group_hash) {
      group_hash = h_;
      group_raw.clear();
      group_n = n;
      group_spos = spos;
      group_cpos = cpos;
      group_name_pos = name_pos;
    }
    group_raw.emplace_back(rec.begin(), rec.end());

    refid[n] = refID;
    pos[n] = pos_;
    flag[n] = flag_;
    mapq[n] = mapq_;
    mate_refid[n] = next_refID;
    mate_pos[n] = next_pos;
    tlen[n] = tlen_;
    read_len[n] = l_seq;
    size_t rn_len = l_read_name ? size_t(l_read_name) - 1 : 0;
    name_hash[n] = fnv1a(rname, rn_len);
    if (names_buf && name_pos + int64_t(rn_len) + 1 <= names_cap) {
      std::memcpy(names_buf + name_pos, rname, rn_len);
      name_pos += rn_len;
      names_buf[name_pos++] = 0;
    }

    seq_off[n] = spos;
    for (int32_t i = 0; i < l_seq; ++i) {
      uint8_t b4 = p[seq_at + size_t(i) / 2];
      b4 = (i % 2 == 0) ? (b4 >> 4) : (b4 & 0xF);
      seq_buf[spos++] = SEQ4_TO_CODE[b4];
    }

    cigar_off[n] = cpos;
    cigar_n[n] = n_cigar;
    for (uint16_t i = 0; i < n_cigar; ++i) {
      uint32_t c; std::memcpy(&c, p + cig_at + size_t(i) * 4, 4);
      cigar_op[cpos] = uint8_t(c & 0xF);
      cigar_oplen[cpos] = c >> 4;
      ++cpos;
    }

    // tags: AS:i, NM:i and ZW:f (posterior weight in sampled BAMs)
    int32_t as_v = INT32_MIN, nm_v = INT32_MIN;
    float zw_v = std::numeric_limits<float>::quiet_NaN();
    size_t t = tags_at;
    while (t + 3 <= rec.size()) {
      char t1 = char(p[t]), t2 = char(p[t + 1]), ty = char(p[t + 2]);
      t += 3;
      int64_t val = 0;
      size_t sz = 0;
      switch (ty) {
        case 'A': case 'c': case 'C': sz = 1; break;
        case 's': case 'S': sz = 2; break;
        case 'i': case 'I': case 'f': sz = 4; break;
        case 'Z': case 'H': {
          while (t < rec.size() && p[t] != 0) ++t;
          ++t;
          continue;
        }
        case 'B': {
          if (t + 5 > rec.size()) { t = rec.size(); continue; }
          char el = char(p[t]);
          int32_t cnt; std::memcpy(&cnt, p + t + 1, 4);
          size_t esz = (el == 'c' || el == 'C') ? 1
                       : (el == 's' || el == 'S') ? 2 : 4;
          t += 5 + size_t(cnt) * esz;
          continue;
        }
        default: t = rec.size(); continue;
      }
      if (t + sz > rec.size()) break;
      if (ty == 'c') { int8_t v; std::memcpy(&v, p + t, 1); val = v; }
      else if (ty == 'C' || ty == 'A') { val = p[t]; }
      else if (ty == 's') { int16_t v; std::memcpy(&v, p + t, 2); val = v; }
      else if (ty == 'S') { uint16_t v; std::memcpy(&v, p + t, 2); val = v; }
      else if (ty == 'i') { int32_t v; std::memcpy(&v, p + t, 4); val = v; }
      else if (ty == 'I') { uint32_t v; std::memcpy(&v, p + t, 4);
                            val = int64_t(v); }
      else if (ty == 'f') {
        val = INT32_MIN;
        if (t1 == 'Z' && t2 == 'W') std::memcpy(&zw_v, p + t, 4);
      }
      t += sz;
      if (t1 == 'A' && t2 == 'S' && ty != 'f') as_v = int32_t(val);
      if (t1 == 'N' && t2 == 'M' && ty != 'f') nm_v = int32_t(val);
    }
    as_tag[n] = as_v;
    nm_tag[n] = nm_v;
    zw_tag[n] = zw_v;
    ++n;
  }
  if (n == cap && n > 0) {
    // lookahead: if the next record continues the last name group, move
    // the whole group to the next batch so groups never straddle
    std::vector<uint8_t> la;
    if (read_next(la)) {
      uint8_t l_rn = la.size() > 8 ? la[8] : 0;
      size_t rn_len = l_rn ? size_t(l_rn) - 1 : 0;
      uint64_t h_ = la.size() >= 32 + size_t(l_rn)
          ? fnv1a(reinterpret_cast<const char*>(la.data() + 32), rn_len)
          : 0;
      if (h_ == group_hash && group_n > 0) {
        rollback_group(&la);
      } else {
        bf->pending.insert(bf->pending.begin() + bf->pending_head,
                           std::vector<uint8_t>(la.begin(), la.end()));
      }
    }
  }
  return n;
}

// Ragged->padded repack for the device error model (the jitted CIGAR
// expansion in salmon_tpu/alignment/errormodel_device.py works on a
// fixed (records, columns) grid). For each selected record, copies its
// read codes into rseq (row-major n_sel x RL, zero-padded), its CIGAR
// ops/lengths into ops/oplens (n_sel x P), and flags rows that fit the
// grid (cigar ops <= P, read len <= RL, expanded columns <= col_cap);
// rows that don't fit are left for the host fallback. Pure memcpy
// loops — replaces numpy fancy-indexing that dominated the profile.
void bam_pad_batch(int64_t n_sel, const int64_t* sel,
                   const int32_t* read_len, const int64_t* seq_off,
                   const uint8_t* seq_buf,
                   const int64_t* cigar_off, const int32_t* cigar_n,
                   const uint8_t* cigar_op, const uint32_t* cigar_oplen,
                   int32_t RL, int32_t P, int32_t col_cap,
                   int32_t* ops, int32_t* oplens, int8_t* rseq,
                   uint8_t* ok) {
  for (int64_t i = 0; i < n_sel; ++i) {
    int64_t r = sel[i];
    int32_t rl = read_len[r];
    int32_t cn = cigar_n[r];
    int32_t* orow = ops + i * P;
    int32_t* lrow = oplens + i * P;
    std::memset(orow, 0, size_t(P) * 4);
    std::memset(lrow, 0, size_t(P) * 4);
    int8_t* srow = rseq + i * RL;
    std::memset(srow, 0, size_t(RL));
    bool fits = cn > 0 && cn <= P && rl <= RL;
    if (fits) {
      int64_t co = cigar_off[r];
      int64_t cols = 0;
      for (int32_t c = 0; c < cn; ++c) {
        orow[c] = cigar_op[co + c];
        lrow[c] = int32_t(cigar_oplen[co + c]);
        cols += lrow[c];
      }
      if (cols > col_cap) {
        fits = false;
      } else {
        const uint8_t* src = seq_buf + seq_off[r];
        std::memcpy(srow, src, size_t(rl));
      }
    }
    ok[i] = fits ? 1 : 0;
  }
}

}  // extern "C"
