// Copied from native/fastqreader.cpp of the JAX package (salmon_tpu), unchanged
// below this comment: the port builds it into its own host library
// (salmon_tpu_torch/_native.py) and loads nothing under native/.

// Native FASTQ/FASTA chunk reader for salmon_tpu.
//
// Role of the reference's FQFeeder FastxParser producer threads
// (cmake/SalmonDependencies.cmake:20-25; consumed at
// src/quant/SalmonQuantify.cpp:2418-2443): stream reads from (possibly
// gzipped) FASTQ/FASTA straight into padded (R, L) 2-bit-code batches
// ready for host->device transfer. gzip handled by zlib's gzFile (which
// also reads plain files transparently).
//
// C ABI (consumed via ctypes from salmon_tpu/io/fastq.py):
//   fastq_open(path) -> handle            fastq_close(handle)
//   fastq_next_batch(handle, max_reads, max_len, codes, lens,
//                    names_buf, names_cap) -> n  (0 at EOF; -1 error)
//     codes: caller-allocated uint8[max_reads * max_len], prefilled by
//            this function with 4 (invalid) before writing codes
//     lens:  int32[max_reads] true (unclamped) read lengths
//     names_buf: optional char buffer receiving NUL-separated read names
//                (pass NULL to skip)

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

constexpr size_t LINE_BUF = 1 << 20;

struct FastqFile {
  gzFile gz{nullptr};
  std::string pending_line;
  bool have_pending{false};
  bool is_fasta{false};
  bool checked_format{false};
  std::vector<char> buf;

  bool getline_(std::string& out) {
    if (have_pending) {
      out.swap(pending_line);
      have_pending = false;
      return true;
    }
    out.clear();
    while (true) {
      if (buf.empty()) buf.resize(LINE_BUF);
      char* r = gzgets(gz, buf.data(), int(buf.size()));
      if (r == nullptr) return !out.empty();
      size_t n = std::strlen(r);
      bool done = n > 0 && r[n - 1] == '\n';
      if (done) --n;
      if (n > 0 && r[n - 1] == '\r') --n;
      out.append(r, n);
      if (done) return true;
    }
  }

  void push_back_line(std::string&& l) {
    pending_line = std::move(l);
    have_pending = true;
  }
};

const uint8_t CODE[256] = {
    // defaults 4; A/a=0 C/c=1 G/g=2 T/t=3
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,4,4,4,4,4,4,4,4,4,4,4,
    4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
};

}  // namespace

extern "C" {

void* fastq_open(const char* path) {
  auto* f = new FastqFile();
  f->gz = gzopen(path, "rb");
  if (!f->gz) { delete f; return nullptr; }
  gzbuffer(f->gz, 1 << 20);
  return f;
}

void fastq_close(void* h) {
  auto* f = static_cast<FastqFile*>(h);
  if (f->gz) gzclose(f->gz);
  delete f;
}

int64_t fastq_next_batch(void* h, int64_t max_reads, int64_t max_len,
                         uint8_t* codes, int32_t* lens,
                         char* names_buf, int64_t names_cap) {
  auto* f = static_cast<FastqFile*>(h);
  std::memset(codes, 4, size_t(max_reads) * size_t(max_len));
  int64_t n = 0;
  int64_t name_pos = 0;
  std::string line, seq;
  while (n < max_reads) {
    if (!f->getline_(line)) break;
    if (line.empty()) continue;
    if (!f->checked_format) {
      f->is_fasta = line[0] == '>';
      f->checked_format = true;
    }
    if (f->is_fasta) {
      if (line[0] != '>') return -1;  // malformed
      seq.clear();
      std::string next;
      std::string name = line.substr(1, line.find_first_of(" \t") - 1);
      while (f->getline_(next)) {
        if (!next.empty() && next[0] == '>') {
          f->push_back_line(std::move(next));
          break;
        }
        seq += next;
      }
      if (names_buf) {
        size_t need = name.size() + 1;
        if (name_pos + int64_t(need) <= names_cap) {
          std::memcpy(names_buf + name_pos, name.c_str(), need);
          name_pos += need;
        }
      }
    } else {
      if (line[0] != '@') return -1;
      std::string name = line.substr(1, line.find_first_of(" \t") - 1);
      if (!f->getline_(seq)) return -1;
      std::string plus, qual;
      if (!f->getline_(plus)) return -1;
      if (!f->getline_(qual)) return -1;
      if (names_buf) {
        size_t need = name.size() + 1;
        if (name_pos + int64_t(need) <= names_cap) {
          std::memcpy(names_buf + name_pos, name.c_str(), need);
          name_pos += need;
        }
      }
    }
    int32_t L = int32_t(seq.size());
    lens[n] = L;
    uint8_t* row = codes + size_t(n) * size_t(max_len);
    int32_t take = L < int32_t(max_len) ? L : int32_t(max_len);
    for (int32_t i = 0; i < take; ++i) {
      row[i] = CODE[uint8_t(seq[i])];
    }
    ++n;
  }
  return n;
}

}  // extern "C"
