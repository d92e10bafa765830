// mercat2_native: single-pass native IO for the device k-mer engine.
//
// The reference pipeline leans on external native tools for its data path
// (fastp C++, FragGeneScanRs Rust, Ray's C++ core). This library is the
// equivalent here: a zlib-streaming FASTA/FASTQ parser that does
// decompress -> line-frame -> strip -> '*'-removal -> record-id assignment
// in one pass over the bytes, exposed through a plain C ABI consumed via
// ctypes (mercat2_tpu/io/native.py).
//
// Parsing semantics mirror the reference counter's framing exactly
// (/root/reference/lib/mercat2_kmers.py:47-69): lines are stripped, a
// stripped line starting with '>' begins a new record, other non-empty
// lines append to the current record with '*' bytes removed, bytes before
// the first header belong to record 0.
//
// Build: make -C native   (produces libmercat2_native.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr size_t kChunk = 1 << 20;

struct ParseState {
  std::vector<uint8_t> seq;    // concatenated sequence bytes
  std::vector<int64_t> starts; // seq offset where each record begins
  int64_t rec = 0;             // current record id (0 = pre-header)
  // Line assembly: we process decompressed chunks; a line may straddle
  // chunk boundaries, so carry the partial line here.
  std::string carry;

  void begin() { starts.push_back(0); } // record 0 starts at 0

  inline void handle_line(const char* p, size_t n) {
    // strip() — ASCII whitespace from both ends (Python bytes.strip())
    while (n && (p[0] == ' ' || (p[0] >= '\t' && p[0] <= '\r'))) { ++p; --n; }
    while (n && (p[n-1] == ' ' || (p[n-1] >= '\t' && p[n-1] <= '\r'))) { --n; }
    if (!n) return;
    if (p[0] == '>') {
      ++rec;
      starts.push_back((int64_t)seq.size());
      return;
    }
    size_t base = seq.size();
    seq.resize(base + n);
    uint8_t* out = seq.data() + base;
    size_t m = 0;
    const void* star = memchr(p, '*', n);
    if (!star) {
      memcpy(out, p, n);
      m = n;
    } else {
      for (size_t i = 0; i < n; ++i)
        if (p[i] != '*') out[m++] = (uint8_t)p[i];
    }
    seq.resize(base + m);
  }

  inline void feed(const char* data, size_t n) {
    size_t pos = 0;
    while (pos < n) {
      const char* nl = (const char*)memchr(data + pos, '\n', n - pos);
      if (!nl) {
        carry.append(data + pos, n - pos);
        return;
      }
      size_t len = (size_t)(nl - (data + pos));
      if (carry.empty()) {
        handle_line(data + pos, len);
      } else {
        carry.append(data + pos, len);
        handle_line(carry.data(), carry.size());
        carry.clear();
      }
      pos += len + 1;
    }
  }

  void finish() {
    if (!carry.empty()) {
      handle_line(carry.data(), carry.size());
      carry.clear();
    }
  }
};

// Error codes
enum { M2N_OK = 0, M2N_EOPEN = 1, M2N_EREAD = 2, M2N_EGZIP = 3 };

int stream_file(const char* path, ParseState& st) {
  // gzFile reads both plain and gzip files transparently.
  gzFile f = gzopen(path, "rb");
  if (!f) return M2N_EOPEN;
  gzbuffer(f, kChunk);
  std::vector<char> buf(kChunk);
  for (;;) {
    int n = gzread(f, buf.data(), (unsigned)buf.size());
    if (n < 0) { gzclose(f); return M2N_EGZIP; }
    if (n == 0) break;
    st.feed(buf.data(), (size_t)n);
  }
  gzclose(f);
  st.finish();
  return M2N_OK;
}

struct FastqState {
  // fastq -> fasta conversion + raw parse: emit only sequence lines
  // (line index % 4 == 1 of the stripped stream, reference fq2fa:
  // /root/reference/lib/mercat2_fasta.py:192-197 keeps lines 1~4s,2~4p).
  std::vector<uint8_t> seq;
  std::vector<int64_t> starts;
  std::vector<std::string> headers;
  std::string carry;
  int64_t line_no = 0;

  inline void handle_line(const char* p, size_t n) {
    while (n && (p[0] == ' ' || (p[0] >= '\t' && p[0] <= '\r'))) { ++p; --n; }
    while (n && (p[n-1] == ' ' || (p[n-1] >= '\t' && p[n-1] <= '\r'))) { --n; }
    int64_t phase = line_no++ & 3;
    if (phase == 0) {
      headers.emplace_back(p + (n && p[0] == '@' ? 1 : 0),
                           n - (n && p[0] == '@' ? 1 : 0));
      starts.push_back((int64_t)seq.size());
    } else if (phase == 1) {
      seq.insert(seq.end(), (const uint8_t*)p, (const uint8_t*)p + n);
    }
  }

  inline void feed(const char* data, size_t n) {
    size_t pos = 0;
    while (pos < n) {
      const char* nl = (const char*)memchr(data + pos, '\n', n - pos);
      if (!nl) { carry.append(data + pos, n - pos); return; }
      size_t len = (size_t)(nl - (data + pos));
      if (carry.empty()) {
        handle_line(data + pos, len);
      } else {
        carry.append(data + pos, len);
        handle_line(carry.data(), carry.size());
        carry.clear();
      }
      pos += len + 1;
    }
  }
  void finish() {
    if (!carry.empty()) { handle_line(carry.data(), carry.size()); carry.clear(); }
  }
};

}  // namespace

extern "C" {

// Opaque result handle.
struct M2NResult {
  std::vector<uint8_t> seq;
  std::vector<int64_t> rec;  // per-byte record id (materialized on demand)
  std::vector<int64_t> starts;
};

// Parse a FASTA file (plain or .gz). On success returns M2N_OK and sets
// *out to a handle; query with the accessors below and free with
// m2n_free(). Thread-safe (no globals).
int m2n_parse_fasta(const char* path, M2NResult** out) {
  ParseState st;
  st.begin();
  int rc = stream_file(path, st);
  if (rc != M2N_OK) return rc;
  auto* r = new M2NResult();
  r->seq = std::move(st.seq);
  r->starts = std::move(st.starts);
  return (*out = r), M2N_OK;
}

int64_t m2n_seq_len(M2NResult* r) { return (int64_t)r->seq.size(); }
int64_t m2n_num_records(M2NResult* r) { return (int64_t)r->starts.size(); }
const uint8_t* m2n_seq_ptr(M2NResult* r) { return r->seq.data(); }
const int64_t* m2n_starts_ptr(M2NResult* r) { return r->starts.data(); }

// Materialize the per-byte record-id array (int64[seq_len]) the engine's
// stream builder consumes. Record ids are 0 for pre-header bytes then 1..R
// matching parse_fasta_seq_bytes (mercat2_tpu/io/fasta.py).
const int64_t* m2n_rec_ptr(M2NResult* r) {
  if (r->rec.size() != r->seq.size()) {
    r->rec.assign(r->seq.size(), 0);
    // starts[i] = seq offset where record i begins; record index = i
    for (size_t i = 0; i + 1 < r->starts.size(); ++i) {
      int64_t lo = r->starts[i], hi = r->starts[i + 1];
      for (int64_t j = lo; j < hi; ++j) r->rec[j] = (int64_t)i;
    }
    if (!r->starts.empty()) {
      int64_t lo = r->starts.back();
      for (size_t j = (size_t)lo; j < r->rec.size(); ++j)
        r->rec[j] = (int64_t)(r->starts.size() - 1);
    }
  }
  return r->rec.data();
}

void m2n_free(M2NResult* r) { delete r; }

// Length of the separator-delimited code stream for window size k:
// every record-id increment inserts (k-1) separator positions between the
// bytes of adjacent records (matching KmerCounter.build_stream,
// mercat2_tpu/engine/counter.py). Empty records still advance the id.
int64_t m2n_stream_len(M2NResult* r, int32_t k) {
  if (r->seq.empty()) return 0;
  // first/last non-empty record ids
  size_t nrec = r->starts.size();
  int64_t first = -1, last = -1;
  for (size_t i = 0; i < nrec; ++i) {
    int64_t lo = r->starts[i];
    int64_t hi = (i + 1 < nrec) ? r->starts[i + 1] : (int64_t)r->seq.size();
    if (hi > lo) { if (first < 0) first = (int64_t)i; last = (int64_t)i; }
  }
  if (first < 0) return 0;
  return (int64_t)r->seq.size() + (last - first) * (int64_t)(k - 1);
}

// Encode the parsed sequence through lut256 into `out` (caller-allocated,
// pre-filled with the sentinel, at least m2n_stream_len bytes), inserting
// (k-1)-position gaps at record boundaries. Returns bytes of `out` spanned.
int64_t m2n_fill_stream(M2NResult* r, int32_t k, const uint8_t* lut256,
                        uint8_t* out) {
  size_t nrec = r->starts.size();
  int64_t gap = k - 1;
  int64_t pos = 0;
  int64_t prev_rec = -1;
  for (size_t i = 0; i < nrec; ++i) {
    int64_t lo = r->starts[i];
    int64_t hi = (i + 1 < nrec) ? r->starts[i + 1] : (int64_t)r->seq.size();
    if (hi <= lo) continue;
    if (prev_rec >= 0) pos += gap * ((int64_t)i - prev_rec);
    prev_rec = (int64_t)i;
    const uint8_t* src = r->seq.data() + lo;
    for (int64_t j = 0; j < hi - lo; ++j) out[pos + j] = lut256[src[j]];
    pos += hi - lo;
  }
  return pos;
}

// ---- bit-packed transport -------------------------------------------------
//
// To cut host-to-device bytes the engine ships `bits`-per-symbol big-endian
// packed words instead of uint8 codes. Record separation is out of band: consecutive non-empty
// records are separated by `gap * (record-id delta)` zero symbols whose
// positions the device learns through gap ranges (m2n_gap_ranges); symbol 0
// of each word occupies its most-significant `bits` bits so numeric word
// order == lexicographic symbol order (mercat2_tpu/ops/finalize.py
// unpack_codes is the inverse).

// Packed gapped stream length in symbols for a given inter-record gap.
int64_t m2n_packed_len(M2NResult* r, int32_t gap) {
  if (r->seq.empty()) return 0;
  size_t nrec = r->starts.size();
  int64_t first = -1, last = -1;
  for (size_t i = 0; i < nrec; ++i) {
    int64_t lo = r->starts[i];
    int64_t hi = (i + 1 < nrec) ? r->starts[i + 1] : (int64_t)r->seq.size();
    if (hi > lo) { if (first < 0) first = (int64_t)i; last = (int64_t)i; }
  }
  if (first < 0) return 0;
  return (int64_t)r->seq.size() + (last - first) * (int64_t)gap;
}

// Interior gap ranges [begin, end) in gapped-symbol coordinates (relative
// to this file's own origin). `begins`/`ends` must hold at least
// m2n_num_records entries. Returns the number of ranges written.
int64_t m2n_gap_ranges(M2NResult* r, int32_t gap,
                       int64_t* begins, int64_t* ends) {
  size_t nrec = r->starts.size();
  int64_t pos = 0, prev_rec = -1, count = 0;
  for (size_t i = 0; i < nrec; ++i) {
    int64_t lo = r->starts[i];
    int64_t hi = (i + 1 < nrec) ? r->starts[i + 1] : (int64_t)r->seq.size();
    if (hi <= lo) continue;
    if (prev_rec >= 0) {
      int64_t g = (int64_t)gap * ((int64_t)i - prev_rec);
      begins[count] = pos;
      ends[count] = pos + g;
      ++count;
      pos += g;
    }
    prev_rec = (int64_t)i;
    pos += hi - lo;
  }
  return count;
}

// Encode the parsed sequence through lut256 and write it `bits` per symbol
// (bits in {1,2,4,8}; big-endian within each uint32) into `words`, starting
// at absolute symbol offset `sym_off` (the caller aligns it to a word
// boundary, i.e. a multiple of 32/bits). Gap symbols are skipped — `words`
// must be zero-initialized. Returns symbols spanned (== m2n_packed_len).
int64_t m2n_fill_packed(M2NResult* r, int32_t bits, int32_t gap,
                        const uint8_t* lut256, uint32_t* words,
                        int64_t sym_off) {
  const int per = 32 / bits;
  size_t nrec = r->starts.size();
  int64_t pos = sym_off, prev_rec = -1;
  for (size_t i = 0; i < nrec; ++i) {
    int64_t lo = r->starts[i];
    int64_t hi = (i + 1 < nrec) ? r->starts[i + 1] : (int64_t)r->seq.size();
    if (hi <= lo) continue;
    if (prev_rec >= 0) pos += (int64_t)gap * ((int64_t)i - prev_rec);
    prev_rec = (int64_t)i;
    const uint8_t* src = r->seq.data() + lo;
    int64_t n = hi - lo, j = 0;
    // word-accumulator loop: build each uint32 locally, one store per word
    while (j < n) {
      int64_t w = (pos + j) / per;
      int slot = (int)((pos + j) % per);
      uint32_t acc = words[w];
      for (; slot < per && j < n; ++slot, ++j)
        acc |= (uint32_t)lut256[src[j]] << (32 - bits * (slot + 1));
      words[w] = acc;
    }
    pos += n;
  }
  return pos - sym_off;
}

// 256-bin byte histogram of the parsed sequence (for codec construction
// without copying the seq buffer out).
void m2n_byte_hist(M2NResult* r, int64_t* hist256) {
  memset(hist256, 0, 256 * sizeof(int64_t));
  for (uint8_t b : r->seq) ++hist256[b];
}

// Encode seq bytes through a 256-entry LUT in place (byte -> code).
void m2n_encode_lut(uint8_t* data, int64_t n, const uint8_t* lut256) {
  for (int64_t i = 0; i < n; ++i) data[i] = lut256[data[i]];
}

// ---- fastq ----------------------------------------------------------------

struct M2NFastq {
  std::vector<uint8_t> seq;
  std::vector<int64_t> starts;
  std::string headers_blob;  // '\n'-joined headers
};

int m2n_parse_fastq(const char* path, M2NFastq** out) {
  FastqState st;
  gzFile f = gzopen(path, "rb");
  if (!f) return M2N_EOPEN;
  gzbuffer(f, kChunk);
  std::vector<char> buf(kChunk);
  for (;;) {
    int n = gzread(f, buf.data(), (unsigned)buf.size());
    if (n < 0) { gzclose(f); return M2N_EGZIP; }
    if (n == 0) break;
    st.feed(buf.data(), (size_t)n);
  }
  gzclose(f);
  st.finish();
  auto* r = new M2NFastq();
  r->seq = std::move(st.seq);
  r->starts = std::move(st.starts);
  std::string blob;
  for (size_t i = 0; i < st.headers.size(); ++i) {
    if (i) blob.push_back('\n');
    blob += st.headers[i];
  }
  r->headers_blob = std::move(blob);
  return (*out = r), M2N_OK;
}

int64_t m2n_fq_seq_len(M2NFastq* r) { return (int64_t)r->seq.size(); }
int64_t m2n_fq_num_reads(M2NFastq* r) { return (int64_t)r->starts.size(); }
const uint8_t* m2n_fq_seq_ptr(M2NFastq* r) { return r->seq.data(); }
const int64_t* m2n_fq_starts_ptr(M2NFastq* r) { return r->starts.data(); }
int64_t m2n_fq_headers_len(M2NFastq* r) { return (int64_t)r->headers_blob.size(); }
const char* m2n_fq_headers_ptr(M2NFastq* r) { return r->headers_blob.data(); }
void m2n_fq_free(M2NFastq* r) { delete r; }

}  // extern "C"
