/* Host library of cfrk_tpu_torch: FASTA/FASTQ parse + 2-bit encode,
 * padded-batch packing, the .cfrk / tsv text formatters and the dense
 * (key, count) fold.
 *
 * The loops of cfrk_tpu/io/native/fastaio.cpp (a CPython extension)
 * behind a plain C interface: no <Python.h>, built by the host C++
 * compiler at first use (ops/cuda/build.py) and loaded with ctypes
 * (io/native/__init__.py), which releases the interpreter lock for the
 * length of every call.
 *
 * Ownership.  Where an output's size is bounded in advance the caller
 * owns it and passes a pointer: the parse outputs (codes <= input
 * bytes, records <= lines, cfrk_count_lines), the packed batch and the
 * fold table.  A formatter's text size is known only once formatted:
 * it returns a CfrkText (row segments, one per worker thread) and its
 * byte size; the caller copies it out with cfrk_text_take, which frees
 * it, or drops it with cfrk_text_free.  A call that fails returns no
 * text.
 *
 * Errors.  Every entry point returns 0 or an error code; cfrk_strerror
 * gives its text, which for the input errors is the JAX package's
 * ValueError text.  No C++ exception crosses the interface: each entry
 * point catches them, and worker threads hand theirs to the caller.
 *
 * Byte-for-byte agreement with the numpy writers of format.py, the
 * record loops of io/fasta.py and cfrk_tpu.io.native is pinned by
 * tests/test_torch_native.py.
 */

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>

namespace {

enum Err {
  kOk = 0,
  kErrFastqHeader,
  kErrFastqPlus,
  kErrFastqQual,
  kErrPackRows,
  kErrPackLong,
  kErrPackSum,
  kErrFoldDtype,
  kErrK,
  kErrNoMem,
  kErrInternal,
  kErrCount,
};

/* Texts of the input errors are cfrk_tpu's (fastaio.cpp, iter_fastq). */
const char* const kErrText[kErrCount] = {
    "ok",
    "malformed FASTQ header",
    "malformed FASTQ record: missing '+' line",
    "malformed FASTQ record: quality length mismatch",
    "more records than batch rows",
    "record longer than row_len",
    "lengths do not sum to the flat buffer size",
    "unsupported fold dtype combination",
    "k out of range",
    "out of memory in the host library",
    "internal error in the host library",
};

/* Run fn(t) for t in [0, T) on T threads (inline for T == 1).  The first
 * exception of any worker is rethrown here after every thread has
 * joined, so none escapes a thread (which would terminate the process)
 * and none is lost. */
template <typename Fn>
void run_parallel(unsigned T, Fn fn) {
  if (T <= 1) {
    fn(0u);
    return;
  }
  std::exception_ptr err;
  std::mutex mu;
  auto body = [&](unsigned t) {
    try {
      fn(t);
    } catch (...) {
      std::lock_guard<std::mutex> g(mu);
      if (!err) err = std::current_exception();
    }
  };
  std::vector<std::thread> workers;
  workers.reserve(T);
  try {
    for (unsigned t = 0; t < T; t++) workers.emplace_back(body, t);
  } catch (...) {
    for (auto& w : workers) w.join();
    throw;
  }
  for (auto& w : workers) w.join();
  if (err) std::rethrow_exception(err);
}

/* The entry points' error boundary. */
template <typename Fn>
int guarded(Fn fn) {
  try {
    return fn();
  } catch (const std::bad_alloc&) {
    return kErrNoMem;
  } catch (...) {
    return kErrInternal;
  }
}

/* Find the end of the line starting at i (position of '\n' or n).
 * memchr is SIMD-accelerated in glibc: line scanning at > 10 GB/s
 * against ~0.4 GB/s for a per-byte loop. */
inline int64_t find_eol(const unsigned char* p, int64_t i, int64_t n) {
  const void* hit = memchr(p + i, '\n', (size_t)(n - i));
  return hit ? (const unsigned char*)hit - p : n;
}

/* byte -> 2-bit code, -1 for anything not ACGTacgt (io/fasta.ENCODE_LUT,
 * reference src/fastaIO.h:123-139). */
struct EncodeLut {
  int8_t t[256];
  EncodeLut() {
    std::memset(t, -1, sizeof(t));
    t[(unsigned char)'A'] = t[(unsigned char)'a'] = 0;
    t[(unsigned char)'C'] = t[(unsigned char)'c'] = 1;
    t[(unsigned char)'G'] = t[(unsigned char)'g'] = 2;
    t[(unsigned char)'T'] = t[(unsigned char)'t'] = 3;
  }
};
const EncodeLut kLut;

inline int8_t* encode_line(const unsigned char* p, int64_t i, int64_t end,
                           int8_t* dst) {
  for (int64_t j = i; j < end; j++) *dst++ = kLut.t[p[j]];
  return dst;
}

/* parse_encode: the whole-buffer parse.  codes = every record's codes
 * concatenated (no separators), lengths = per-record lengths.  The
 * format is sniffed from the first non-blank byte: '>' FASTA, '@' FASTQ
 * (4-line records, quality used only by the mask).  Headers are
 * dropped; multi-line FASTA records are joined without their newlines;
 * blank lines are skipped; \r\n line ends are handled.  A FASTQ base
 * whose Phred+33 quality byte is < qthr encodes as -1 (an 'N'); FASTA
 * has no qualities, so qthr is a no-op there (io.fasta._mask_low_qual).
 */
int parse_encode(const unsigned char* p, int64_t n, unsigned char qthr,
                 int8_t* codes, int64_t* lengths, int64_t* n_codes,
                 int64_t* n_records) {
  int8_t* out = codes;
  int64_t nrec = 0;
  bool in_record = false;
  int64_t cur_len = 0;
  int err = kOk;

  int64_t sniff = 0;
  while (sniff < n && (p[sniff] == '\n' || p[sniff] == '\r')) sniff++;
  const bool fastq = sniff < n && p[sniff] == '@';

  int64_t i = sniff;
  int fq_line = 0; /* 0=header 1=seq 2=plus 3=qual */
  int64_t seq_len = 0;
  while (i < n) {
    /* line = [i, eol) */
    int64_t eol = find_eol(p, i, n);
    int64_t end = eol;
    if (end > i && p[end - 1] == '\r') end--;
    if (fastq) {
      /* Empty lines ADVANCE the 4-line cycle (a quality-trimmed read
       * can be zero-length) -- except before a header, matching the
       * Python parser which skips blanks only at header position. */
      if (end == i && fq_line == 0) {
        i = eol + 1;
        continue;
      }
      if (fq_line == 0 && p[i] != '@') {
        err = kErrFastqHeader;
        break;
      }
      if (fq_line == 1) {
        out = encode_line(p, i, end, out);
        seq_len = end - i;
        lengths[nrec++] = seq_len;
      }
      if (fq_line == 2 && (end == i || p[i] != '+')) {
        err = kErrFastqPlus;
        break;
      }
      if (fq_line == 3) {
        if (end - i != seq_len) {
          err = kErrFastqQual;
          break;
        }
        if (qthr) {
          /* the record's codes are the last seq_len written (nothing is
           * written between the seq and qual lines) */
          int8_t* rec = out - seq_len;
          for (int64_t j = 0; j < seq_len; j++)
            if (p[i + j] < qthr) rec[j] = -1;
        }
      }
      fq_line = (fq_line + 1) & 3;
    } else if (end > i) {
      if (p[i] == '>') {
        if (in_record) lengths[nrec++] = cur_len;
        in_record = true;
        cur_len = 0;
      } else if (in_record) {
        out = encode_line(p, i, end, out);
        cur_len += end - i;
      }
    }
    i = eol + 1;
  }
  if (!err && fastq && fq_line != 0) {
    /* EOF mid-record.  Mirror iter_fastq reading empty lines at EOF:
     * missing plus line -> kErrFastqPlus; missing qual -> mismatch
     * unless the sequence was itself empty. */
    if (fq_line < 3)
      err = kErrFastqPlus;
    else if (seq_len != 0)
      err = kErrFastqQual;
  }
  if (!fastq && in_record) lengths[nrec++] = cur_len;
  *n_codes = out - codes;
  *n_records = nrec;
  return err;
}

/* One FASTA segment [lo, hi) of the chunked parse, with the sequential
 * rules.  Non-tail segments end exactly at the start of a '>' line, so
 * they parse with final=true (their last record provably ends at hi,
 * and its end offset IS hi, the start of the next header, matching the
 * sequential emit rule).  Only the tail segment may hold an incomplete
 * trailing record.  Codes go to codes[lo...] (a segment's codes are at
 * most its bytes); the caller packs the segments' codes afterwards. */
struct SegOut {
  int64_t n_codes = 0;
  std::vector<int64_t> lengths;
  std::vector<int64_t> offsets;
  int64_t consumed = 0;
};

void parse_fasta_segment(const unsigned char* p, int64_t lo, int64_t hi,
                         bool final_chunk, int8_t* codes, SegOut* out) {
  int8_t* const base = codes + lo;
  int8_t* dst = base;
  int64_t i = lo;
  bool in_record = false;
  int64_t rec_start = lo;
  int8_t* rec_code_start = base;
  bool incomplete = false;
  while (i < hi) {
    int64_t eol = find_eol(p, i, hi);
    if (eol >= hi && !final_chunk) {
      incomplete = true; /* unterminated line: re-parse next chunk */
      break;
    }
    int64_t end = eol;
    if (end > i && p[end - 1] == '\r') end--;
    if (end > i) {
      if (p[i] == '>') {
        if (in_record) {
          out->lengths.push_back(dst - rec_code_start);
          out->offsets.push_back(i); /* start of the next header line */
          out->consumed = i;
        }
        in_record = true;
        rec_start = i;
        rec_code_start = dst;
      } else if (in_record) {
        dst = encode_line(p, i, end, dst);
      }
    }
    i = eol < hi ? eol + 1 : hi;
  }
  if (final_chunk) {
    if (in_record) {
      out->lengths.push_back(dst - rec_code_start);
      out->offsets.push_back(hi);
    }
    out->consumed = hi;
  } else if (in_record || incomplete) {
    /* The trailing record may continue in the next chunk: drop its
     * partial codes and hand its bytes back through `consumed`. */
    dst = rec_code_start;
    out->consumed = in_record ? rec_start : i;
  } else {
    out->consumed = i;
  }
  out->n_codes = dst - base;
}

/* parse_encode_stream: the chunked parse of streaming ingest.  Parses
 * only the records COMPLETE within the buffer; `consumed` is where the
 * next chunk must resume (the caller carries data[consumed:] into the
 * next block).  offsets[i] is the position just past record i in this
 * buffer (the caller rebases by the buffer's file offset): the
 * checkpoint/resume seek points of io.fasta.iter_encoded_with_offsets.
 * A FASTA record is complete at the next '>' line or at `final` EOF; a
 * FASTQ record when its 4 lines are.  `is_fastq` comes from the
 * caller's sniff of the file head (a mid-file chunk cannot sniff). */
int parse_encode_stream(const unsigned char* p, int64_t n, bool is_fastq,
                        bool final_chunk, unsigned char qthr, int8_t* codes,
                        int64_t* lengths, int64_t* offsets, int64_t* n_codes,
                        int64_t* n_records, int64_t* consumed_out) {
  int err = kOk;
  int64_t consumed = 0;
  int64_t nrec = 0;
  int8_t* out = codes;
  if (is_fastq) {
    int64_t i = 0;
    while (i < n && !err) {
      /* skip blank lines at header position */
      while (i < n && (p[i] == '\n' || p[i] == '\r')) {
        /* only skip blank LINES: \r must be line-final */
        int64_t j = i;
        while (j < n && p[j] == '\r') j++;
        if (j < n && p[j] == '\n') {
          i = j + 1;
        } else if (j >= n && final_chunk) {
          /* trailing bare CR(s) at EOF: an rstripped-empty line the
           * Python parser skips, not a malformed header */
          i = n;
        } else {
          break; /* '\r' not followed by '\n': part of a (weird) line */
        }
      }
      if (i >= n) break;
      /* 4 lines: header, seq, plus, qual -- all must be complete */
      int64_t ls[4], le[4];
      int64_t pos = i;
      bool ok = true;
      for (int l = 0; l < 4; l++) {
        int64_t eol = find_eol(p, pos, n);
        if (eol >= n && !final_chunk) {
          ok = false;
          break;
        }
        int64_t end = eol;
        if (end > pos && p[end - 1] == '\r') end--;
        ls[l] = pos;
        le[l] = end;
        pos = eol < n ? eol + 1 : n;
        if (eol >= n && l < 3) {
          /* EOF (final) mid-record: mirror iter_fastq's empty reads */
          for (int m = l + 1; m < 4; m++) {
            ls[m] = n;
            le[m] = n;
          }
          break;
        }
      }
      if (!ok) break; /* incomplete record: consumed stays at its start */
      if (le[0] == ls[0] || p[ls[0]] != '@') {
        err = kErrFastqHeader;
        break;
      }
      const int64_t seq_len = le[1] - ls[1];
      if (le[2] == ls[2] || p[ls[2]] != '+') {
        err = kErrFastqPlus;
        break;
      }
      if (le[3] - ls[3] != seq_len) {
        err = kErrFastqQual;
        break;
      }
      if (qthr) {
        /* quality masking: qual byte < threshold -> -1 (an 'N') */
        const unsigned char* q = p + ls[3];
        for (int64_t j = 0; j < seq_len; j++)
          out[j] = q[j] < qthr ? (int8_t)-1 : kLut.t[p[ls[1] + j]];
        out += seq_len;
      } else {
        out = encode_line(p, ls[1], le[1], out);
      }
      lengths[nrec] = seq_len;
      offsets[nrec++] = pos;
      consumed = pos;
      i = pos;
    }
  } else {
    /* FASTA parses segment-parallel: split at '>' line starts (every
     * "\n>" is a record boundary) and parse each segment with the same
     * sequential rules; only the tail segment can hold an incomplete
     * record. */
    unsigned T = 1;
    const int64_t kParMin = 8 << 20;
    if (n >= kParMin) {
      unsigned hc = std::thread::hardware_concurrency();
      T = hc ? (hc < 4 ? hc : 4) : 1;
    }
    std::vector<int64_t> bounds;
    bounds.push_back(0);
    for (unsigned t = 1; t < T; t++) {
      int64_t target = n * (int64_t)t / (int64_t)T;
      if (target <= bounds.back()) target = bounds.back();
      const void* hit =
          target < n ? memmem(p + target, (size_t)(n - target), "\n>", 2)
                     : nullptr;
      bounds.push_back(hit ? ((const unsigned char*)hit - p) + 1 : n);
    }
    bounds.push_back(n);
    std::vector<std::pair<int64_t, int64_t>> segs;
    for (size_t t = 0; t + 1 < bounds.size(); t++)
      if (bounds[t] < bounds[t + 1]) segs.push_back({bounds[t], bounds[t + 1]});
    if (segs.empty()) segs.push_back({0, n});

    std::vector<SegOut> outs(segs.size());
    run_parallel((unsigned)segs.size(), [&](unsigned t) {
      const bool tail = t + 1 == segs.size();
      parse_fasta_segment(p, segs[t].first, segs[t].second,
                          tail ? final_chunk : true, codes, &outs[t]);
    });
    /* Pack: segment t's codes sit at codes[lo_t...], never left of
     * where they belong, and memmove leaves later segments intact. */
    for (size_t t = 0; t < outs.size(); t++) {
      std::memmove(out, codes + segs[t].first, (size_t)outs[t].n_codes);
      out += outs[t].n_codes;
      for (size_t r = 0; r < outs[t].lengths.size(); r++) {
        lengths[nrec] = outs[t].lengths[r];
        offsets[nrec++] = outs[t].offsets[r];
      }
    }
    consumed = outs.back().consumed;
  }
  *n_codes = out - codes;
  *n_records = nrec;
  *consumed_out = consumed;
  return err;
}

/* Two-digit lookup: "00010203...9899".  Emitting digit PAIRS halves the
 * divide chain of the digit-at-a-time itoa; the divides by 100 compile
 * to multiply-shift. */
const char kDigits2[201] =
    "00010203040506070809101112131415161718192021222324"
    "25262728293031323334353637383940414243444546474849"
    "50515253545556575859606162636465666768697071727374"
    "75767778798081828384858687888990919293949596979899";

/* Emit a non-negative integer as ascii into out; returns the new end. */
inline char* emit_u64(char* out, uint64_t v) {
  if (v < 10) { /* the overwhelmingly common count=1..9 cell */
    *out++ = (char)('0' + (unsigned)v);
    return out;
  }
  if (v < 100) {
    std::memcpy(out, kDigits2 + 2 * (unsigned)v, 2);
    return out + 2;
  }
  char tmp[20];
  char* p = tmp + sizeof(tmp);
  while (v >= 100) {
    const unsigned r = (unsigned)(v % 100);
    v /= 100;
    p -= 2;
    std::memcpy(p, kDigits2 + 2 * r, 2);
  }
  if (v >= 10) {
    p -= 2;
    std::memcpy(p, kDigits2 + 2 * (unsigned)v, 2);
  } else {
    *--p = (char)('0' + (unsigned)v);
  }
  const size_t len = (size_t)(tmp + sizeof(tmp) - p);
  std::memcpy(out, p, len);
  return out + len;
}

/* A count as the formatters print it: int32 cells as their uint32 bit
 * pattern (cfrk_tpu's rule), int64 cells as uint64. */
inline uint64_t as_u64(int32_t v) { return (uint64_t)(uint32_t)v; }
inline uint64_t as_u64(int64_t v) { return (uint64_t)v; }

using Segments = std::vector<std::vector<char>>;

/* Run fn(r0, r1, seg) over [0, n_rows) split into row-contiguous
 * segments, one worker thread and private output buffer each; the
 * caller concatenates the segments in order.  Byte-exactness is
 * structural: the split is at row boundaries and each row's
 * leading-'\n' rule depends only on its GLOBAL index (r > 0 || !first),
 * which fn applies.  Serial below ~4 MB of estimated output, where
 * thread spawn would dominate.  CFRK_FORMAT_THREADS caps the worker
 * count (0/unset = auto), for single-core emitter numbers. */
template <typename Fn>
Segments format_row_segments(int64_t n_rows, size_t est_total, Fn fn) {
  unsigned hc = std::thread::hardware_concurrency();
  unsigned T = hc ? (hc < 8 ? hc : 8) : 1;
  if (const char* env = getenv("CFRK_FORMAT_THREADS")) {
    const long cap = atol(env);
    if (cap > 0 && (unsigned)cap < T) T = (unsigned)cap;
  }
  if ((int64_t)T > n_rows) T = (unsigned)(n_rows > 0 ? n_rows : 1);
  if (est_total < (4u << 20)) T = 1;
  Segments segs(T);
  for (auto& s : segs) s.reserve(est_total / T + 64);
  run_parallel(T, [&](unsigned t) {
    const int64_t r0 = n_rows * (int64_t)t / (int64_t)T;
    const int64_t r1 = n_rows * (int64_t)(t + 1) / (int64_t)T;
    fn(r0, r1, segs[t]);
  });
  return segs;
}

/* Rows "idx:count " for ALL idx in [0, n_cols), the exact .cfrk contract
 * (reference src/main.cu:26-62 + goldens): joined by "\n", no trailing
 * newline; first=false prefixes a "\n" (continuation of a file). */
template <typename C>
Segments format_rows(const C* c, int64_t n_rows, int64_t n_cols, bool first) {
  /* A nonzero cell replaces the template's "0" with up to 10 (uint32)
   * or 20 (uint64) digits. */
  constexpr size_t kExtra = sizeof(C) == 8 ? 19 : 9;
  if ((size_t)n_cols <= ((size_t)1 << 22)) {
    /* Template path: rows are overwhelmingly "j:0 " cells, so emit each
     * row as memcpy spans of a precomputed all-zero template broken
     * only at nonzero cells (as in format_dense_pairs).  tmpl is at
     * most ~34 MB at the 4M-column bound; 512 KB at k=8. */
    std::vector<char> tmpl;
    std::vector<size_t> cell_off(n_cols + 1, 0);
    {
      char buf[24];
      for (int64_t j = 0; j < n_cols; j++) {
        char* e = emit_u64(buf, (uint64_t)j);
        *e++ = ':';
        *e++ = '0';
        *e++ = ' ';
        tmpl.insert(tmpl.end(), buf, e);
        cell_off[j + 1] = tmpl.size();
      }
    }
    return format_row_segments(
        n_rows, (size_t)n_rows * (tmpl.size() + 64) + 64,
        [&](int64_t r0, int64_t r1, std::vector<char>& out) {
          const char* t = tmpl.data();
          /* Upper bound of a row; sized per CHUNK of rows (not the whole
           * segment) to keep the transient allocation bounded. */
          const size_t row_cap = tmpl.size() + (size_t)n_cols * kExtra + 1;
          const int64_t chunk = (int64_t)((((size_t)64 << 20) / row_cap) + 1);
          for (int64_t c0 = r0; c0 < r1; c0 += chunk) {
            const int64_t c1 = c0 + chunk < r1 ? c0 + chunk : r1;
            const size_t base = out.size();
            out.resize(base + (size_t)(c1 - c0) * row_cap);
            char* dst = out.data() + base;
            for (int64_t r = c0; r < c1; r++) {
              if (r > 0 || !first) *dst++ = '\n';
              const C* row = c + r * n_cols;
              size_t pos = 0;
              for (int64_t j = 0; j < n_cols; j++) {
                if (row[j] == 0) continue;
                const size_t cs = cell_off[j];
                std::memcpy(dst, t + pos, cs - pos);
                dst += cs - pos;
                const size_t plen = cell_off[j + 1] - 2 - cs;
                std::memcpy(dst, t + cs, plen);
                dst += plen;
                dst = emit_u64(dst, as_u64(row[j]));
                *dst++ = ' ';
                pos = cell_off[j + 1];
              }
              std::memcpy(dst, t + pos, tmpl.size() - pos);
              dst += tmpl.size() - pos;
            }
            out.resize((size_t)(dst - out.data()));
          }
        });
  }
  /* Huge-row path (a dense k=15 row has 4^15 columns: a template would
   * be ~14 GB).  "idx:" prefixes once per call, shared read-only by
   * every worker; size_t offsets, since the prefix bytes alone pass
   * 32 bits at k=15. */
  std::vector<char> prefixes;
  std::vector<size_t> pref_off(n_cols + 1, 0);
  {
    char buf[24];
    for (int64_t j = 0; j < n_cols; j++) {
      char* e = emit_u64(buf, (uint64_t)j);
      *e++ = ':';
      pref_off[j + 1] = pref_off[j] + (size_t)(e - buf);
      prefixes.insert(prefixes.end(), buf, e);
    }
  }
  return format_row_segments(
      n_rows, (size_t)n_rows * (size_t)n_cols * 8 + 64,
      [&](int64_t r0, int64_t r1, std::vector<char>& out) {
        char num[24];
        for (int64_t r = r0; r < r1; r++) {
          if (r > 0 || !first) out.push_back('\n');
          const C* row = c + r * n_cols;
          for (int64_t j = 0; j < n_cols; j++) {
            out.insert(out.end(), prefixes.begin() + pref_off[j],
                       prefixes.begin() + pref_off[j + 1]);
            char* e = emit_u64(num, as_u64(row[j]));
            *e++ = ' ';
            out.insert(out.end(), num, e);
          }
        }
      });
}

/* Sparse per-read rows from (idx, counts) pair matrices: cells
 * "idx:count " only where count > 0 (rows may be empty), the separators
 * of the dense format.  I is int32 or the uint64 combined code of
 * k > 15 (up to 20 digits). */
template <typename I>
Segments format_pairs(const I* idx, const int32_t* cnt, int64_t n_rows,
                      int64_t n_cols, bool first) {
  constexpr size_t kIdxDigits = sizeof(I) == 8 ? 20 : 10;
  return format_row_segments(
      n_rows, (size_t)(n_rows * n_cols) * (sizeof(I) == 8 ? 8 : 4) + 64,
      [&](int64_t r0, int64_t r1, std::vector<char>& out) {
        /* Chunked resize + raw-pointer emit: per-cell vector::insert
         * was the dominant cost (capacity check + memmove machinery per
         * 4-12 byte cell). */
        const size_t row_cap = (size_t)n_cols * (kIdxDigits + 13) + 1;
        const int64_t chunk = (int64_t)((((size_t)64 << 20) / row_cap) + 1);
        for (int64_t c0 = r0; c0 < r1; c0 += chunk) {
          const int64_t c1 = c0 + chunk < r1 ? c0 + chunk : r1;
          const size_t base = out.size();
          out.resize(base + (size_t)(c1 - c0) * row_cap);
          char* dst = out.data() + base;
          for (int64_t r = c0; r < c1; r++) {
            if (r > 0 || !first) *dst++ = '\n';
            const I* ri = idx + r * n_cols;
            const int32_t* rc = cnt + r * n_cols;
            for (int64_t j = 0; j < n_cols; j++) {
              if (rc[j] <= 0) continue;
              dst = emit_u64(dst, sizeof(I) == 8 ? (uint64_t)ri[j]
                                                 : (uint64_t)(uint32_t)ri[j]);
              *dst++ = ':';
              dst = emit_u64(dst, (uint64_t)(uint32_t)rc[j]);
              *dst++ = ' ';
            }
          }
          out.resize((size_t)(dst - out.data()));
        }
      });
}

/* DENSE rows (all fk bins, reference src/main.cu:26-62) from sparse
 * per-read (idx, counts) pair matrices: each row's valid cells ascend
 * in idx, cells with count <= 0 are padding.  Byte-identical to
 * format_rows on the densified matrix, which is never built. */
Segments format_dense_pairs(const int32_t* idx, const int32_t* cnt,
                            int64_t n_rows, int64_t n_cols, int64_t fk,
                            bool first) {
  /* Template row "0:0 1:0 ... fk-1:0 " + per-cell start offsets: a row
   * is ~nnz memcpy spans of the template plus one "j:count " emit per
   * nonzero cell.  tmpl is 512 KB at k=8 (cache-resident). */
  std::vector<char> tmpl;
  std::vector<size_t> cell_off(fk + 1, 0);
  {
    char buf[24];
    for (int64_t j = 0; j < fk; j++) {
      char* e = emit_u64(buf, (uint64_t)j);
      *e++ = ':';
      *e++ = '0';
      *e++ = ' ';
      tmpl.insert(tmpl.end(), buf, e);
      cell_off[j + 1] = tmpl.size();
    }
  }
  return format_row_segments(
      n_rows, (size_t)n_rows * (tmpl.size() + (size_t)n_cols * 12 + 1) + 64,
      [&](int64_t r0, int64_t r1, std::vector<char>& out) {
        /* Raw-pointer writes into an upper-bound-sized buffer: each
         * nonzero cell replaces the template's "0" with <= 10 digits,
         * so a row is at most tmpl.size() + 9*n_cols + 1 bytes.  Rows
         * are chunked so the transient over-allocation stays ~64 MB. */
        const char* t = tmpl.data();
        const size_t row_cap = tmpl.size() + (size_t)n_cols * 9 + 1;
        const int64_t chunk = (int64_t)((((size_t)64 << 20) / row_cap) + 1);
        for (int64_t c0 = r0; c0 < r1; c0 += chunk) {
          const int64_t c1 = c0 + chunk < r1 ? c0 + chunk : r1;
          const size_t base = out.size();
          out.resize(base + (size_t)(c1 - c0) * row_cap);
          char* dst = out.data() + base;
          for (int64_t r = c0; r < c1; r++) {
            if (r > 0 || !first) *dst++ = '\n';
            const int32_t* ri = idx + r * n_cols;
            const int32_t* rc = cnt + r * n_cols;
            size_t pos = 0; /* template bytes already emitted */
            for (int64_t q = 0; q < n_cols; q++) {
              if (rc[q] <= 0) continue;                  /* padding */
              const int32_t j = ri[q];
              if (j < 0 || j >= (int32_t)fk) continue;   /* range guard */
              const size_t cs = cell_off[j];
              if (cs < pos) continue; /* non-ascending input guard */
              std::memcpy(dst, t + pos, cs - pos); /* zero-run span */
              dst += cs - pos;
              /* "j:" = the cell's template bytes minus the "0 " tail */
              const size_t plen = cell_off[j + 1] - 2 - cs;
              std::memcpy(dst, t + cs, plen);
              dst += plen;
              dst = emit_u64(dst, (uint64_t)(uint32_t)rc[q]);
              *dst++ = ' ';
              pos = cell_off[j + 1];
            }
            std::memcpy(dst, t + pos, tmpl.size() - pos);
            dst += tmpl.size() - pos;
          }
          out.resize((size_t)(dst - out.data()));
        }
      });
}

/* One "KMERSTRING\tcount\n" row per key with count >= max(min_count, 1),
 * byte-identical to the decode_key writer; a key decodes 2 bits a base,
 * first base most significant, over "ACGT". */
Segments format_kmer_tsv(const uint64_t* keys, const int64_t* cnts, int64_t n,
                         int64_t k, int64_t min_count) {
  const int64_t mc = min_count < 1 ? 1 : min_count;
  static const char kBases[4] = {'A', 'C', 'G', 'T'};
  return format_row_segments(
      n, (size_t)n * ((size_t)k + 8),
      [&](int64_t r0, int64_t r1, std::vector<char>& out) {
        const size_t row_cap = (size_t)k + 24; /* bases + \t + 20 digits + \n */
        const int64_t chunk = (int64_t)((((size_t)32 << 20) / row_cap) + 1);
        for (int64_t c0 = r0; c0 < r1; c0 += chunk) {
          const int64_t c1 = c0 + chunk < r1 ? c0 + chunk : r1;
          const size_t base = out.size();
          out.resize(base + (size_t)(c1 - c0) * row_cap);
          char* dst = out.data() + base;
          for (int64_t r = c0; r < c1; r++) {
            if (cnts[r] < mc) continue;
            const uint64_t key = keys[r];
            for (int64_t i = 0; i < k; i++)
              *dst++ = kBases[(key >> (2 * (uint64_t)(k - 1 - i))) & 3];
            *dst++ = '\t';
            dst = emit_u64(dst, (uint64_t)cnts[r]);
            *dst++ = '\n';
          }
          out.resize((size_t)(dst - out.data()));
        }
      });
}

/* ---- fold: threaded (key, count) -> dense table histogram ----------
 *
 * The host side of the sorted spectrum route for k <= 10: the drain
 * ships narrowed (idx, count) pair matrices (uint16/int32 idx,
 * uint8/int16/int32 counts); this folds them into a dense int64 table
 * with thread-private tables.  Cells with count <= 0 (sentinels,
 * padding; the uint16-wrapped sentinel is 0 with count 0) or idx outside
 * the table are skipped. */
template <typename I, typename C, typename T>
void fold_range(const I* idx, const C* cnt, int64_t i0, int64_t i1, T* table,
                size_t bins) {
  /* Bound by the random table access: prefetching the bin PF cells
   * ahead overlaps the load misses. */
  using UI = typename std::make_unsigned<I>::type;
  constexpr int64_t PF = 16;
  int64_t i = i0;
  for (; i + PF < i1; i++) {
    const size_t vp = (size_t)(UI)idx[i + PF];
    if (vp < bins) __builtin_prefetch(&table[vp], 1, 1);
    const int64_t c = (int64_t)cnt[i];
    /* Unsigned cast: a negative int32 wraps huge and fails the bounds
     * check. */
    const size_t v = (size_t)(UI)idx[i];
    if (c > 0 && v < bins) table[v] += (T)c;
  }
  for (; i < i1; i++) {
    const int64_t c = (int64_t)cnt[i];
    const size_t v = (size_t)(UI)idx[i];
    if (c > 0 && v < bins) table[v] += (T)c;
  }
}

template <typename I, typename C>
void fold_dispatch(const void* idx_raw, const void* cnt_raw, int64_t n,
                   int64_t* table, int64_t bins) {
  const I* idx = (const I*)idx_raw;
  const C* cnt = (const C*)cnt_raw;
  unsigned hc = std::thread::hardware_concurrency();
  unsigned T = hc ? (hc < 8 ? hc : 8) : 1;
  if (const char* env = getenv("CFRK_FOLD_THREADS")) {
    const long cap = atol(env);
    if (cap > 0 && (unsigned)cap < T) T = (unsigned)cap;
  }
  /* Private tables cost T*bins*4-8 bytes: serial when the elements are
   * few (thread spawn dominates) or the table is large. */
  if (n < (int64_t)(1 << 20) || bins > (int64_t)(16 << 20)) T = 1;
  /* int32 private tables halve the random-access working set; exact
   * whenever the call's TOTAL count mass fits int32, which one
   * sequential pass measures. */
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t c = (int64_t)cnt[i];
    total += c > 0 ? c : 0;
  }
  const bool narrow = total < (int64_t)INT32_MAX;
  if (T <= 1) {
    if (narrow && n >= (int64_t)(1 << 18)) {
      std::vector<int32_t> scratch((size_t)bins, 0);
      fold_range<I, C, int32_t>(idx, cnt, 0, n, scratch.data(), (size_t)bins);
      for (int64_t b = 0; b < bins; b++) table[b] += scratch[(size_t)b];
    } else {
      fold_range<I, C, int64_t>(idx, cnt, 0, n, table, (size_t)bins);
    }
    return;
  }
  std::vector<std::vector<int64_t>> priv64(narrow ? 0 : T);
  std::vector<std::vector<int32_t>> priv32(narrow ? T : 0);
  run_parallel(T, [&](unsigned t) {
    const int64_t i0 = n * (int64_t)t / (int64_t)T;
    const int64_t i1 = n * (int64_t)(t + 1) / (int64_t)T;
    if (narrow) {
      priv32[t].assign((size_t)bins, 0);
      fold_range<I, C, int32_t>(idx, cnt, i0, i1, priv32[t].data(),
                                (size_t)bins);
    } else {
      priv64[t].assign((size_t)bins, 0);
      fold_range<I, C, int64_t>(idx, cnt, i0, i1, priv64[t].data(),
                                (size_t)bins);
    }
  });
  /* Parallel merge by bin range. */
  run_parallel(T, [&](unsigned t) {
    const int64_t b0 = bins * (int64_t)t / (int64_t)T;
    const int64_t b1 = bins * (int64_t)(t + 1) / (int64_t)T;
    if (narrow) {
      for (const auto& p : priv32)
        for (int64_t b = b0; b < b1; b++) table[b] += p[(size_t)b];
    } else {
      for (const auto& p : priv64)
        for (int64_t b = b0; b < b1; b++) table[b] += p[(size_t)b];
    }
  });
}

}  // namespace

/* The formatted text: row segments, concatenated in order on copy-out. */
struct CfrkText {
  Segments segs;
};

namespace {

int hand_out(Segments&& segs, CfrkText** out, int64_t* size) {
  std::unique_ptr<CfrkText> text(new CfrkText{std::move(segs)});
  int64_t total = 0;
  for (const auto& s : text->segs) total += (int64_t)s.size();
  *size = total;
  *out = text.release();
  return kOk;
}

unsigned char qual_threshold(int min_qual_byte) {
  return (unsigned char)(min_qual_byte > 0 ? min_qual_byte : 0);
}

}  // namespace

extern "C" {

const char* cfrk_strerror(int code) {
  return code >= 0 && code < kErrCount ? kErrText[code] : "unknown error";
}

/* Lines of a buffer: its '\n' bytes + 1, a bound on the records any
 * parse of it yields. */
int64_t cfrk_count_lines(const unsigned char* p, int64_t n) {
  int64_t lines = 1;
  for (int64_t i = 0; i < n;) {
    const int64_t eol = find_eol(p, i, n);
    if (eol == n) break;
    lines++;
    i = eol + 1;
  }
  return lines;
}

/* codes: capacity n; lengths: capacity cfrk_count_lines(p, n).
 * min_qual_byte: 33 + Phred threshold, or 0 for no mask. */
int cfrk_parse_encode(const unsigned char* p, int64_t n, int min_qual_byte,
                      int8_t* codes, int64_t* lengths, int64_t* n_codes,
                      int64_t* n_records) {
  return guarded([&] {
    return parse_encode(p, n, qual_threshold(min_qual_byte), codes, lengths,
                        n_codes, n_records);
  });
}

/* codes: capacity n; lengths, offsets: capacity cfrk_count_lines(p, n). */
int cfrk_parse_encode_stream(const unsigned char* p, int64_t n, int is_fastq,
                             int final_chunk, int min_qual_byte,
                             int8_t* codes, int64_t* lengths,
                             int64_t* offsets, int64_t* n_codes,
                             int64_t* n_records, int64_t* consumed) {
  return guarded([&] {
    return parse_encode_stream(p, n, is_fastq != 0, final_chunk != 0,
                               qual_threshold(min_qual_byte), codes, lengths,
                               offsets, n_codes, n_records, consumed);
  });
}

/* A padded [batch_rows, row_len] int8 batch from a flat code buffer +
 * per-record lengths: row i = record i's codes then -1 padding; rows
 * past the record count are all -1.  memcpy/memset per record, the
 * analog of the reference's chunk copies (src/main.cu:186-190). */
int cfrk_pack_records(const int8_t* flat, int64_t n_flat,
                      const int64_t* lens, int64_t n_rec, int64_t batch_rows,
                      int64_t row_len, int8_t* dst) {
  if (n_rec > batch_rows) return kErrPackRows;
  int64_t total = 0;
  bool too_long = false;
  for (int64_t i = 0; i < n_rec; i++) {
    total += lens[i];
    if (lens[i] > row_len || lens[i] < 0) too_long = true;
  }
  if (too_long) return kErrPackLong;
  if (total != n_flat) return kErrPackSum;
  const int8_t* src = flat;
  for (int64_t i = 0; i < n_rec; i++) {
    const int64_t L = lens[i];
    std::memcpy(dst, src, (size_t)L);
    std::memset(dst + L, 0xFF, (size_t)(row_len - L)); /* -1 padding */
    src += L;
    dst += row_len;
  }
  std::memset(dst, 0xFF, (size_t)((batch_rows - n_rec) * row_len));
  return kOk;
}

/* counts: [n_rows, n_cols] int32 (cnt_item 4) or int64 (8). */
int cfrk_format_rows(const void* counts, int cnt_item, int64_t n_rows,
                     int64_t n_cols, int first, CfrkText** out,
                     int64_t* size) {
  return guarded([&] {
    if (cnt_item == 8)
      return hand_out(format_rows((const int64_t*)counts, n_rows, n_cols,
                                  first != 0),
                      out, size);
    if (cnt_item == 4)
      return hand_out(format_rows((const int32_t*)counts, n_rows, n_cols,
                                  first != 0),
                      out, size);
    return (int)kErrInternal;
  });
}

int cfrk_format_pairs(const int32_t* idx, const int32_t* counts,
                      int64_t n_rows, int64_t n_cols, int first,
                      CfrkText** out, int64_t* size) {
  return guarded([&] {
    return hand_out(format_pairs(idx, counts, n_rows, n_cols, first != 0),
                    out, size);
  });
}

int cfrk_format_pairs64(const uint64_t* idx, const int32_t* counts,
                        int64_t n_rows, int64_t n_cols, int first,
                        CfrkText** out, int64_t* size) {
  return guarded([&] {
    return hand_out(format_pairs(idx, counts, n_rows, n_cols, first != 0),
                    out, size);
  });
}

int cfrk_format_dense_pairs(const int32_t* idx, const int32_t* counts,
                            int64_t n_rows, int64_t n_cols, int64_t fk,
                            int first, CfrkText** out, int64_t* size) {
  return guarded([&] {
    return hand_out(
        format_dense_pairs(idx, counts, n_rows, n_cols, fk, first != 0), out,
        size);
  });
}

int cfrk_format_kmer_tsv(const uint64_t* keys, const int64_t* counts,
                         int64_t n, int64_t k, int64_t min_count,
                         CfrkText** out, int64_t* size) {
  if (k < 1 || k > 32) return kErrK;
  return guarded([&] {
    return hand_out(format_kmer_tsv(keys, counts, n, k, min_count), out,
                    size);
  });
}

/* Copy the text into dst (its size bytes) and free it. */
void cfrk_text_take(CfrkText* text, char* dst) {
  for (const auto& s : text->segs) {
    std::memcpy(dst, s.data(), s.size());
    dst += s.size();
  }
  delete text;
}

void cfrk_text_free(CfrkText* text) { delete text; }

/* idx: uint16 (item 2) / int32 (4); counts: uint8 (1) / int16 (2) /
 * int32 (4) / int64 (8); table: int64 [bins], added into in place. */
int cfrk_fold_pairs(const void* idx, int idx_item, const void* counts,
                    int cnt_item, int64_t n, int64_t* table, int64_t bins) {
  return guarded([&] {
    if (idx_item == 2 && cnt_item == 1)
      fold_dispatch<uint16_t, uint8_t>(idx, counts, n, table, bins);
    else if (idx_item == 2 && cnt_item == 2)
      fold_dispatch<uint16_t, int16_t>(idx, counts, n, table, bins);
    else if (idx_item == 2 && cnt_item == 4)
      fold_dispatch<uint16_t, int32_t>(idx, counts, n, table, bins);
    else if (idx_item == 2 && cnt_item == 8)
      fold_dispatch<uint16_t, int64_t>(idx, counts, n, table, bins);
    else if (idx_item == 4 && cnt_item == 1)
      fold_dispatch<int32_t, uint8_t>(idx, counts, n, table, bins);
    else if (idx_item == 4 && cnt_item == 2)
      fold_dispatch<int32_t, int16_t>(idx, counts, n, table, bins);
    else if (idx_item == 4 && cnt_item == 4)
      fold_dispatch<int32_t, int32_t>(idx, counts, n, table, bins);
    else if (idx_item == 4 && cnt_item == 8)
      fold_dispatch<int32_t, int64_t>(idx, counts, n, table, bins);
    else
      return (int)kErrFoldDtype;
    return (int)kOk;
  });
}

}  // extern "C"
