// Native FASTA parse + 2-bit encode, and dense batch assembly — the
// ingest hot path.
//
// Plays the role FASTdoop's record readers play for the reference
// (SURVEY.md §2.6: "record ingest" is one of the JVM-library roles that
// must become first-class native components): one pass over the raw file
// bytes produces invalid-code-4 encoded sequence codes with headers and
// line breaks removed, plus per-record offsets.  fk_pack_dense then cuts
// those records into chunks with a k-1 overlap and packs them into the
// fixed-shape [R, L] batches, one call a batch (ingest/batch.py's dense
// route; its python packer is the fallback and the reference).
//
// Exposed via ctypes (no pybind11 in this image); see __init__.py.

#include <cstdint>
#include <cstring>

#include <zlib.h>

namespace {

// ASCII -> 2-bit code; 4 = invalid (mirrors core/bits.py ASCII_TO_CODE,
// semantics of the reference's nucleotideBitmasks + notANucleotide,
// package.scala:18-22, :697).  Whitespace is stripped, not encoded.
struct Lut {
    uint8_t v[256];
    Lut() {
        std::memset(v, 4, sizeof(v));
        v[uint8_t('A')] = 0;
        v[uint8_t('C')] = 1;
        v[uint8_t('G')] = 2;
        v[uint8_t('T')] = 3;
    }
};
const Lut LUT;

inline bool is_eol_ws(uint8_t c) { return c == '\n' || c == '\r'; }

}  // namespace

extern "C" {

// Encode n raw bytes to codes (no parsing).  Returns n.
int64_t fk_encode(const uint8_t* in, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = LUT.v[in[i]];
    return n;
}

// gzip inflate (multi-member, >4GB-safe via chunked avail_in/out).
// Returns decompressed size, -1 if out_cap is too small (caller grows and
// retries), <-1 on malformed input, -5 on TRUNCATED input (input exhausted
// mid-member without Z_STREAM_END — silently returning the partial bytes
// would yield wrong counts downstream; Python's gzip raises EOFError here).
int64_t fk_gunzip(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    z_stream zs;
    std::memset(&zs, 0, sizeof zs);
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return -2;
    const int64_t CH = 1 << 30;
    int64_t ip = 0, op = 0;
    bool mid_member = false;  // inflate progressed without a member end
    while (true) {
        if (zs.avail_in == 0) {
            if (ip >= n) {
                if (mid_member) { inflateEnd(&zs); return -5; }
                break;
            }
            int64_t c = n - ip > CH ? CH : n - ip;
            zs.next_in = const_cast<Bytef*>(in + ip);
            zs.avail_in = (uInt)c;
            ip += c;
        }
        if (op >= cap) { inflateEnd(&zs); return -1; }
        int64_t oc = cap - op > CH ? CH : cap - op;
        zs.next_out = out + op;
        zs.avail_out = (uInt)oc;
        int ret = inflate(&zs, Z_NO_FLUSH);
        op += oc - (int64_t)zs.avail_out;
        if (ret == Z_STREAM_END) {
            mid_member = false;
            if (zs.avail_in == 0 && ip >= n) break;
            if (inflateReset(&zs) != Z_OK) { inflateEnd(&zs); return -3; }
        } else if (ret == Z_BUF_ERROR) {
            if (op >= cap) { inflateEnd(&zs); return -1; }
            if (zs.avail_in == 0 && ip >= n) { inflateEnd(&zs); return -4; }
        } else if (ret != Z_OK) {
            inflateEnd(&zs);
            return -4;
        } else {
            mid_member = true;
        }
    }
    inflateEnd(&zs);
    return op;
}

// One-pass FASTA parse+encode.
//   in/n:        raw file bytes
//   codes_out:   capacity >= n; receives concatenated encoded records
//   rec_starts:  capacity >= max_recs + 1; record i occupies
//                codes_out[rec_starts[i] .. rec_starts[i+1])
//   max_recs:    capacity guard
// Returns the number of records, or -1 if max_recs would be exceeded.
// Header lines ('>' .. end of line) are skipped; '\n'/'\r' are stripped
// (the reference strips '\n' only, SparkBinKmerCounter.scala:63-64, and
// leaves '\r' to be treated as an invalid base; stripping it is a strict
// superset that makes CRLF files parse like LF files).
int64_t fk_parse_fasta(const uint8_t* in, int64_t n, uint8_t* codes_out,
                       int64_t* rec_starts, int64_t max_recs) {
    int64_t nrec = 0;
    int64_t w = 0;
    int64_t i = 0;
    bool in_header = false;
    bool open_rec = false;
    while (i < n) {
        uint8_t c = in[i];
        if (in_header) {
            if (c == '\n') in_header = false;
            ++i;
            continue;
        }
        if (c == '>') {
            in_header = true;
            if (nrec >= max_recs) return -1;
            rec_starts[nrec++] = w;
            open_rec = true;
            ++i;
            continue;
        }
        if (is_eol_ws(c)) {
            ++i;
            continue;
        }
        // sequence byte outside any record (headerless file): open record 0
        if (!open_rec) {
            if (nrec >= max_recs) return -1;
            rec_starts[nrec++] = w;
            open_rec = true;
        }
        codes_out[w++] = LUT.v[c];
        ++i;
    }
    rec_starts[nrec] = w;
    return nrec;
}

// One-pass FASTQ parse+encode (4-line records; quality ignored).
int64_t fk_parse_fastq(const uint8_t* in, int64_t n, uint8_t* codes_out,
                       int64_t* rec_starts, int64_t max_recs) {
    int64_t nrec = 0;
    int64_t w = 0;
    int64_t i = 0;
    while (i < n) {
        // header line starting with '@'
        while (i < n && is_eol_ws(in[i])) ++i;
        if (i >= n) break;
        if (in[i] != '@') return -2;  // malformed
        while (i < n && in[i] != '\n') ++i;
        ++i;
        if (nrec >= max_recs) return -1;
        rec_starts[nrec++] = w;
        // sequence line(s) until '+'
        while (i < n && in[i] != '+') {
            uint8_t c = in[i];
            if (!is_eol_ws(c)) codes_out[w++] = LUT.v[c];
            ++i;
        }
        // '+' line
        while (i < n && in[i] != '\n') ++i;
        ++i;
        // quality: same number of non-ws chars as the sequence
        int64_t need = w - rec_starts[nrec - 1];
        while (i < n && need > 0) {
            if (!is_eol_ws(in[i])) --need;
            ++i;
        }
    }
    rec_starts[nrec] = w;
    return nrec;
}

// Fill one [R, L] batch from parsed records, densely: several chunks a
// row, one invalid cell between two chunks in a row, a chunk that does not
// fit starting the next row (ingest/batch.py's _DensePacker).  A record of
// length <= L is one chunk; a longer one is cut at stride L-(k-1) into
// chunks of min(L, rest), ending with the chunk that reaches its end.
//   codes, rec_starts: fk_parse_* output; record i is
//                codes[rec_starts[i] .. rec_starts[i+1]), i < nrec
//   out:         R*L bytes, every one written (code 4 where no chunk is)
//   cursor:      in/out {record, offset of the next chunk in it}; starts
//                at {0, 0} and is left at the first chunk not placed
//   totals:      out {chunks placed, their lengths summed}
// A batch ends when a chunk overflows its last row or the records run
// out.  Returns the chunks placed, 0 once the records are exhausted (no
// batch), or -1 if a record needs cutting and L-(k-1) < 1.
int64_t fk_pack_dense(const uint8_t* codes, const int64_t* rec_starts,
                      int64_t nrec, int32_t k, int64_t R, int64_t L,
                      uint8_t* out, int64_t* cursor, int64_t* totals) {
    const int64_t stride = L - (k - 1);
    int64_t rec = cursor[0], rel = cursor[1];
    int64_t row = 0, col = 0, n_reads = 0, n_bases = 0;
    uint8_t* rowp = out;
    while (rec < nrec) {
        const int64_t off = rec_starts[rec];
        const int64_t ln = rec_starts[rec + 1] - off;
        const int64_t n = ln - rel < L ? ln - rel : L;
        int64_t need = col == 0 ? n : n + 1;  // +1 separator cell
        if (col + need > L) {
            std::memset(rowp + col, 4, L - col);
            col = 0;
            if (++row == R) break;  // full: the chunk opens the next batch
            rowp += L;
            need = n;
        }
        if (need > n) rowp[col++] = 4;
        std::memcpy(rowp + col, codes + off + rel, n);
        col += n;
        ++n_reads;
        n_bases += n;
        if (rel + L >= ln) {
            ++rec;
            rel = 0;
        } else if (stride < 1) {
            return -1;
        } else {
            rel += stride;
        }
    }
    if (row < R) {
        std::memset(rowp + col, 4, (R - row) * L - col);
    }
    cursor[0] = rec;
    cursor[1] = rel;
    totals[0] = n_reads;
    totals[1] = n_bases;
    return n_reads;
}

// Decode packed k-mer rows + counts into "<KMER>\t<count>\n" lines — the
// output hot path (the reference's per-Kmer toByteArray + BufferedWriter
// loop, package.scala:416-454 + SparkBinKmerCounter.scala:566-597).
//   words:  n rows x W uint32, 16 big-endian 2-bit bases per word
//   counts: int64[n]
//   out:    capacity >= n * (k + 22) bytes
// Returns bytes written.
int64_t fk_dump_lines(const uint32_t* words, const int64_t* counts,
                      int64_t n, int32_t k, int32_t W, uint8_t* out) {
    static const char B[4] = {'A', 'C', 'G', 'T'};
    int64_t o = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* row = words + i * W;
        for (int32_t p = 0; p < k; ++p) {
            uint32_t word = row[p >> 4];
            int shift = 2 * (15 - (p & 15));
            out[o++] = B[(word >> shift) & 3u];
        }
        out[o++] = '\t';
        int64_t c = counts[i];
        char buf[24];
        int bl = 0;
        if (c <= 0) buf[bl++] = '0';
        while (c > 0) { buf[bl++] = char('0' + (c % 10)); c /= 10; }
        while (bl > 0) out[o++] = uint8_t(buf[--bl]);
        out[o++] = '\n';
    }
    return o;
}

}  // extern "C"
