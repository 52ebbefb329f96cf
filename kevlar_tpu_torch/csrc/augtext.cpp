// One novel-screen batch's augmented-FASTX text, written in C++.
//
// The novel stage's text output (kevlar's augmented FASTQ/FASTA): for each
// read with novel k-mers a header, `@name\nseq\n+\nqual\n` or
// `>name\nseq\n`, then one line a k-mer, its offset in spaces, the k-mer,
// ten spaces, the samples' abundances and `#`.  The screen's hits arrive
// as arrays; these two calls drop the hits on discarded and padding rows
// and write the whole block, with no per-line Python, giving each line's
// canonical k-mer as a 2-bit code.
//
// C ABI (ctypes):
//   int64_t kt_augtext_lines(
//       const int64_t *hits, int64_t nhits, int64_t P, int64_t nvalid,
//       const uint8_t *discard, int64_t ndiscard,
//       int64_t *keep, int64_t *rows, int64_t *nrows);
//
//   Hit h is window h % P of batch row h / P.  The hits kept are those on
//   rows below nvalid whose discard[min(row, ndiscard - 1)] is 0; their
//   indices go to keep[0, n) and the rows they start, in order, to
//   rows[0, *nrows) (a new row where it differs from the last kept hit's).
//   Returns n, or -1 where a hit is negative or P is not.
//
//   int64_t kt_augtext(
//       int from_reader,
//       const uint8_t *seq, int64_t seq_stride, int64_t seq_extent,
//       const int32_t *lengths, int64_t nrows,
//       const uint8_t *qual, int64_t qual_stride, int64_t qual_extent,
//       const int32_t *qual_len,
//       const int64_t *read_row, int64_t nreads,
//       const char *names, int64_t names_len,
//       const int64_t *hits, int64_t nhits, const int64_t *keep,
//       int64_t nlines, int64_t P,
//       const uint8_t *abund, int64_t nsamples, int k,
//       char *out, int64_t cap, uint64_t *canon, int64_t *nhost);
//
//   Line l is hit hits[keep[l]], its abundances abund[s * nhits + keep[l]]
//   for s < nsamples; a new read starts where its batch row differs from
//   the last line's.  Read j (0 <= j < nreads, in the order of their
//   lines) is data row d = read_row[j] (0 <= d < nrows): lengths[d] bases
//   at seq + d * seq_stride, its name the j-th of the NUL-separated names
//   and, where qual is not NULL, qual_len[d] quality bytes (lengths[d]
//   where qual_len is NULL) at qual + d * qual_stride.
//   Every span is checked against seq_extent and qual_extent, each row
//   against nrows and each keep[l] against nhits, before it is read.
//     from_reader != 0: the rows are the FASTX reader's: base codes 0-4,
//       written as ACGTN, and raw quality bytes.  A read is FASTA where its
//       quality bytes are all NUL, and a byte outside ASCII is written as
//       U+FFFD in UTF-8 (what Python's decode('ascii', 'replace') gives).
//     from_reader == 0: the rows are text as the reads' records hold it,
//       and the qualities UTF-8 text; a read is FASTA where its qual_len is
//       negative.
//     qual == NULL: every read is FASTA.
//   A line's k-mer is the k bases at its window, cut at its read's end (a
//   Python slice).  canon[l] is min(forward, reverse complement) of its
//   2-bit code (A=0 C=1 G=2 T=3, the first base highest), or UINT64_MAX
//   where k > 32 or the k-mer is not k upper-case ACGT bases (no k-mer's
//   code is UINT64_MAX: that of T^32's reverse complement is 0); *nhost
//   counts the latter.
//   Returns the bytes the block needs (written whole only if that is at
//   most cap), or -1 where the reads, names or lines are out of bounds.

#include <cstdint>
#include <cstring>

namespace {

// base code to its letter: 0-3 to ACGT, anything else N
char g_code_char[256];

// upper-case ACGT to 0-3, everything else 4
uint8_t g_text_code[256];
struct TablesInit {
    TablesInit() {
        std::memset(g_code_char, 'N', sizeof(g_code_char));
        std::memset(g_text_code, 4, sizeof(g_text_code));
        for (int c = 0; c < 4; ++c) {
            g_code_char[c] = "ACGT"[c];
            g_text_code[(int)"ACGT"[c]] = (uint8_t)c;
        }
    }
} g_tables_init;

struct Out {
    char *buf;
    int64_t cap;
    int64_t pos = 0;

    bool room(int64_t n) const { return pos + n <= cap; }
    void put(const void *src, int64_t n) {
        if (room(n)) std::memcpy(buf + pos, src, n);
        pos += n;
    }
    void put(char c) {
        if (room(1)) buf[pos] = c;
        ++pos;
    }
    void fill(char c, int64_t n) {
        if (room(n)) std::memset(buf + pos, c, n);
        pos += n;
    }
    void bases(const uint8_t *src, int64_t n, bool codes) {
        if (!codes) {
            put(src, n);
            return;
        }
        if (room(n))
            for (int64_t i = 0; i < n; ++i)
                buf[pos + i] = g_code_char[src[i]];
        pos += n;
    }
    void number(unsigned v) {
        char digits[3];
        int n = 0;
        do {
            digits[n++] = char('0' + v % 10);
            v /= 10;
        } while (v);
        while (n) put(digits[--n]);
    }
};

bool all_nul(const uint8_t *q, int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        if (q[i]) return false;
    return true;
}

void raw_quality(Out &o, const uint8_t *q, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        if (q[i] < 0x80) {
            o.put(char(q[i]));
        } else {
            o.put("\xEF\xBF\xBD", 3);
        }
    }
}

bool within(int64_t start, int64_t len, int64_t extent) {
    return start >= 0 && len >= 0 && len <= extent && start <= extent - len;
}

// Canonical codes of a read's k-mers, rolled along it: a read's lines come
// in ascending windows, so each base is taken once where they overlap.
struct Roller {
    int k;
    bool codes;
    uint64_t mask;
    int top;
    int64_t pos = -1, run = 0;  // the last `run` bases before `pos` are held
    uint64_t fwd = 0, rev = 0;

    Roller(int k, bool codes)
        : k(k), codes(codes),
          mask(k >= 32 ? ~uint64_t(0) : (uint64_t(1) << (2 * k)) - 1),
          top(2 * (k - 1)) {}

    void new_read() { pos = -1; }

    // the code of the k bases at [off, off + n) of s, UINT64_MAX where
    // n != k, k > 32 or one is not an (upper-case) ACGT base
    uint64_t at(const uint8_t *s, int64_t off, int64_t n) {
        if (k > 32 || n != k) return UINT64_MAX;
        if (pos < off || pos > off + k) {
            pos = off;
            run = 0;
        }
        for (; pos < off + k; ++pos) {
            const uint64_t c = codes ? s[pos] : g_text_code[s[pos]];
            if (c > 3) {
                run = 0;
                continue;
            }
            fwd = ((fwd << 2) | c) & mask;
            rev = (rev >> 2) | ((3 - c) << top);
            ++run;
        }
        if (run < k) return UINT64_MAX;
        return fwd < rev ? fwd : rev;
    }
};

}  // namespace

extern "C" {

int64_t kt_augtext_lines(const int64_t *hits, int64_t nhits, int64_t P,
                         int64_t nvalid, const uint8_t *discard,
                         int64_t ndiscard, int64_t *keep, int64_t *rows,
                         int64_t *nrows) {
    int64_t n = 0, r = 0, last = -1;
    if (nhits && P <= 0) return -1;
    for (int64_t h = 0; h < nhits; ++h) {
        if (hits[h] < 0) return -1;
        int64_t row = hits[h] / P;
        if (row >= nvalid) continue;
        if (ndiscard && discard[row < ndiscard ? row : ndiscard - 1])
            continue;
        if (row != last) rows[r++] = last = row;
        keep[n++] = h;
    }
    *nrows = r;
    return n;
}

int64_t kt_augtext(int from_reader, const uint8_t *seq, int64_t seq_stride,
                   int64_t seq_extent, const int32_t *lengths, int64_t nrows,
                   const uint8_t *qual, int64_t qual_stride,
                   int64_t qual_extent, const int32_t *qual_len,
                   const int64_t *read_row, int64_t nreads,
                   const char *names, int64_t names_len,
                   const int64_t *hits, int64_t nhits, const int64_t *keep,
                   int64_t nlines, int64_t P, const uint8_t *abund,
                   int64_t nsamples, int k, char *out, int64_t cap,
                   uint64_t *canon, int64_t *nhost) {
    Out o{out, cap};
    const bool codes = from_reader != 0;
    int64_t j = -1, last = -1, L = 0, host = 0, name = 0;
    const uint8_t *s = nullptr;
    Roller roll(k, codes);
    if (nlines && P <= 0) return -1;
    for (int64_t l = 0; l < nlines; ++l) {
        const int64_t h = keep[l];
        if (h < 0 || h >= nhits || hits[h] < 0) return -1;
        const int64_t row = hits[h] / P, off = hits[h] % P;
        if (l == 0 || row != last) {
            last = row;
            if (++j >= nreads) return -1;
            const int64_t d = read_row[j];
            if (d < 0 || d >= nrows || name > names_len) return -1;
            L = lengths[d];
            if (!within(d * seq_stride, L, seq_extent)) return -1;
            const char *nul = static_cast<const char *>(
                std::memchr(names + name, 0, names_len - name));
            const int64_t name_n = (nul ? nul - names : names_len) - name;
            s = seq + d * seq_stride;
            roll.new_read();
            const uint8_t *q = nullptr;
            int64_t QL = -1;
            if (qual) {
                QL = qual_len ? qual_len[d] : L;
                if (QL >= 0 && !within(d * qual_stride, QL, qual_extent))
                    return -1;
                q = qual + d * qual_stride;
            }
            const bool fastq = q && (codes ? !all_nul(q, QL) : QL >= 0);
            o.put(fastq ? '@' : '>');
            o.put(names + name, name_n);
            name += name_n + 1;
            o.put('\n');
            o.bases(s, L, codes);
            o.put('\n');
            if (fastq) {
                o.put("+\n", 2);
                if (codes)
                    raw_quality(o, q, QL);
                else
                    o.put(q, QL);
                o.put('\n');
            }
        }
        const int64_t n = off < L ? (L - off < k ? L - off : k) : 0;
        o.fill(' ', off);
        o.bases(s + off, n, codes);
        o.fill(' ', 10);
        for (int64_t a = 0; a < nsamples; ++a) {
            if (a) o.put(' ');
            o.number(abund[a * nhits + h]);
        }
        o.put("#\n", 2);
        canon[l] = roll.at(s, off, n);
        host += canon[l] == UINT64_MAX;
    }
    *nhost = host;
    return o.pos;
}

}  // extern "C"
