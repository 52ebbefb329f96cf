// Native FASTA/FASTQ(.gz) batch parser.
//
// The reference relies on khmer's C++ ReadParser for sequence input
// (reference kevlar/count.py:40).  This is the kevlar-tpu equivalent:
// a zlib-backed streaming parser that marshals reads directly into the padded
// 2-bit base-code batches the device kernels consume — no per-read Python
// objects on the hot path.
//
// C ABI (ctypes):
//   void* kt_fastx_open(const char* path);
//   int   kt_fastx_next_batch(void* h, int max_reads, int max_len,
//                             uint8_t* bases, int32_t* lengths,
//                             char* names, int names_cap, char* quals);
//       quals may be NULL; otherwise a [max_reads, max_len] row-major char
//       array receiving quality strings (FASTQ only).
//       returns #reads parsed (0 at EOF, -1 on error); bases is a
//       [max_reads, max_len] row-major array pre-filled by the callee with
//       the invalid code 4; names are nul-separated.
//   void  kt_fastx_close(void* h);

#include <zlib.h>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FastxReader {
    gzFile fp = nullptr;
    std::string pending;      // buffered line (lookahead)
    bool have_pending = false;
    std::vector<char> buf;
    // long-record chunking: sequences longer than max_len are emitted as
    // consecutive rows sharing `overlap` characters (k-1 keeps every k-mer
    // in exactly one row); the unemitted tail waits here
    int overlap = 0;
    std::string carry_name, carry_seq, carry_qual;
    // read offset into carry_seq/carry_qual: advancing an index instead of
    // re-copying the remainder keeps genome-scale chunking O(n) (substr of
    // a 25 Mb record per 1 KB chunk was quadratic: ~600 G byte copies)
    size_t carry_off = 0;

    bool getline(std::string &out) {
        if (have_pending) {
            out = pending;
            have_pending = false;
            return true;
        }
        out.clear();
        char chunk[4096];
        bool got = false;
        while (gzgets(fp, chunk, sizeof(chunk)) != nullptr) {
            got = true;
            size_t n = std::strlen(chunk);
            bool nl = n > 0 && chunk[n - 1] == '\n';
            if (nl) chunk[--n] = '\0';
            if (n > 0 && chunk[n - 1] == '\r') chunk[--n] = '\0';
            out.append(chunk, n);
            if (nl) break;
        }
        return got;
    }

    void ungetline(const std::string &line) {
        pending = line;
        have_pending = true;
    }
};

uint8_t g_code[256];
struct CodeInit {
    CodeInit() {
        std::memset(g_code, 4, sizeof(g_code));
        g_code[(int)'A'] = g_code[(int)'a'] = 0;
        g_code[(int)'C'] = g_code[(int)'c'] = 1;
        g_code[(int)'G'] = g_code[(int)'g'] = 2;
        g_code[(int)'T'] = g_code[(int)'t'] = 3;
    }
} g_code_init;

}  // namespace

extern "C" {

void *kt_fastx_open(const char *path) {
    gzFile fp = gzopen(path, "rb");
    if (!fp) return nullptr;
    gzbuffer(fp, 1 << 20);
    auto *r = new FastxReader();
    r->fp = fp;
    return r;
}

void kt_fastx_set_overlap(void *h, int overlap) {
    auto *r = static_cast<FastxReader *>(h);
    if (r && overlap >= 0) r->overlap = overlap;
}

void kt_fastx_close(void *h) {
    auto *r = static_cast<FastxReader *>(h);
    if (r) {
        if (r->fp) gzclose(r->fp);
        delete r;
    }
}

int kt_fastx_next_batch(void *h, int max_reads, int max_len, uint8_t *bases,
                        int32_t *lengths, char *names, int names_cap,
                        char *quals) {
    auto *r = static_cast<FastxReader *>(h);
    if (!r) return -1;
    int n = 0;
    int names_used = 0;
    std::string line, seq, name, qual;
    while (n < max_reads) {
        const char *sdata;
        const char *qdata = nullptr;
        size_t qavail = 0;
        int L;
        bool carry_done = false;
        if (!r->carry_seq.empty()) {   // resume a chunked long record
            name = r->carry_name;
            size_t avail = r->carry_seq.size() - r->carry_off;
            sdata = r->carry_seq.data() + r->carry_off;
            if (r->carry_qual.size() > r->carry_off) {
                qdata = r->carry_qual.data() + r->carry_off;
                qavail = r->carry_qual.size() - r->carry_off;
            }
            if ((int)avail > max_len) {
                int ov = r->overlap < max_len - 1 ? r->overlap
                                                  : max_len - 1;
                r->carry_off += (size_t)(max_len - ov);
                L = max_len;
            } else {
                L = (int)avail;        // final chunk; carry cleared below
                carry_done = true;
            }
        } else {
            if (!r->getline(line)) break;
            if (line.empty()) continue;
            qual.clear();
            if (line[0] == '@') {          // FASTQ
                name = line.substr(1);
                if (!r->getline(seq)) return -1;
                std::string plus;
                if (!r->getline(plus)) return -1;   // '+'
                if (!r->getline(qual)) return -1;   // quality (len == seq)
            } else if (line[0] == '>') {   // FASTA (possibly multi-line)
                name = line.substr(1);
                seq.clear();
                std::string next;
                while (r->getline(next)) {
                    if (!next.empty() && (next[0] == '>' || next[0] == '@')) {
                        r->ungetline(next);
                        break;
                    }
                    seq += next;
                }
            } else {
                return -1;  // unrecognized format
            }
            L = (int)seq.size();
            if (L > max_len) {
                // emit max_len now; park the whole record (swap, no copy)
                // with a rolling offset; `overlap` (k-1) characters repeat
                // so no k-mer straddles an emission boundary
                int ov = r->overlap < max_len - 1 ? r->overlap
                                                  : max_len - 1;
                r->carry_name = name;
                r->carry_seq.swap(seq);
                r->carry_qual.swap(qual);
                r->carry_off = (size_t)(max_len - ov);
                sdata = r->carry_seq.data();
                if (!r->carry_qual.empty()) {
                    qdata = r->carry_qual.data();
                    qavail = r->carry_qual.size();
                }
                L = max_len;
            } else {
                sdata = seq.data();
                if (!qual.empty()) {
                    qdata = qual.data();
                    qavail = qual.size();
                }
            }
        }
        uint8_t *row = bases + (size_t)n * max_len;
        for (int i = 0; i < L; ++i) row[i] = g_code[(uint8_t)sdata[i]];
        lengths[n] = L;
        if (quals) {
            char *qrow = quals + (size_t)n * max_len;
            int QL = (int)qavail < L ? (int)qavail : L;
            if (QL > 0) std::memcpy(qrow, qdata, QL);
            for (int i = QL; i < max_len; ++i) qrow[i] = 0;
        }
        if (carry_done) {
            // emitted the final chunk of a carried record
            r->carry_seq.clear();
            r->carry_qual.clear();
            r->carry_off = 0;
        }
        int need = (int)name.size() + 1;
        if (names_used + need <= names_cap) {
            std::memcpy(names + names_used, name.c_str(), need);
            names_used += need;
        } else if (names_used < names_cap) {
            names[names_used++] = '\0';
        }
        ++n;
    }
    return n;
}

}  // extern "C"
