// Native global affine-gap aligner with exact ksw_extz semantics.
//
// A copy of kevlar_tpu/native/align.cpp, equal to it but for comments.
// Implements the identical DP recurrence, initialisation, tie-breaking, and
// backtrack as kevlar_tpu_torch/ops/align.py's numpy wavefront (held
// bit-identical to the reference's compiled ksw2).  The port's single-pair
// host aligner (ops.align.align, native.align); batches of pairs go to the
// CUDA kernel of csrc/align.cu.
//
// C ABI:
//   int kt_align(const char* target, int tlen, const char* query, int qlen,
//                int match, int mismatch, int gapopen, int gapextend,
//                char* cigar_out, int cigar_cap);   // returns score

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int32_t NEG_INF = -0x40000000;

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

int kt_align(const char *target, int tlen, const char *query, int qlen,
             int match, int mismatch, int gapopen, int gapextend,
             char *cigar_out, int cigar_cap) {
    int a = match;
    int b = mismatch < 0 ? mismatch : -mismatch;
    int32_t mat[25];
    for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j)
            mat[i * 5 + j] = (i == 4 || j == 4) ? 0 : (i == j ? a : b);

    std::vector<uint8_t> t(tlen), q(qlen);
    for (int i = 0; i < tlen; ++i) t[i] = g_code[(uint8_t)target[i]];
    for (int j = 0; j < qlen; ++j) q[j] = g_code[(uint8_t)query[j]];

    const int gapoe = gapopen + gapextend;
    const int gape = gapextend;

    std::vector<int32_t> eh_h(qlen + 1), eh_e(qlen + 1);
    eh_h[0] = 0;
    eh_e[0] = -(gapoe + gapoe);
    for (int j = 1; j <= qlen; ++j) {
        eh_h[j] = -(gapoe + gape * (j - 1));
        eh_e[j] = -(gapoe + gapoe + gape * j);
    }

    std::vector<uint8_t> z((size_t)tlen * qlen);
    int32_t score = NEG_INF;
    for (int i = 0; i < tlen; ++i) {
        int32_t h1 = -(gapoe + gape * i);
        int32_t f = -(gapoe + gapoe + gape * i);
        const int32_t *row = &mat[t[i] * 5];
        uint8_t *zi = &z[(size_t)i * qlen];
        for (int j = 0; j < qlen; ++j) {
            int32_t h = eh_h[j];
            int32_t e = eh_e[j];
            eh_h[j] = h1;
            h += row[q[j]];
            uint8_t d = h >= e ? 0 : 1;
            h = h >= e ? h : e;
            d = h >= f ? d : 2;
            h = h >= f ? h : f;
            h1 = h;
            int32_t hh = h - gapoe;
            e -= gape;
            if (e > hh) d |= 0x08;
            e = e > hh ? e : hh;
            eh_e[j] = e;
            f -= gape;
            if (f > hh) d |= 0x10;
            f = f > hh ? f : hh;
            zi[j] = d;
        }
        eh_h[qlen] = h1;
        eh_e[qlen] = NEG_INF;
    }
    score = eh_h[qlen];

    // backtrack (ksw2 semantics; ops "MID")
    struct Op { char op; int len; };
    std::vector<Op> cigar;
    auto push = [&cigar](char op, int len) {
        if (!cigar.empty() && cigar.back().op == op) cigar.back().len += len;
        else cigar.push_back({op, len});
    };
    int i = tlen - 1, j = qlen - 1, state = 0;
    while (i >= 0 && j >= 0) {
        int tmp = z[(size_t)i * qlen + j];
        if (state == 0) state = tmp & 7;
        else if (!((tmp >> (state + 2)) & 1)) state = 0;
        if (state == 0) state = tmp & 7;
        if (state == 0) { push('M', 1); --i; --j; }
        else if (state == 1) { push('D', 1); --i; }
        else { push('I', 1); --j; }
    }
    if (i >= 0) push('D', i + 1);
    if (j >= 0) push('I', j + 1);

    int pos = 0;
    for (auto it = cigar.rbegin(); it != cigar.rend(); ++it) {
        int wrote = snprintf(cigar_out + pos, cigar_cap - pos, "%d%c",
                             it->len, it->op);
        if (wrote < 0 || pos + wrote >= cigar_cap) break;
        pos += wrote;
    }
    cigar_out[pos < cigar_cap ? pos : cigar_cap - 1] = '\0';
    return score;
}

}  // extern "C"
