// Exact ksw2 ksw_extz global alignment (affine gaps, N scores 0) for a batch
// of (target, query) pairs, with the traceback, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel kevlar_tpu/ops/align_pallas.py
// (_kernel_factory.kernel, launched by _align_pallas_batch, plus the jitted
// traceback _traceback_packed) and its XLA twin kevlar_tpu/ops/align_ops.py
// (_align_wavefront_batch, _traceback_batch).  Same cell arithmetic,
// tie-breaks, boundary values and direction codes; the plain PyTorch version
// of both kernels is kevlar_tpu_torch/ops/align_cuda.py::ksw_extz_plain.
//
// What bounds it on the card.  A cell is ~30 integer operations and one
// direction byte that the traceback reads back; a call-stage batch is a few
// hundred million cells, so the floor is the rate of the integer pipe (16
// lanes a scheduler on Hopper: a warp's integer instruction takes two
// cycles), a millisecond-scale floor, and the bytes are a smaller floor
// still.  What a kernel loses on top of that is (a) the cell's operands, if
// they travel through shared memory behind a block-wide barrier per
// anti-diagonal, (b) the direction bytes, if neighbouring threads write
// them a row apart (one sector per byte), and (c) the traceback, a chain
// of dependent one-byte loads from device memory.
//
// What the design does about it.
//  * DP: one warp per pair, state in registers, no barrier.  Lane l owns a
//    strip of C consecutive query columns (C = 4..32, a multiple of 4 taken
//    from the pair's qlen so that 32 strips just cover it; a query wider
//    than 32 * 32 takes passes of 1,024 columns).  It keeps H(i-1, .) - gapoe
//    and E(i-1, .) - gape of its strip in registers and at step s computes
//    row i = s - l of the strip, left to right.  What crosses the strip's
//    left edge, H(i, j0-1) - gapoe and F(i, j0-1) - gape, is what lane l-1
//    produced one step earlier: two __shfl_up_sync a step; H(i-1, j0-1) is
//    the value received the step before.  A pass takes tlen + 31 steps.
//    The right edge of a pass is parked per row (shared memory, or device
//    memory for very long targets) and read by lane 0 of the next pass.
//  * The matrix is extended by a virtual row -1 and column -1 (H = the gap
//    ramp, E = F = -inf), which give ksw2's boundary values at row 0 and
//    column 0 with no special case in the cell.
//  * Fewer instructions a cell: the state is kept as H - gapoe and E, F -
//    gape (each subtraction done once, where the value is made), and the
//    substitution scores of four columns come from one byte permute of a
//    per-row table (scores that do not fit a byte take a comparing cell).
//  * One block is one warp, so a pair that ends frees its registers at
//    once and the hardware balances pairs of different sizes; the wrapper
//    orders a batch longest target first.
//  * Direction codes stay one byte a cell, but in the kernel's own layout
//    (align_cuda.z_word_index is its definition): per pass, word (s, w, l)
//    holds the codes of columns 4w..4w+3 of lane l's strip at step s, at
//    word index (s * C/4 + w) * 32 + l.  A warp's store is 128 consecutive
//    bytes, four full sectors.
//  * Traceback: a second kernel, one warp per pair.  The warp loads a tile
//    of 8 rows x 4 words (16 columns) behind the walk's cell in one
//    request, one word a lane, and all lanes walk it together, fetching
//    each cell's word with a shuffle; a tile serves 8 steps or more of the
//    dependent chain.  Op codes are gathered 32 at a time and stored
//    coalesced.  Only the op stream and the exit cells leave the card.
//  * Each pair loops over its own lengths: no power-of-two padding of T, Q
//    or the batch, and no 512 cap (both were TPU compile and VMEM
//    constraints).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTbThreads = 128;
// Resident DP warps (one-warp blocks) an SM the compiler must leave
// registers for: 65,536 / (32 * kDpMinBlocks) registers a thread.  The DP
// is bound by the instruction rate, not by latency: 10, 12, 16 and 20 (with
// spills from 10 on) measured no faster than 8.
constexpr int kDpMinBlocks = 8;
constexpr int kTileRows = 8;      // traceback tile: rows x words = 32 lanes
constexpr int kTileWords = 4;

// Columns a lane's strip holds for a query of qlen bases: the least
// multiple of 4 with which 32 strips cover the query, at most 32
// (align_cuda.strip_width).
__host__ __device__ __forceinline__ int strip_width(int qlen) {
    int c = 4 * ((qlen + 127) / 128);
    return c < 4 ? 4 : (c > 32 ? 32 : c);
}

// The DP of one pair by one warp, strips of C columns.  `edge` holds two
// int32 per target row (H - gapoe and F - gape at a pass's last column),
// used only when the query takes more than one pass.  LUT: the three
// substitution scores (with gapoe folded in) fit a byte each, so a row's
// scores against A, C, G, T and N sit in two registers and one byte
// permute looks up four columns' scores at once; otherwise each cell
// compares its codes.
template <int C, bool LUT>
__device__ __forceinline__ int dp_pair(
        const uint8_t* __restrict__ t, int tlen,
        const uint8_t* __restrict__ q, int qlen, uint32_t* __restrict__ zp,
        int32_t* edge, int a, int b, int gapoe, int gape)
{
    constexpr int W = C / 4;
    const int lane = threadIdx.x & 31;
    const int npass = (qlen + 32 * C - 1) / (32 * C);
    const int nsteps = tlen + 31;
    // substitution scores with gapoe folded in: the state holds H - gapoe
    const int sa = a + gapoe, sb = b + gapoe, sn = gapoe;
    int32_t* edge_h = edge;
    int32_t* edge_f = edge + tlen;
    int score = kNegInf;

    for (int p = 0; p < npass; ++p) {
        const int j0 = (p * 32 + lane) * C;
        const bool live = j0 < qlen;
        const bool park = p + 1 < npass;
        // the strip's query codes, four columns a word: a byte each, or
        // (LUT) a nibble each, which is the permute's selector
        uint32_t qw[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
            uint32_t word = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int j = j0 + 4 * w + k;
                uint32_t c = j < qlen ? q[j] : 4u;
                word |= (c < 4u ? c : 4u) << ((LUT ? 4 : 8) * k);
            }
            qw[w] = word;
        }
        // row -1: H is the gap ramp, E is -inf
        int hh[C], e1[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            hh[c] = -(gapoe + gape * (j0 + c)) - gapoe;
            e1[c] = kNegInf;
        }
        int diag = (j0 == 0 ? 0 : -(gapoe + gape * (j0 - 1))) - gapoe;
        int hh_out = 0, f1_out = 0;
        uint32_t* zpass = zp + (size_t)p * nsteps * (W * 32);
        int tnext = (live && lane == 0) ? t[0] : 0;

        for (int s = 0; s < nsteps; ++s) {
            const int i = s - lane;
            int hl = __shfl_up_sync(kFull, hh_out, 1);
            int fl = __shfl_up_sync(kFull, f1_out, 1);
            const bool valid = live && i >= 0 && i < tlen;
            if (lane == 0 && valid) {
                if (p == 0) {            // column -1: the ramp, F is -inf
                    hl = -(gapoe + gape * i) - gapoe;
                    fl = kNegInf;
                } else {
                    hl = edge_h[i];
                    fl = edge_f[i];
                }
            }
            int tc = tnext;
            if (live && i + 1 >= 0 && i + 1 < tlen) tnext = t[i + 1];
            if (valid) {
                // LUT: byte k = this row's score against query code k
                const uint32_t lut = tc >= 4 ? sn * 0x01010101u
                    : (sb * 0x01010101u & ~(0xffu << (8 * tc))) |
                      ((uint32_t)sa << (8 * tc));
                uint32_t subs = 0;
                tc = tc >= 4 ? 8 : tc;   // never equal to a query code
                int hd = diag;           // H(i-1, j-1) - gapoe
                diag = hl;
                int hleft = hl, f1 = fl;
                uint32_t word = 0;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    int sub;
                    if (LUT) {
                        if (c % 4 == 0) subs = __byte_perm(lut, sn, qw[c / 4]);
                        sub = (subs >> (8 * (c % 4))) & 0xff;
                    } else {
                        const int qc = (qw[c / 4] >> (8 * (c % 4))) & 0xff;
                        const int x = tc ^ qc;
                        sub = x == 0 ? sa : (x < 4 ? sb : sn);
                    }
                    const int hdiag = hd + sub;
                    const int up = hh[c];
                    const int e = max(e1[c], up);
                    const int f = max(f1, hleft);
                    // ties: the diagonal wins against E, H keeps its value
                    // against F
                    int code = hdiag >= e ? 0 : 1;
                    int h = max(hdiag, e);
                    code = h >= f ? code : 2;
                    h = max(h, f);
                    const int hcur = h - gapoe;
                    const int en = e - gape, fn = f - gape;
                    // continuation bits need a strict '>'
                    code |= en > hcur ? 8 : 0;
                    code |= fn > hcur ? 16 : 0;
                    word |= (uint32_t)code << (8 * (c % 4));
                    if (c % 4 == 3) {
                        zpass[((size_t)s * W + c / 4) * 32 + lane] = word;
                        word = 0;
                    }
                    hd = up;
                    hh[c] = hcur;
                    e1[c] = en;
                    hleft = hcur;
                    f1 = fn;
                }
                hh_out = hleft;
                f1_out = f1;
                if (lane == 31 && park) {
                    edge_h[i] = hh_out;
                    edge_f[i] = f1_out;
                }
            }
        }
        // the last row's H at column qlen - 1
        if (live && qlen - 1 < j0 + C) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                if (j0 + c == qlen - 1) score = hh[c] + gapoe;
            }
        }
        __syncwarp();
    }
    return score;
}

// One warp (one block) per pair.  Dynamic shared memory: 2 * T int32 of
// edge state when the wrapper asks for it, else `gscratch` (2 * T int32 per
// pair) or nothing (no query of the batch takes a second pass).
__global__ void __launch_bounds__(32, kDpMinBlocks)
ksw_extz_dp(const uint8_t* __restrict__ targets,
            const int32_t* __restrict__ tlens, int T,
            const uint8_t* __restrict__ queries,
            const int32_t* __restrict__ qlens, int Q,
            const int64_t* __restrict__ zoff, uint8_t* __restrict__ z,
            int32_t* __restrict__ scores, int32_t* __restrict__ gscratch,
            int a, int b, int gapoe, int gape)
{
    extern __shared__ int32_t smem[];
    const int pair = blockIdx.x;
    const int tlen = tlens[pair];
    const int qlen = qlens[pair];
    if (tlen <= 0 || qlen <= 0) {
        if (threadIdx.x == 0) scores[pair] = kNegInf;
        return;
    }
    int32_t* edge = gscratch ? gscratch + (int64_t)pair * 2 * T : smem;
    const uint8_t* t = targets + (int64_t)pair * T;
    const uint8_t* q = queries + (int64_t)pair * Q;
    uint32_t* zp = reinterpret_cast<uint32_t*>(z + zoff[pair]);
    // the byte lookup of substitution scores needs them in [0, 255]
    const bool lut = (unsigned)(a + gapoe) < 256u &&
                     (unsigned)(b + gapoe) < 256u && (unsigned)gapoe < 256u;
    int score;
#define KT_DP_CASE(C)                                                       \
    case C:                                                                 \
        score = lut ? dp_pair<C, true>(t, tlen, q, qlen, zp, edge, a, b,    \
                                       gapoe, gape)                         \
                    : dp_pair<C, false>(t, tlen, q, qlen, zp, edge, a, b,   \
                                        gapoe, gape);                       \
        break;
    switch (strip_width(qlen)) {
    KT_DP_CASE(4)
    KT_DP_CASE(8)
    KT_DP_CASE(12)
    KT_DP_CASE(16)
    KT_DP_CASE(20)
    KT_DP_CASE(24)
    KT_DP_CASE(28)
    default:
    KT_DP_CASE(32)
    }
#undef KT_DP_CASE
    // one lane holds the cell (tlen-1, qlen-1); the others hold kNegInf
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        score = max(score, __shfl_xor_sync(kFull, score, d));
    }
    if (threadIdx.x == 0) scores[pair] = score;
}

// Walk the direction codes back from (tlen-1, qlen-1): the state machine of
// align_ops._traceback_batch.  ops_rev[b, step] = 0 M, 1 D, 2 I; 3 after the
// walk leaves the matrix.  exit_i/exit_j are the residual (i, j) for the
// leading gap run.  One warp per pair; every lane carries the same walk.
__global__ void __launch_bounds__(kTbThreads)
ksw_extz_traceback(const int32_t* __restrict__ tlens,
                   const int32_t* __restrict__ qlens,
                   const int64_t* __restrict__ zoff,
                   const uint8_t* __restrict__ z, int B, int S,
                   uint8_t* __restrict__ ops_rev,
                   int32_t* __restrict__ exit_i, int32_t* __restrict__ exit_j)
{
    const int pair = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (pair >= B) return;               // whole warps leave
    const int tlen = tlens[pair];
    const int qlen = qlens[pair];
    uint8_t* ops = ops_rev + (int64_t)pair * S;
    int i = tlen - 1, j = qlen - 1, state = 0, step = 0;
    int myop = 3;                        // op of step (step & ~31) + lane
    if (tlen > 0 && qlen > 0) {
        const int C = strip_width(qlen);
        const int W = C / 4;
        const int pass_words = 8 * C;                 // words a row of a pass
        const size_t pass_size = (size_t)(tlen + 31) * W * 32;
        const uint32_t* zp = reinterpret_cast<const uint32_t*>(
            z + zoff[pair]);
        while (i >= 0 && j >= 0) {
            // lane r: row i0 - r / 4, column word w0 - r % 4
            const int i0 = i, w0 = j >> 2;
            const int ri = i0 - (lane >> 2);
            const int wq = w0 - (lane & 3);
            uint32_t word = 0;
            if (ri >= 0 && wq >= 0) {
                const int p = wq / pass_words;
                const int wl = wq - p * pass_words;
                const int l = wl / W;
                const int cw = wl - l * W;
                word = zp[p * pass_size +
                          ((size_t)(ri + l) * W + cw) * 32 + l];
            }
            // walk inside the tile: r rows above i0, cw words left of w0
            int r = 0, cw = 0, jb = j & 3;
            do {
                const uint32_t cell = __shfl_sync(kFull, word, (r << 2) | cw);
                const int code = (cell >> (8 * jb)) & 0xff;
                // a gap state goes on while its continuation bit is set
                // (state 0 reads bit 2, which no code has)
                if (!((code >> (state + 2)) & 1)) state = code & 7;
                if (lane == (step & 31)) myop = state;
                if ((step & 31) == 31) ops[step - 31 + lane] = (uint8_t)myop;
                ++step;
                const int di = state != 2, dj = state != 1;
                i -= di;
                r += di;
                j -= dj;
                jb -= dj;
                if (jb < 0) {
                    jb = 3;
                    ++cw;
                }
            } while (r < kTileRows && cw < kTileWords && i >= 0 && j >= 0);
        }
    }
    // the ops not yet stored sit in lanes 0 .. (step & 31) - 1
    const int base = step & ~31;
    for (int k = base + lane; k < S; k += 32) {
        ops[k] = k < step ? (uint8_t)myop : (uint8_t)3;
    }
    if (lane == 0) {
        exit_i[pair] = i;
        exit_j[pair] = j;
    }
}

}  // namespace

// Host entry points, bound with ctypes.  All pointers are device pointers;
// the kernels run on `stream` and nothing synchronises.  Each returns
// cudaGetLastError() after its launch (0 on success).

// The DP of B pairs: scores [B] and the direction codes in `z` (each pair's
// region starts at byte zoff[b], a multiple of 128, and holds
// align_cuda.z_bytes(tlen, qlen) bytes).  Edge state of multi-pass queries:
// `smem_bytes` (2 * T int32) of dynamic shared memory per block, or, when
// `gscratch` is not null, B * 2 * T int32 of device memory.
extern "C" int kt_ksw_dp(const void* targets, const void* tlens, int T,
                         const void* queries, const void* qlens, int Q,
                         int B, const void* zoff, void* z, void* scores,
                         void* gscratch, int smem_bytes, int match,
                         int mismatch, int gapopen, int gapextend,
                         void* stream)
{
    if (B == 0) return 0;
    const int b = mismatch < 0 ? mismatch : -mismatch;
    ksw_extz_dp<<<B, 32, gscratch ? 0 : smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(targets),
        static_cast<const int32_t*>(tlens), T,
        static_cast<const uint8_t*>(queries),
        static_cast<const int32_t*>(qlens), Q,
        static_cast<const int64_t*>(zoff), static_cast<uint8_t*>(z),
        static_cast<int32_t*>(scores), static_cast<int32_t*>(gscratch),
        match, b, gapopen + gapextend, gapextend);
    return (int)cudaGetLastError();
}

// The traceback over the codes kt_ksw_dp wrote: ops_rev [B, S] uint8 and
// the exit cells [B].
extern "C" int kt_ksw_traceback(const void* tlens, const void* qlens, int B,
                                const void* zoff, const void* z,
                                void* ops_rev, int S, void* exit_i,
                                void* exit_j, void* stream)
{
    if (B == 0) return 0;
    const int warps = kTbThreads / 32;
    ksw_extz_traceback<<<(B + warps - 1) / warps, kTbThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tlens),
        static_cast<const int32_t*>(qlens),
        static_cast<const int64_t*>(zoff), static_cast<const uint8_t*>(z),
        B, S, static_cast<uint8_t*>(ops_rev),
        static_cast<int32_t*>(exit_i), static_cast<int32_t*>(exit_j));
    return (int)cudaGetLastError();
}

extern "C" const char* kt_cuda_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
