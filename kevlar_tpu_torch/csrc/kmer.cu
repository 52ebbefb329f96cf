// Count-Min sketch kernels for Hopper (sm_90a): k-mer hashing (K1), the
// min-over-tables count gather (K2), the scatter-add into the consume's
// accumulator (K3: kt_consume from hashes, kt_scatter_add from indices) and
// the routing of bucket indices to the shards that own them (kt_route).
//
// K1 kt_kmer_hashes replaces the XLA program of
//   kevlar_tpu/ops/hashing.py :: kmer_codes + hash_pair
//   (jitted inside sketch_ops.consume_batch_stack and
//   novel_ops.novel_screen_compact_stack, the unpacked-wire route).
//   Input: the reader's base codes, one byte a base (0-3, >= 4 invalid).
//   A block stages a tile of whole rows in shared memory with 16-byte
//   loads; each thread takes a run of kRun consecutive windows of one row,
//   builds the first in k steps and rolls the others in O(1): both strands'
//   codes are sums in the ring of integers mod 2^32, so the update
//   "multiply, add the incoming digit, subtract the outgoing one" gives the
//   numbers of the window-by-window definition at every window, valid or
//   not.  A warp's runs are consecutive in the flat [N, P] output, so it
//   stages its results in shared memory and writes them out coalesced.
//   Bound by bytes: N*L read, 9 bytes a window written.
// K2 kt_gather_counts replaces
//   kevlar_tpu/ops/sketch_ops.py :: gather_counts and gather_counts_multi
//   (B4).  One launch serves up to kMaxSamples sketches (each as it lies in
//   memory: no interleaved copy): a thread reads its (h1, h2) once,
//   computes all S x T bucket indices (x mod tablesize by a multiply-high
//   with a host-made reciprocal, no division), starts all S x T byte loads
//   through the read-only path without allocating in L1, and only then
//   takes the minima.  Bound by bytes: a random byte of a table far larger
//   than L2 costs its 32-byte DRAM sector.  A sketch may hold one range
//   [lo, lo + span) of a hash space of `tablesize` buckets (a shard of a
//   ShardedSketch): a bucket outside it reads 255, so that a minimum over
//   the shards picks the owner's count (kevlar_tpu/parallel/sharded.py ::
//   _local_gather); the whole space is lo = 0, span = tablesize.
// K3 kt_consume and kt_scatter_add replace
//   tools/scatter_probe.py :: pallas_scatter_add (B10, the pl.pallas_call at
//   :76), the core of sketch_ops._scatter_hashes_i32, and kt_consume also
//   the XLA glue around it in sketch_ops.consume_batch_stack (validity, band
//   and mask predicates, the per-table bucket indices).
//   The TPU kernel walked the index stream sequentially against a
//   VMEM-resident table; here every update is an independent 32-bit atomic
//   add, and integer adds commute, so the result is exact in any order.
//   What bounds it: the accumulator (2 GB for a 500 MB sketch) is far
//   beyond L2, so each kept update is a read-modify-write of a random
//   32-byte sector, and the card's rate of those is the wall; a bound by
//   bytes (a sector in, a sector out at the streaming rate) is ~3x below
//   what random sectors cost.  What the design does about it: nothing is
//   spent around the atomics.  kt_consume reads K1's h1, h2 and valid (and
//   K2's mask counts) four k-mers a thread with 16-byte loads, decides
//   keep in registers (valid, band, mask), reduces with mod_by (no
//   division) and sends all of a kept k-mer's adds back to back as
//   fire-and-forget reductions (RED, no return value), so that they are
//   in flight together: no index tensor, no 64-bit arithmetic, one launch.
//   Two more modes of the same kernel, for callers other than the count:
//   with a counter it also adds the number of k-mers it kept to a device
//   int64 (a block sum, one atomic a block), so that a caller who wants that
//   number need not apply the predicates again; in mark mode the target is
//   a table of 8-bit counters and a kept k-mer stores 1 at its buckets (a
//   presence sketch: plain byte stores of one value, no atomics), where it
//   can be read by K2 at once, with no accumulator to unpack and pack.
//   kt_scatter_add takes given indices (what B10 computes): a 2-D grid
//   gives the table from blockIdx.y, without a division.  kt_consume also
//   takes a bucket range, as K2 does: the accumulator then holds the
//   buckets [lo, lo + span) of a hash space of `total` (a shard's), and a
//   kept k-mer adds only where its bucket falls inside (the replicate
//   consume of kevlar_tpu/parallel/sharded.py :: _local_consume).
// kt_route replaces the binning half of
//   kevlar_tpu/parallel/sharded.py :: _route_consume (an XLA program: a
//   one-hot block cumsum over [T, K, S] ranks every k-mer's slot in its
//   owner's bin).  It writes each kept k-mer's local bucket index
//   (bucket mod shard_size) into bin (table, owner shard) of a [T, S, C]
//   send buffer the wrapper fills with the sentinel shard_size, and counts
//   every bin's population, slots beyond C included (the overflow test).
//   Only T x S counters take every k-mer's slot, so a global atomic a
//   k-mer would queue on a few L2 addresses: a block counts its k-mers
//   into shared-memory bins first, reserves each bin's range with one
//   global atomic, then writes.  The order of the slots inside a bin is
//   not JAX's (the shared atomics hand them out in no set order); the
//   owner's adds commute, so the counts are the same.  Bound by bytes: 9
//   bytes a k-mer read, the send buffer written.
//
// Plain C entry points (bound with ctypes): each launches on the given
// stream and returns the cudaError_t of the launch (0 = success); no entry
// point allocates or synchronises.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr uint32_t kGolden1 = 0x3c6ef372u;
constexpr uint32_t kGolden2 = 0x9e3779b9u;
constexpr uint32_t kPolyM1 = 0x9E3779B1u;
constexpr uint32_t kPolyM2 = 0x85EBCA77u;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85ebca6bu;
    h ^= h >> 13;
    h *= 0xc2b2ae35u;
    h ^= h >> 16;
    return h;
}

// ------------------------------------------------------------------- K1

constexpr int kRun = 16;                   // windows a thread rolls through
constexpr int kWarps = kThreads / 32;
// a warp's staged windows, padded one word a run against bank conflicts
constexpr int kStage = 32 * kRun + 32;
constexpr int kStageBytes = kStage * 9;    // h1, h2 (4 bytes each), valid
static_assert(kStageBytes % 16 == 0, "stages keep 16-byte alignment");

__device__ __forceinline__ int stage_slot(int i) { return i + i / kRun; }

// Constants of the rolling update, made by the host from k (see
// kmer_cuda.roll_constants): for k <= 32 the weights of the digits that
// leave the two forward halves (0 where the weight is 4^16 = 2^32); for
// k > 32 the k-th and (k-1)-th powers and the inverses of the two odd
// polynomial multipliers, all mod 2^32.
struct RollConstants {
    uint32_t out_hi, out_lo;
    uint32_t m1k, m2k, m1km1, m2km1, m1inv, m2inv;
};

// Both strands' codes of the window starting at s[0], then rolled along.
template <bool POLY>
struct Roller {
    uint32_t f_lo = 0, f_hi = 0;     // forward strand
    uint32_t r_lo = 0, r_hi = 0;     // reverse strand (POLY)
    uint64_t r = 0;                  // reverse strand, 2 bits a base (!POLY)
    int last_bad = -1;               // position of the last invalid base

    __device__ __forceinline__ void build(const uint8_t *s, int k,
                                          int hi_len) {
        uint32_t pw1 = 1u, pw2 = 1u;
        for (int i = 0; i < k; ++i) {
            uint32_t w = s[i];
            uint32_t c = 3u - (w < 3u ? w : 3u);
            if (w >= 4u) last_bad = i;
            if (POLY) {
                f_lo = f_lo * kPolyM1 + w;
                f_hi = f_hi * kPolyM2 + w;
                r_lo += c * pw1;
                r_hi += c * pw2;
                pw1 *= kPolyM1;
                pw2 *= kPolyM2;
            } else {
                if (i < hi_len) {
                    f_hi = (f_hi << 2) + w;
                } else {
                    f_lo = (f_lo << 2) + w;
                }
                r |= (uint64_t)c << (2 * i);
            }
        }
    }

    // from the window at s[j - 1] to the one at s[j]
    __device__ __forceinline__ void roll(const uint8_t *s, int j, int k,
                                         int hi_len,
                                         const RollConstants &rc) {
        uint32_t w_out = s[j - 1];
        uint32_t w_in = s[j + k - 1];
        uint32_t c_in = 3u - (w_in < 3u ? w_in : 3u);
        if (w_in >= 4u) last_bad = j + k - 1;
        if (POLY) {
            uint32_t c_out = 3u - (w_out < 3u ? w_out : 3u);
            f_lo = f_lo * kPolyM1 + w_in - w_out * rc.m1k;
            f_hi = f_hi * kPolyM2 + w_in - w_out * rc.m2k;
            r_lo = (r_lo - c_out) * rc.m1inv + c_in * rc.m1km1;
            r_hi = (r_hi - c_out) * rc.m2inv + c_in * rc.m2km1;
        } else {
            // the digit at hi_len moves from the low half to the high one
            uint32_t w_mid = s[j - 1 + hi_len];
            f_hi = (f_hi << 2) + w_mid - w_out * rc.out_hi;
            f_lo = (f_lo << 2) + w_in - w_mid * rc.out_lo;
            r = (r >> 2) | ((uint64_t)c_in << (2 * (k - 1)));
        }
    }

    __device__ __forceinline__ void emit(int j, uint32_t *h1, uint32_t *h2,
                                         uint8_t *valid) {
        // !POLY: 16 bases fill the low word; a shorter k leaves the high 0
        uint32_t rl = POLY ? r_lo : (uint32_t)r;
        uint32_t rh = POLY ? r_hi : (uint32_t)(r >> 32);
        bool use_f = (f_hi < rh) || (f_hi == rh && f_lo <= rl);
        uint32_t c_hi = use_f ? f_hi : rh;
        uint32_t c_lo = use_f ? f_lo : rl;
        *h1 = fmix32(c_lo ^ fmix32(c_hi ^ kGolden1));
        *h2 = fmix32(c_hi ^ fmix32(c_lo ^ kGolden2)) | 1u;
        *valid = last_bad < j ? 1 : 0;
    }
};

// rows_per_block rows a block; runs_per_row = ceil(P / kRun) runs a row.
// Dynamic shared memory: the tile's codes (at the global address's offset
// within 16 bytes, so that 16-byte loads line up), then a stage per warp.
template <bool POLY>
__global__ void kmer_hashes_kernel(const uint8_t *__restrict__ codes,
                                   int64_t nrows, int L, int P, int k,
                                   int rows_per_block, int runs_per_row,
                                   int code_bytes, RollConstants rc,
                                   int32_t *__restrict__ h1_out,
                                   int32_t *__restrict__ h2_out,
                                   uint8_t *__restrict__ valid_out) {
    extern __shared__ uint4 smem[];
    uint8_t *s_codes = reinterpret_cast<uint8_t *>(smem);
    const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
    const int nr = (int)(nrows - row0 < rows_per_block ? nrows - row0
                                                       : rows_per_block);
    const uint8_t *g = codes + row0 * L;
    const int lead = (int)(reinterpret_cast<uintptr_t>(g) & 15);
    const int nbytes = nr * L;
    const uint8_t *ga = g - lead;
    const int nchunks = (lead + nbytes + 15) / 16;
    for (int c = threadIdx.x; c < nchunks; c += blockDim.x) {
        int b0 = c * 16;
        if (b0 >= lead && b0 + 16 <= lead + nbytes) {
            smem[c] = __ldg(reinterpret_cast<const uint4 *>(ga) + c);
        } else {
            for (int b = b0; b < b0 + 16; ++b) {
                if (b >= lead && b < lead + nbytes) s_codes[b] = ga[b];
            }
        }
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    uint8_t *stage = s_codes + code_bytes + warp * kStageBytes;
    uint32_t *s_h1 = reinterpret_cast<uint32_t *>(stage);
    uint32_t *s_h2 = s_h1 + kStage;
    uint8_t *s_valid = reinterpret_cast<uint8_t *>(s_h2 + kStage);
    const int hi_len = k > 16 ? k - 16 : 0;
    const int total_runs = nr * runs_per_row;
    const int64_t flat0 = row0 * P;

    for (int base = warp * 32; base < total_runs; base += kWarps * 32) {
        // the warp's runs base .. base+31 cover one contiguous range of
        // the tile's flat windows, [first, first + count)
        int brow = base / runs_per_row;
        int first = brow * P + (base - brow * runs_per_row) * kRun;
        int last_run = base + 31 < total_runs ? base + 31 : total_runs - 1;
        int lrow = last_run / runs_per_row;
        int lp = (last_run - lrow * runs_per_row) * kRun;
        int count = lrow * P + (lp + kRun < P ? lp + kRun : P) - first;

        int run = base + lane;
        if (run < total_runs) {
            int row = run / runs_per_row;
            int p0 = (run - row * runs_per_row) * kRun;
            int nw = P - p0 < kRun ? P - p0 : kRun;
            int off = row * P + p0 - first;
            const uint8_t *s = s_codes + lead + row * L + p0;
            Roller<POLY> roller;
            roller.build(s, k, hi_len);
            for (int j = 0; j < nw; ++j) {
                if (j) roller.roll(s, j, k, hi_len, rc);
                int slot = stage_slot(off + j);
                roller.emit(j, s_h1 + slot, s_h2 + slot, s_valid + slot);
            }
        }
        __syncwarp();
        for (int i = lane; i < count; i += 32) {
            int slot = stage_slot(i);
            int64_t o = flat0 + first + i;
            h1_out[o] = (int32_t)s_h1[slot];
            h2_out[o] = (int32_t)s_h2[slot];
            valid_out[o] = s_valid[slot];
        }
        __syncwarp();
    }
}

// ------------------------------------------------------------------- K2

constexpr int kMaxSamples = 8;

// One sketch: its tables as they lie in memory, and the reciprocal
// floor(2^32 / tablesize) (2^32 - 1 for tablesize 1) that mod_by() needs.
// The rows hold the buckets [lo, lo + span) of the hash space; others read
// 255.
struct GatherSample {
    const uint8_t *tables;
    int64_t width;          // bytes per table row
    uint32_t tablesize;     // buckets of the hash space, in [1, 2^31)
    uint32_t magic;
    uint32_t lo, span;      // the buckets the rows hold
    int32_t ntables;
    int32_t bits;           // 1, 4 or 8 per counter
};

struct GatherArgs {
    GatherSample s[kMaxSamples];
};

// x mod d without a division, exact for every x and every d in [1, 2^31):
// with m = floor(2^32 / d), q = umulhi(x, m) is floor(x / d) or one less
// (x * (2^32/d - m) / 2^32 < 1), so x - q*d lies in [0, 2d), which 32 bits
// hold, and one conditional subtraction finishes.
__device__ __forceinline__ uint32_t mod_by(uint32_t x, uint32_t d,
                                           uint32_t m) {
    uint32_t r = x - __umulhi(x, m) * d;
    return r >= d ? r - d : r;
}

// A byte through the read-only path, not kept in L1: a 500 MB table has no
// reuse there.
__device__ __forceinline__ uint32_t load_streamed(const uint8_t *p) {
    uint32_t v;
    asm("ld.global.nc.L1::no_allocate.u8 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

// counter `idx` out of its byte, at `bits` per counter, LSB first
__device__ __forceinline__ uint32_t counter_of(uint32_t byte, uint32_t idx,
                                               int bits) {
    int lg = bits == 8 ? 0 : (bits == 4 ? 1 : 3);   // log2(counters a byte)
    return (byte >> ((idx & ((1u << lg) - 1u)) * bits)) & ((1u << bits) - 1u);
}

__device__ __forceinline__ uint32_t byte_of(uint32_t idx, int bits) {
    return idx >> (bits == 8 ? 0 : (bits == 4 ? 1 : 3));
}

// S samples (the first `nsamples` of them live) of T tables each; BITS is
// the counter width of all of them, or 0 when the samples' widths differ.
// All indices first (local to the sample's range: one below lo wraps to a
// large unsigned number, outside the range like one past its end), then
// the loads of the buckets in range, then the minima.
template <int S, int T, int BITS>
__global__ void gather_counts_kernel(const __grid_constant__ GatherArgs args,
                                     int nsamples,
                                     const int32_t *__restrict__ h1,
                                     const int32_t *__restrict__ h2,
                                     int64_t n, uint8_t *__restrict__ out) {
    int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n) return;
    uint32_t a = (uint32_t)h1[g];
    uint32_t b = (uint32_t)h2[g];
    uint32_t idx[S][T], byte[S][T];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        if (s < nsamples) {
#pragma unroll
            for (int t = 0; t < T; ++t) {
                idx[s][t] = mod_by(a + (uint32_t)t * b, args.s[s].tablesize,
                                   args.s[s].magic) - args.s[s].lo;
            }
        }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
        if (s < nsamples) {
            int bits = BITS ? BITS : args.s[s].bits;
#pragma unroll
            for (int t = 0; t < T; ++t) {
                byte[s][t] = idx[s][t] < args.s[s].span
                    ? load_streamed(args.s[s].tables + t * args.s[s].width +
                                    byte_of(idx[s][t], bits))
                    : 0u;
            }
        }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
        if (s < nsamples) {
            int bits = BITS ? BITS : args.s[s].bits;
            uint32_t m = 255u;
#pragma unroll
            for (int t = 0; t < T; ++t) {
                uint32_t c = idx[s][t] < args.s[s].span
                    ? counter_of(byte[s][t], idx[s][t], bits) : 255u;
                m = c < m ? c : m;
            }
            out[(int64_t)s * n + g] = (uint8_t)m;
        }
    }
}

// Any table count per sample: the loops run as the data says.
__global__ void gather_counts_any_kernel(
        const __grid_constant__ GatherArgs args, int nsamples,
        const int32_t *__restrict__ h1, const int32_t *__restrict__ h2,
        int64_t n, uint8_t *__restrict__ out) {
    int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n) return;
    uint32_t a = (uint32_t)h1[g];
    uint32_t b = (uint32_t)h2[g];
    for (int s = 0; s < nsamples; ++s) {
        const GatherSample &sm = args.s[s];
        uint32_t m = 255u;
        for (int t = 0; t < sm.ntables; ++t) {
            uint32_t idx = mod_by(a + (uint32_t)t * b, sm.tablesize,
                                  sm.magic) - sm.lo;
            if (idx >= sm.span) continue;
            uint32_t c = counter_of(
                load_streamed(sm.tables + t * sm.width +
                              byte_of(idx, sm.bits)), idx, sm.bits);
            m = c < m ? c : m;
        }
        out[(int64_t)s * n + g] = (uint8_t)m;
    }
}

// ------------------------------------------------------------------- K3

// acc[t, idx[t, n]] += 1 where 0 <= idx < C; the table is blockIdx.y.
__global__ void scatter_add_kernel(int32_t *__restrict__ acc, int64_t C,
                                   const int32_t *__restrict__ idx,
                                   int64_t n) {
    int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n) return;
    int64_t t = blockIdx.y;
    int32_t j = idx[t * n + g];
    if (j < 0 || j >= C) return;
    atomicAdd(acc + t * C + j, 1);       // result unused: a RED
}

// what a kept k-mer does, and whether the kept k-mers are counted
constexpr int kAdd = 0, kAddCount = 1, kMark = 2;

struct ConsumeArgs {
    int32_t *acc;             // [ntables, span]; uint8 in mark mode
    unsigned long long *nkept;  // the kept k-mers' count, kAddCount only
    const int32_t *h1, *h2;   // [n], uint32 bits
    const uint8_t *valid;     // [n]
    const uint8_t *mcnt;      // [n] mask counts, or null
    int64_t n;
    uint32_t total, magic;    // buckets of the hash space, mod_by's magic
    uint32_t lo, span;        // the buckets acc holds: [lo, lo + span)
    int32_t ntables;
    uint32_t bandmask, band;  // keep where (h1 & bandmask) == band
    int32_t threshold;        // mask: keep mcnt <= threshold,
    int32_t masked;           //       or mcnt >= threshold when masked
};

__device__ __forceinline__ bool consume_keeps(const ConsumeArgs &a,
                                              uint32_t h1, uint32_t valid,
                                              uint32_t mcnt) {
    bool keep = valid != 0 && (h1 & a.bandmask) == a.band;
    if (a.mcnt) {
        keep = keep && (a.masked ? (int)mcnt >= a.threshold
                                 : (int)mcnt <= a.threshold);
    }
    return keep;
}

// One update of a kept k-mer at bucket lo + idx of table t.
template <int MODE>
__device__ __forceinline__ void consume_update(const ConsumeArgs &a, int t,
                                               uint32_t idx) {
    int64_t at = (int64_t)t * a.span + idx;
    if constexpr (MODE == kMark) {
        reinterpret_cast<uint8_t *>(a.acc)[at] = 1;
    } else {
        atomicAdd(a.acc + at, 1);
    }
}

// All of one k-mer's updates, indices first: T > 0 unrolls, T == 0 loops
// over a.ntables.  An index is local to the range (below lo it wraps to a
// large unsigned number); only those inside it update.
template <int T, int MODE>
__device__ __forceinline__ void consume_one(const ConsumeArgs &a,
                                            uint32_t h1, uint32_t h2) {
    if constexpr (T > 0) {
        uint32_t idx[T];
#pragma unroll
        for (int t = 0; t < T; ++t) {
            idx[t] = mod_by(h1 + (uint32_t)t * h2, a.total, a.magic) - a.lo;
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
            if (idx[t] < a.span) consume_update<MODE>(a, t, idx[t]);
        }
    } else {
        for (int t = 0; t < a.ntables; ++t) {
            uint32_t idx =
                mod_by(h1 + (uint32_t)t * h2, a.total, a.magic) - a.lo;
            if (idx < a.span) consume_update<MODE>(a, t, idx);
        }
    }
}

// A thread takes four consecutive k-mers.  VEC: h1/h2 are 16-byte aligned
// and valid/mcnt 4-byte aligned, so a thread's inputs are four loads.
template <int T, bool VEC, int MODE>
__global__ void consume_kernel(const __grid_constant__ ConsumeArgs a) {
    int64_t g = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    if constexpr (MODE != kAddCount) {
        if (g >= a.n) return;
    }  // when counting, every thread of a block reaches the sum below
    uint32_t h1[4], h2[4], valid[4], mcnt[4] = {0, 0, 0, 0};
    if (VEC && g + 4 <= a.n) {
        uint4 x = __ldg(reinterpret_cast<const uint4 *>(a.h1 + g));
        uint4 y = __ldg(reinterpret_cast<const uint4 *>(a.h2 + g));
        uint32_t v = __ldg(reinterpret_cast<const uint32_t *>(a.valid + g));
        uint32_t m = a.mcnt
            ? __ldg(reinterpret_cast<const uint32_t *>(a.mcnt + g)) : 0u;
        h1[0] = x.x; h1[1] = x.y; h1[2] = x.z; h1[3] = x.w;
        h2[0] = y.x; h2[1] = y.y; h2[2] = y.z; h2[3] = y.w;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            valid[k] = (v >> (8 * k)) & 0xffu;
            mcnt[k] = (m >> (8 * k)) & 0xffu;
        }
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            bool in = g + k < a.n;
            h1[k] = in ? (uint32_t)a.h1[g + k] : 0u;
            h2[k] = in ? (uint32_t)a.h2[g + k] : 0u;
            valid[k] = in ? a.valid[g + k] : 0u;
            mcnt[k] = (in && a.mcnt) ? a.mcnt[g + k] : 0u;
        }
    }
    unsigned kept = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (consume_keeps(a, h1[k], valid[k], mcnt[k])) {
            consume_one<T, MODE>(a, h1[k], h2[k]);
            ++kept;
        }
    }
    if constexpr (MODE == kAddCount) {
        // one atomic a block: every block's goes to the same address, where
        // they queue up one behind the other
        __shared__ unsigned warp_kept[kWarps];
        kept = __reduce_add_sync(0xffffffffu, kept);
        if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = kept;
        __syncthreads();
        if (threadIdx.x == 0) {
            unsigned total = 0;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) total += warp_kept[w];
            if (total) atomicAdd(a.nkept, (unsigned long long)total);
        }
    }
}

template <int MODE>
int launch_consume(const ConsumeArgs &a, bool vec, cudaStream_t st) {
    unsigned blocks = (unsigned)(((a.n + 3) / 4 + kThreads - 1) / kThreads);
    if (a.ntables == 4) {
        if (vec) consume_kernel<4, true, MODE><<<blocks, kThreads, 0, st>>>(a);
        else consume_kernel<4, false, MODE><<<blocks, kThreads, 0, st>>>(a);
    } else {
        if (vec) consume_kernel<0, true, MODE><<<blocks, kThreads, 0, st>>>(a);
        else consume_kernel<0, false, MODE><<<blocks, kThreads, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}

// -------------------------------------------------------------- kt_route

constexpr int kRoutePer = 4;          // k-mers a thread
constexpr int kRouteMaxTables = 16;
constexpr int kRouteMaxBins = 4096;   // tables x shards

struct RouteArgs {
    const int32_t *h1, *h2;   // [n], uint32 bits
    const uint8_t *valid;     // [n]
    int64_t n;
    int32_t *send;            // [ntables, nshards, capacity]
    int32_t *pop;             // [ntables, nshards], += each bin's k-mers
    uint32_t total, magic;    // the hash space and mod_by's magic
    uint32_t shard_size, shard_magic;
    int32_t ntables, nshards;
    int64_t capacity;
};

// floor(x / d) and x mod d by the multiply-high of mod_by (m = floor(2^32 /
// d)): the first quotient is exact or one short.
__device__ __forceinline__ uint32_t divmod_by(uint32_t x, uint32_t d,
                                              uint32_t m, uint32_t *rem) {
    uint32_t q = __umulhi(x, m);
    uint32_t r = x - q * d;
    if (r >= d) {
        r -= d;
        ++q;
    }
    *rem = r;
    return q;
}

// A block takes kRoutePer x blockDim.x consecutive k-mers, thread i the
// k-mers i, i + blockDim.x, ... (coalesced loads).  T > 0 unrolls the
// tables; T == 0 loops over a.ntables (at most kRouteMaxTables).
template <int T>
__global__ void route_kernel(const __grid_constant__ RouteArgs a) {
    extern __shared__ unsigned s_bins[];   // counts, then each bin's base
    const int nbins = a.ntables * a.nshards;
    unsigned *s_count = s_bins, *s_base = s_bins + nbins;
    for (int j = threadIdx.x; j < nbins; j += blockDim.x) s_count[j] = 0u;
    __syncthreads();

    constexpr int TT = T > 0 ? T : kRouteMaxTables;
    const int ntab = T > 0 ? T : a.ntables;
    uint32_t bin[kRoutePer][TT], rank[kRoutePer][TT], lidx[kRoutePer][TT];
    const int64_t g0 = (int64_t)blockIdx.x * blockDim.x * kRoutePer +
                       threadIdx.x;
#pragma unroll
    for (int k = 0; k < kRoutePer; ++k) {
        int64_t g = g0 + (int64_t)k * blockDim.x;
        bool keep = g < a.n && __ldg(a.valid + g) != 0;
        uint32_t x = keep ? (uint32_t)__ldg(a.h1 + g) : 0u;
        uint32_t y = keep ? (uint32_t)__ldg(a.h2 + g) : 0u;
#pragma unroll
        for (int t = 0; t < TT; ++t) {
            bin[k][t] = 0xffffffffu;
            if (t < ntab && keep) {
                uint32_t gidx = mod_by(x + (uint32_t)t * y, a.total, a.magic);
                uint32_t owner = divmod_by(gidx, a.shard_size, a.shard_magic,
                                           &lidx[k][t]);
                bin[k][t] = (uint32_t)t * a.nshards + owner;
                rank[k][t] = atomicAdd(s_count + bin[k][t], 1u);
            }
        }
    }
    __syncthreads();
    // one global atomic a bin and block reserves the block's slots
    for (int j = threadIdx.x; j < nbins; j += blockDim.x) {
        unsigned c = s_count[j];
        s_base[j] = c ? atomicAdd(reinterpret_cast<unsigned *>(a.pop) + j, c)
                      : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRoutePer; ++k) {
#pragma unroll
        for (int t = 0; t < TT; ++t) {
            if (bin[k][t] != 0xffffffffu) {
                int64_t slot = (int64_t)s_base[bin[k][t]] + rank[k][t];
                if (slot < a.capacity) {
                    a.send[(int64_t)bin[k][t] * a.capacity + slot] =
                        (int32_t)lidx[k][t];
                }
            }
        }
    }
}

inline unsigned blocks_for(int64_t total) {
    return (unsigned)((total + kThreads - 1) / kThreads);
}

template <int S, int BITS>
int launch_gather(const GatherArgs &args, int nsamples, const int32_t *h1,
                  const int32_t *h2, int64_t n, uint8_t *out,
                  cudaStream_t stream) {
    gather_counts_kernel<S, 4, BITS><<<blocks_for(n), kThreads, 0, stream>>>(
        args, nsamples, h1, h2, n, out);
    return (int)cudaGetLastError();
}

template <int BITS>
int launch_gather_bits(const GatherArgs &args, int nsamples,
                       const int32_t *h1, const int32_t *h2, int64_t n,
                       uint8_t *out, cudaStream_t stream) {
    switch (nsamples) {
    case 1:
        return launch_gather<1, BITS>(args, 1, h1, h2, n, out, stream);
    case 2:
        return launch_gather<2, BITS>(args, 2, h1, h2, n, out, stream);
    case 3:
        return launch_gather<3, BITS>(args, 3, h1, h2, n, out, stream);
    case 4:
        return launch_gather<4, BITS>(args, 4, h1, h2, n, out, stream);
    default:
        return launch_gather<kMaxSamples, BITS>(args, nsamples, h1, h2, n,
                                                out, stream);
    }
}

}  // namespace

extern "C" {

// codes [nrows, L] uint8 -> h1, h2 [nrows, P] int32 (uint32 bits), valid
// [nrows, P] uint8, P = L - k + 1 >= 1.  `rc` points to the 8 uint32 of
// RollConstants.
int kt_kmer_hashes(const void *codes, int64_t nrows, int L, int k,
                   const uint32_t *rc, void *h1, void *h2, void *valid,
                   void *stream) {
    int P = L - k + 1;
    if (nrows == 0) return 0;
    if (P < 1 || k < 1) return (int)cudaErrorInvalidValue;
    int runs_per_row = (P + kRun - 1) / kRun;
    int rows_per_block = kThreads / runs_per_row;
    if (rows_per_block < 1) rows_per_block = 1;
    if ((int64_t)rows_per_block > nrows) rows_per_block = (int)nrows;
    // the tile, up to 15 bytes of lead, rounded up to whole 16-byte chunks
    int code_bytes = (rows_per_block * L + 15 + 15) / 16 * 16;
    size_t smem = (size_t)code_bytes + (size_t)kWarps * kStageBytes;
    RollConstants c = {rc[0], rc[1], rc[2], rc[3], rc[4], rc[5], rc[6],
                       rc[7]};
    unsigned blocks =
        (unsigned)((nrows + rows_per_block - 1) / rows_per_block);
    auto kernel = k > 32 ? kmer_hashes_kernel<true>
                         : kmer_hashes_kernel<false>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t *)codes, nrows, L, P, k, rows_per_block, runs_per_row,
        code_bytes, c, (int32_t *)h1, (int32_t *)h2, (uint8_t *)valid);
    return (int)cudaGetLastError();
}

// `args` points to a GatherArgs on the host, of which the first `nsamples`
// (1 .. kMaxSamples) entries are filled; out is uint8 [nsamples, n].
int kt_gather_counts(const void *args, int nsamples, const void *h1,
                     const void *h2, int64_t n, void *out, void *stream) {
    if (n == 0) return 0;
    if (nsamples < 1 || nsamples > kMaxSamples)
        return (int)cudaErrorInvalidValue;
    const GatherArgs &a = *(const GatherArgs *)args;
    const int32_t *p1 = (const int32_t *)h1, *p2 = (const int32_t *)h2;
    uint8_t *o = (uint8_t *)out;
    cudaStream_t st = (cudaStream_t)stream;
    bool four = true, same = true;
    for (int s = 0; s < nsamples; ++s) {
        four = four && a.s[s].ntables == 4;
        same = same && a.s[s].bits == a.s[0].bits;
    }
    if (!four) {
        gather_counts_any_kernel<<<blocks_for(n), kThreads, 0, st>>>(
            a, nsamples, p1, p2, n, o);
        return (int)cudaGetLastError();
    }
    int bits = same ? a.s[0].bits : 0;
    switch (bits) {
    case 8:
        return launch_gather_bits<8>(a, nsamples, p1, p2, n, o, st);
    case 4:
        return launch_gather_bits<4>(a, nsamples, p1, p2, n, o, st);
    case 1:
        return launch_gather_bits<1>(a, nsamples, p1, p2, n, o, st);
    default:
        return launch_gather_bits<0>(a, nsamples, p1, p2, n, o, st);
    }
}

// acc [ntables, C] int32 += 1 at idx [ntables, n] int32 (indices outside
// [0, C) are skipped).
int kt_scatter_add(void *acc, int64_t C, const void *idx, int64_t ntables,
                   int64_t n, void *stream) {
    if (ntables * n == 0) return 0;
    if (ntables > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(blocks_for(n), (unsigned)ntables);
    scatter_add_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (int32_t *)acc, C, (const int32_t *)idx, n);
    return (int)cudaGetLastError();
}

// The consume of n hashed k-mers into acc [ntables, span] int32, the
// buckets [lo, lo + span) of a hash space of `total`: every k-mer with
// valid != 0, (h1 & bandmask) == band and, where mcnt is not null, mcnt <=
// threshold (or >= threshold with `masked`) adds 1 at bucket (h1 + t * h2)
// mod 2^32 mod total of every table t, where that bucket lies in the
// range (lo = 0, span = total: the whole table).  `magic` is floor(2^32 /
// total) as for kt_gather_counts.  Where `nkept` is not null, the number of
// k-mers kept is added to the int64 it points to on the device.  With
// `mark`, acc is uint8 [ntables, span] and a kept k-mer stores 1 at its
// buckets instead (`nkept` must then be null).
int kt_consume(void *acc, int64_t total, uint32_t magic, int64_t lo,
               int64_t span, int ntables, const void *h1, const void *h2,
               const void *valid, const void *mcnt, int64_t n,
               uint32_t bandmask, uint32_t band, int threshold, int masked,
               int mark, void *nkept, void *stream) {
    if (n == 0 || ntables == 0) return 0;
    if (total < 1 || total >= (int64_t)1 << 31 || lo < 0 ||
        lo >= (int64_t)1 << 31 || span < 1 || span >= (int64_t)1 << 31 ||
        (mark && nkept))
        return (int)cudaErrorInvalidValue;
    ConsumeArgs a;
    a.acc = (int32_t *)acc;
    a.nkept = (unsigned long long *)nkept;
    a.h1 = (const int32_t *)h1;
    a.h2 = (const int32_t *)h2;
    a.valid = (const uint8_t *)valid;
    a.mcnt = (const uint8_t *)mcnt;
    a.n = n;
    a.total = (uint32_t)total;
    a.magic = magic;
    a.lo = (uint32_t)lo;
    a.span = (uint32_t)span;
    a.ntables = ntables;
    a.bandmask = bandmask;
    a.band = band;
    a.threshold = threshold;
    a.masked = masked;
    bool vec = (((uintptr_t)h1 | (uintptr_t)h2) & 15) == 0 &&
               (((uintptr_t)valid | (uintptr_t)mcnt) & 3) == 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (mark) return launch_consume<kMark>(a, vec, st);
    if (nkept) return launch_consume<kAddCount>(a, vec, st);
    return launch_consume<kAdd>(a, vec, st);
}

// Bins n hashed k-mers by owner shard: for every k-mer with valid != 0 and
// every table t, bucket g = (h1 + t * h2) mod 2^32 mod total goes to bin
// (t, g / shard_size) of send [ntables, nshards, capacity] int32, as g mod
// shard_size, where its slot is below `capacity`; pop [ntables, nshards]
// int32 gains each bin's k-mers, slots beyond `capacity` included.  The
// caller fills send with its sentinel and pop with 0; total <= nshards *
// shard_size.  `magic` and `shard_magic` are floor(2^32 / d) of total and
// shard_size, as for kt_gather_counts.
int kt_route(const void *h1, const void *h2, const void *valid, int64_t n,
             int64_t total, uint32_t magic, int64_t shard_size,
             uint32_t shard_magic, int ntables, int nshards,
             int64_t capacity, void *send, void *pop, void *stream) {
    if (n == 0 || ntables == 0) return 0;
    if (total < 1 || total >= (int64_t)1 << 31 || shard_size < 1 ||
        shard_size >= (int64_t)1 << 31 || nshards < 1 ||
        total > (int64_t)nshards * shard_size || capacity < 1 ||
        ntables > kRouteMaxTables || ntables * nshards > kRouteMaxBins)
        return (int)cudaErrorInvalidValue;
    RouteArgs a;
    a.h1 = (const int32_t *)h1;
    a.h2 = (const int32_t *)h2;
    a.valid = (const uint8_t *)valid;
    a.n = n;
    a.send = (int32_t *)send;
    a.pop = (int32_t *)pop;
    a.total = (uint32_t)total;
    a.magic = magic;
    a.shard_size = (uint32_t)shard_size;
    a.shard_magic = shard_magic;
    a.ntables = ntables;
    a.nshards = nshards;
    a.capacity = capacity;
    int64_t per_block = (int64_t)kThreads * kRoutePer;
    unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
    size_t smem = 2 * sizeof(unsigned) * (size_t)(ntables * nshards);
    cudaStream_t st = (cudaStream_t)stream;
    if (ntables == 4) {
        route_kernel<4><<<blocks, kThreads, smem, st>>>(a);
    } else {
        route_kernel<0><<<blocks, kThreads, smem, st>>>(a);
    }
    return (int)cudaGetLastError();
}

const char *kt_kmer_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
