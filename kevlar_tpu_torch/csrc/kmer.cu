// Count-Min sketch kernels for Hopper (sm_90a): k-mer hashing (K1), the
// min-over-tables count gather (K2), the novel screen over packed sample
// words (kt_screen_reads), the scatter-add into the consume's accumulator
// (K3: kt_consume from hashes, kt_scatter_add from indices) and the
// routing of bucket indices to the shards that own them (kt_route).
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
// K2 words, kt_gather_words, replaces
//   kevlar_tpu/ops/sketch_ops.py :: gather_counts_multi over packed words
//   (:105, the screen of novel_ops.count_and_screen_stack_packed).  The
//   samples' 8-bit tables are interleaved four to a uint32 word
//   (pack_sample_tables), so one 4-byte load serves four samples: a thread
//   computes its T bucket indices once, loads one word a word tensor and
//   table, takes the bytewise minimum over the tables (__vminu4) and
//   writes one byte a sample.  Bound by bytes: ceil(S/4) x T random
//   sectors a k-mer against K2's S x T, for a copy of the tables (4 bytes
//   a bucket) made once a screen.
// The screen, kt_screen_reads, replaces the XLA program of
//   kevlar_tpu/ops/novel_ops.py :: novel_screen_compact over packed words
//   (:111: the hashes of :65, the predicates of novel_screen, :43-108, and
//   the fixed-capacity jnp.nonzero), on the novel stage and in
//   count_and_screen_stack_packed: one read batch's codes in, its hits
//   out, in one launch.  Bound by bytes: the codes read once and, for
//   each kept window, ceil(S/4) random word sectors of table 0 and, where
//   no case fails there, ceil(S/4) x (T - 1) more; the hits are rare.
//   What the card pays for is those sectors, at its rate of random
//   sectors, and everything around them is kept off device memory.  A
//   block owns a few whole reads and stages their codes in shared memory
//   with 16-byte loads (as K1); the reads to skip come from there.  Each
//   thread takes a run of consecutive windows of one read and rolls their
//   hashes with K1's Roller (the same code, so the same bits: no h1, h2 or
//   valid goes to device memory); a kept window (valid, in the band, its
//   read not skipped) computes its T bucket indices once, and the loads
//   of a chunk of windows are all in flight before any is used; the
//   bytewise minimum over the tables (__vminu4) is tested four samples a
//   word at once (__vcmpgeu4/__vcmpleu4 against byte masks of the cases
//   and controls).  Without the abundance screen a window whose case count
//   in table 0 is below casemin cannot be a hit, so its other tables are
//   not loaded.  Each hit is placed at its global rank
//   in one pass: the block scans its threads' hit counts in run order and
//   finds its first rank by a decoupled look-back over the earlier blocks
//   in start order (kt_route's route_lookback and ticket); a thread with
//   hits walks its run again and stores them straight to their slots
//   below the capacity, ascending as jnp.nonzero(..., size=max_hits) gives
//   them.  No scratch of hits, no second kernel, no atomic append.  The
//   last block in start order writes the number of hits and fills the
//   slots past them with -1 and 0.  A read's discard (the first case
//   below casemin, in case order, below the abundance screen at a kept
//   window) is a plain store of 1 to shared memory.  256 threads a block,
//   runs of 4 windows (33 runs and 7 reads a block at 130 windows a
//   read: 586 blocks for 4,096 reads), a chunk of 4 windows' loads in
//   flight; a read of more than 1,024 windows gets a block of its own and
//   longer runs.  Runs of 8 windows (chunks of 4 or 8) and a cap of 64
//   registers (4 blocks an SM) were tried on the card: none was faster at
//   both 4,096 and 8,192 reads.
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
//   kt_scatter_add takes given indices (what B10 computes) as segments,
//   each a [T, n] block of int32 indices as it lies in memory (a row
//   stride a segment), passed by value: the whole of a [T, N] index tensor
//   (-1 skips), or the S bins an owner of the routed consume receives,
//   each read only up to its population, where they lie (on one card, in
//   the senders' send buffers: no stacked copy, no sentinel read).  A
//   3-D grid gives the table and the segment without a division; a thread
//   takes one index of its row's filled prefix (eight a thread with
//   16-byte loads measured no faster at phase 5's shape and slower on the
//   received bins) and adds with one RED.  kt_consume also takes a bucket
//   range, as K2 does: the accumulator then holds the buckets [lo, lo +
//   span) of a hash space of `total` (a shard's), and a kept k-mer adds
//   only where its bucket falls inside (the replicate consume of
//   kevlar_tpu/parallel/sharded.py :: _local_consume).
// kt_route replaces the binning half of
//   kevlar_tpu/parallel/sharded.py :: _route_consume (an XLA program: a
//   one-hot block cumsum over [T, K, S] ranks every k-mer's slot in its
//   owner's bin).  It writes each kept k-mer's local bucket index
//   (bucket mod shard_size) into bin (table, owner shard) of a [T, S, C]
//   send buffer, at the slot of its rank in the bin in k-mer order (JAX's
//   order, and route_plain's stable sort's), and counts every bin's
//   population, slots beyond C included (the overflow test); slots past
//   the population are not written (nothing reads them).  A stable
//   partition with no atomic on a slot: each warp takes a run of 256
//   k-mers, 32 a step with coalesced loads, and ranks a step's lanes per
//   owner with one ballot an owner bit and __popc(peers & lanemask_lt);
//   lane s keeps owner s's count, which a k-mer reads by a shuffle.  Up to
//   32 shards it is one launch: a block of 16 warps sums its warps' counts
//   and finds its base in every bin by a decoupled look-back over the
//   earlier blocks, then every k-mer is stored from registers straight to
//   its slot (a warp's k-mers of a bin land in consecutive slots; staging
//   them in shared memory first measured slower).  Beyond 32 shards,
//   __match_any_sync and shared-memory counters, in three launches: count,
//   scan over the warps, write.  Bound by bytes: 9 bytes a k-mer read, the
//   filled slots and the populations written; what holds it is the rate
//   of integer instructions (the bucket, its owner and the ranks, ~40
//   operations a k-mer and table).
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

// ------------------------------------------------------------- K2 words

constexpr int kMaxWords = 4;     // word tensors one launch serves

// Interleaved sample tables (sketch_ops.pack_sample_tables): word tensor w
// is [ntables, tablesize] uint32, and byte j of its word at bucket (t, i)
// is sample 4w + j's 8-bit counter there.
struct WordsArgs {
    const uint32_t *words[kMaxWords];
};

// A word through the read-only path, not kept in L1 (as load_streamed).
__device__ __forceinline__ uint32_t load_word_streamed(const uint32_t *p) {
    uint32_t v;
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

// Sample 4w + j's count is the minimum over the tables of byte j of word
// tensor w's words: the T bucket indices once (every word tensor shares
// them), then all W x T word loads, then per word tensor a bytewise
// minimum over the tables (__vminu4: four samples in one instruction),
// split into its samples' bytes.  W word tensors (the first nwords live);
// T tables, or T = 0 for any table count (the loops then run as the data
// says).
template <int W, int T>
__global__ void gather_words_kernel(const __grid_constant__ WordsArgs args,
                                    int nwords, int nsamples, int ntables,
                                    uint32_t tablesize, uint32_t magic,
                                    const int32_t *__restrict__ h1,
                                    const int32_t *__restrict__ h2,
                                    int64_t n, uint8_t *__restrict__ out) {
    int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n) return;
    uint32_t a = (uint32_t)h1[g];
    uint32_t b = (uint32_t)h2[g];
    uint32_t m[W];
    if constexpr (T > 0) {
        uint32_t idx[T], word[W][T];
#pragma unroll
        for (int t = 0; t < T; ++t)
            idx[t] = mod_by(a + (uint32_t)t * b, tablesize, magic);
#pragma unroll
        for (int w = 0; w < W; ++w) {
            if (w < nwords) {
#pragma unroll
                for (int t = 0; t < T; ++t)
                    word[w][t] = load_word_streamed(
                        args.words[w] + (int64_t)t * tablesize + idx[t]);
            }
        }
#pragma unroll
        for (int w = 0; w < W; ++w) {
            m[w] = word[w][0];
#pragma unroll
            for (int t = 1; t < T; ++t) m[w] = __vminu4(m[w], word[w][t]);
        }
    } else {
#pragma unroll
        for (int w = 0; w < W; ++w) m[w] = 0xffffffffu;
        for (int t = 0; t < ntables; ++t) {
            uint32_t idx = mod_by(a + (uint32_t)t * b, tablesize, magic);
#pragma unroll
            for (int w = 0; w < W; ++w) {
                if (w < nwords) {
                    m[w] = __vminu4(m[w], load_word_streamed(
                        args.words[w] + (int64_t)t * tablesize + idx));
                }
            }
        }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            int s = 4 * w + j;
            if (s < nsamples)
                out[(int64_t)s * n + g] = (uint8_t)(m[w] >> (8 * j));
        }
    }
}

// ------------------------------------------------------------------- K3

constexpr int kMaxSegs = 64;     // segments one scatter launch takes

// A [ntables, n] block of bucket indices as it lies in memory: table t's
// row starts at idx + t * stride.  Where pop is not null the row holds
// only its first min(pop[t * pop_stride], n) indices (a received bin's
// filled prefix); the rest is never added.
struct ScatterSeg {
    const int32_t *idx;
    const int32_t *pop;
    int64_t stride, pop_stride, n;
};

struct ScatterArgs {
    int32_t *acc;             // [ntables, span]
    int64_t span;
    ScatterSeg s[kMaxSegs];
};

// acc[t, j] += 1 for every index j in [0, span) of row t of every segment;
// any other index (-1 by convention) is skipped.  blockIdx.y is the table,
// blockIdx.z the segment; a thread takes one index, inside its row's
// filled prefix only, and adds with a RED (atomicAdd, result unused).
__global__ void scatter_add_kernel(const __grid_constant__ ScatterArgs a) {
    const ScatterSeg &sg = a.s[blockIdx.z];
    const int t = blockIdx.y;
    const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= sg.n) return;
    if (sg.pop && g >= __ldg(sg.pop + t * sg.pop_stride)) return;
    const uint32_t j = (uint32_t)__ldg(sg.idx + t * sg.stride + g);
    if (j < (uint32_t)a.span) atomicAdd(a.acc + t * a.span + j, 1);
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

constexpr int kRouteMaxBins = 4096;        // tables x shards
constexpr int kRouteSteps = 8;             // 32-k-mer steps of a round
constexpr int kRouteRound = 32 * kRouteSteps;
constexpr int kRouteWarps = 16;            // warps a block, at most
constexpr int kRouteLaneShards = 32;       // more shards: __match_any_sync
constexpr int kRouteBinsPerRound = 64;     // a warp takes a round per 64 bins
constexpr int kRouteScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct RouteArgs {
    const int32_t *h1, *h2;   // [n], uint32 bits
    const uint8_t *valid;     // [n]
    int64_t n;
    int32_t *send;            // [ntables, nshards, capacity]
    int32_t *pop;             // [ntables, nshards]
    int32_t *counts;          // [ntables * nshards, nwarps]: each warp's
                              // k-mers in each bin, then (scanned) its base
    unsigned long long *status;   // [nblocks, ntables * nshards], zeroed
    unsigned *ticket;             // the blocks' order of start, zeroed
    int64_t nwarps;           // warps over the k-mers, rounds k-mer runs each
    int32_t rounds;
    uint32_t total, magic;    // the hash space and mod_by's magic
    uint32_t shard_size, shard_magic;
    int32_t ntables, nshards;
    int32_t owner_bits;       // bits of an owner (nshards <= kRouteLaneShards)
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

__device__ __forceinline__ int32_t warp_inclusive_scan(int32_t x) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        int32_t y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += y;
    }
    return x;
}

// One round of a warp's k-mers: lane l holds k-mer base + 32 k + l of
// every step k (each step's loads coalesced, all of them in flight
// together); bit k of `valid` says whether that k-mer is kept.
struct RouteRound {
    uint32_t a[kRouteSteps], b[kRouteSteps];
    uint32_t valid;
};

__device__ __forceinline__ void route_load(const RouteArgs &r, int64_t base,
                                           RouteRound &in) {
    const int lane = threadIdx.x & 31;
    in.valid = 0;
#pragma unroll
    for (int k = 0; k < kRouteSteps; ++k) {
        int64_t g = base + k * 32 + lane;
        bool ok = g < r.n;
        in.a[k] = ok ? (uint32_t)__ldg(r.h1 + g) : 0u;
        in.b[k] = ok ? (uint32_t)__ldg(r.h2 + g) : 0u;
        in.valid |= (ok && __ldg(r.valid + g) != 0) ? 1u << k : 0u;
    }
}

// The owner shard of step k's k-mer in table t (nshards where it is not
// kept) and its bucket local to that shard.
__device__ __forceinline__ uint32_t route_owner(const RouteArgs &r, int t,
                                                const RouteRound &in, int k,
                                                uint32_t *lidx) {
    *lidx = 0;
    if (!((in.valid >> k) & 1u)) return (uint32_t)r.nshards;
    uint32_t g = mod_by(in.a[k] + (uint32_t)t * in.b[k], r.total, r.magic);
    return divmod_by(g, r.shard_size, r.shard_magic, lidx);
}

// Up to kRouteLaneShards shards, lane s keeps the counts of owner s.  One
// ballot an owner bit gives both masks of a step: the lanes whose kept
// k-mer has this lane's owner (`peers`, kept = this step's ballot of the
// kept k-mers) and, for lane s, the lanes whose kept k-mer is owned by s
// (`mine`).
__device__ __forceinline__ void route_ballots(uint32_t owner, unsigned kept,
                                              int bits, unsigned *peers,
                                              unsigned *mine) {
    const unsigned lane = threadIdx.x & 31;
    unsigned p = kept, m = kept;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
        if (i < bits) {             // uniform over the warp
            unsigned b = __ballot_sync(kFull, (owner >> i) & 1u);
            p &= ((owner >> i) & 1u) ? b : ~b;
            m &= ((lane >> i) & 1u) ? b : ~b;
        }
    }
    *peers = p;
    *mine = m;
}

__device__ __forceinline__ void route_kept(const RouteRound &in,
                                           unsigned kept[kRouteSteps]) {
#pragma unroll
    for (int k = 0; k < kRouteSteps; ++k) {
        kept[k] = __ballot_sync(kFull, (in.valid >> k) & 1u);
    }
}

constexpr unsigned long long kFlagCount = 1ull << 32;
constexpr unsigned long long kFlagPrefix = 2ull << 32;

// Block blk's base in a bin, by one warp: publish the block's count, then
// read the earlier blocks' words 32 at a time (lane l the l-th nearest,
// waiting for it to be published) until one holds an inclusive prefix:
// the base is that prefix plus the nearer blocks' counts.  Then publish
// the block's own inclusive prefix.
__device__ __forceinline__ int32_t route_lookback(
        unsigned long long *status, int64_t blk, int nbins, int bin,
        int32_t count) {
    const int lane = threadIdx.x & 31;
    unsigned long long *mine = status + blk * nbins + bin;
    if (blk == 0) {
        if (lane == 0) atomicExch(mine, kFlagPrefix | (uint32_t)count);
        return 0;
    }
    if (lane == 0) atomicExch(mine, kFlagCount | (uint32_t)count);
    int32_t prefix = 0;
    for (int64_t top = blk - 1;; top -= 32) {
        const int64_t p = top - lane;
        unsigned long long v = kFlagPrefix;      // before block 0: prefix 0
        if (p >= 0) {
            const volatile unsigned long long *at = status + p * nbins + bin;
            do {
                v = *at;
            } while ((v >> 32) == 0);
        }
        const unsigned done =
            __ballot_sync(kFull, (v >> 32) == (kFlagPrefix >> 32));
        int32_t x = (int32_t)(uint32_t)v;
        if (done) {
            x = lane <= __ffs(done) - 1 ? x : 0;
            prefix += __reduce_add_sync(kFull, x);
            break;
        }
        prefix += __reduce_add_sync(kFull, x);
    }
    if (lane == 0) {
        atomicExch(mine, kFlagPrefix | (uint32_t)(prefix + count));
    }
    return prefix;
}

// Up to kRouteLaneShards shards, one launch: a block takes 16 warps' runs
// of 256 consecutive k-mers (a block index from a ticket, so that every
// block it waits on has started).  A table at a time, each warp ranks its
// k-mers and keeps, in registers, each k-mer's local bucket and its owner
// with its offset among the warp's k-mers of the bin (lane s counts owner
// s's k-mers: the count so far read by a shuffle, plus the lower peers);
// the block turns the warps' counts into their bases in the block and
// finds its own base in each bin by a decoupled look-back over the earlier
// blocks, a warp a bin, 32 blocks a step (each block publishes its count,
// then its inclusive prefix, as flag and value in one 64-bit word); then
// every k-mer is stored at its slot, a warp's k-mers of a bin in
// consecutive slots.  The last block writes the populations.  A table at
// a time and at most 64 registers keep 2 blocks of 16 warps on an SM,
// whose compute hides each other's look-back.
__global__ void __launch_bounds__(kRouteWarps * 32, 2)
route_lanes_kernel(const __grid_constant__ RouteArgs r) {
    __shared__ int32_t s_warp[kRouteWarps][kRouteLaneShards];
    __shared__ int32_t s_block[kRouteLaneShards];
    __shared__ int64_t s_blk;
    if (threadIdx.x == 0) s_blk = atomicAdd(r.ticket, 1u);
    __syncthreads();
    const int64_t blk = s_blk;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int S = r.nshards, nbins = r.ntables * r.nshards;
    const unsigned lower = (1u << lane) - 1u;
    RouteRound in;
    route_load(r, (blk * kRouteWarps + warp) * kRouteRound, in);
    unsigned kept[kRouteSteps];
    route_kept(in, kept);
    for (int t = 0; t < r.ntables; ++t) {
        uint32_t lidx[kRouteSteps];
        uint32_t at[kRouteSteps];        // owner << 16 | offset in the warp
        int32_t before = 0;              // lane s: owner s's k-mers so far
#pragma unroll
        for (int k = 0; k < kRouteSteps; ++k) {
            uint32_t owner = route_owner(r, t, in, k, &lidx[k]);
            unsigned peers, mine;
            route_ballots(owner, kept[k], r.owner_bits, &peers, &mine);
            at[k] = owner << 16 |
                (uint32_t)(__shfl_sync(kFull, before, owner & 31u) +
                           __popc(peers & lower));
            before += __popc(mine);
        }
        if (lane < S) s_warp[warp][lane] = before;
        __syncthreads();
        for (int s = warp; s < S; s += kRouteWarps) {
            // the warps' counts of owner s: their bases in the block, its sum
            const int32_t c = lane < kRouteWarps ? s_warp[lane][s] : 0;
            const int32_t incl = warp_inclusive_scan(c);
            const int32_t count = __shfl_sync(kFull, incl, 31);
            if (lane < kRouteWarps) s_warp[lane][s] = incl - c;
            const int32_t base = route_lookback(r.status, blk, nbins,
                                                t * S + s, count);
            if (lane == 0) {
                s_block[s] = base;
                if (blk == gridDim.x - 1) r.pop[t * S + s] = base + count;
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kRouteSteps; ++k) {
            const uint32_t owner = at[k] >> 16;
            if (owner < (uint32_t)S) {
                const int64_t slot = (int64_t)s_block[owner] +
                    s_warp[warp][owner] + (at[k] & 0xffffu);
                if (slot < r.capacity) {
                    r.send[(int64_t)(t * S + (int)owner) * r.capacity +
                           slot] = (int32_t)lidx[k];
                }
            }
        }
        __syncthreads();
    }
}

// Beyond kRouteLaneShards shards, three launches.  Pass 1: the lanes of an
// owner find each other with __match_any_sync, and the lowest of them adds
// their number to the warp's shared-memory counter of the bin; the counts
// go to r.counts[bin][warp].
__global__ void route_count_many_kernel(const __grid_constant__ RouteArgs r) {
    extern __shared__ int32_t s_count[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t gw = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
    if (gw >= r.nwarps) return;              // the whole warp
    const int S = r.nshards, nbins = r.ntables * r.nshards;
    int32_t *cnt = s_count + warp * nbins;
    for (int j = lane; j < nbins; j += 32) cnt[j] = 0;
    __syncwarp();
    const unsigned lower = (1u << lane) - 1u;
    for (int q = 0; q < r.rounds; ++q) {
        RouteRound in;
        route_load(r, (gw * r.rounds + q) * kRouteRound, in);
        for (int t = 0; t < r.ntables; ++t) {
#pragma unroll
            for (int k = 0; k < kRouteSteps; ++k) {
                uint32_t lidx;
                uint32_t owner = route_owner(r, t, in, k, &lidx);
                unsigned peers = __match_any_sync(kFull, owner);
                if (owner < (uint32_t)S && !(peers & lower)) {
                    cnt[t * S + owner] += __popc(peers);
                }
                __syncwarp();
            }
        }
    }
    for (int j = lane; j < nbins; j += 32) {
        r.counts[(int64_t)j * r.nwarps + gw] = cnt[j];
    }
}

// Pass 2: a block a bin turns the warps' counts into their exclusive
// prefix sums, in place (the base of each warp's run in the bin), and
// writes the bin's population.
__global__ void route_scan_kernel(int32_t *counts, int64_t nwarps,
                                  int32_t *pop) {
    __shared__ int32_t warp_base[32];
    int32_t *col = counts + (int64_t)blockIdx.x * nwarps;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t per = (nwarps + blockDim.x - 1) / blockDim.x;
    const int64_t lo = threadIdx.x * per;
    const int64_t hi = lo + per < nwarps ? lo + per : nwarps;
    int32_t sum = 0;
    for (int64_t i = lo; i < hi; ++i) sum += col[i];
    int32_t incl = warp_inclusive_scan(sum);
    if (lane == 31) warp_base[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int32_t w = lane < (int)(blockDim.x >> 5) ? warp_base[lane] : 0;
        warp_base[lane] = warp_inclusive_scan(w) - w;
    }
    __syncthreads();
    int32_t run = warp_base[warp] + incl - sum;
    for (int64_t i = lo; i < hi; ++i) {
        int32_t c = col[i];
        col[i] = run;
        run += c;
    }
    if (threadIdx.x == blockDim.x - 1) pop[blockIdx.x] = run;
}

// Pass 3: every warp ranks its run's k-mers again, in k-mer order, and
// stores each at its slot: the warp's base in the bin (pass 2) plus the
// earlier rounds plus its offset, the round's earlier k-mers of the bin (a
// shared-memory counter) and its lower peers.
__global__ void route_write_many_kernel(const __grid_constant__ RouteArgs r) {
    extern __shared__ int32_t s_run[];
    const int nw = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t gw = (int64_t)blockIdx.x * nw + warp;
    if (gw >= r.nwarps) return;              // the whole warp
    const int S = r.nshards, nbins = r.ntables * r.nshards;
    int32_t *run = s_run + warp * nbins;     // the next slot of each bin
    for (int j = lane; j < nbins; j += 32) {
        run[j] = r.counts[(int64_t)j * r.nwarps + gw];
    }
    __syncwarp();
    const unsigned lower = (1u << lane) - 1u;
    for (int q = 0; q < r.rounds; ++q) {
        RouteRound in;
        route_load(r, (gw * r.rounds + q) * kRouteRound, in);
        for (int t = 0; t < r.ntables; ++t) {
#pragma unroll
            for (int k = 0; k < kRouteSteps; ++k) {
                uint32_t lidx;
                uint32_t owner = route_owner(r, t, in, k, &lidx);
                unsigned peers = __match_any_sync(kFull, owner);
                bool kept = owner < (uint32_t)S;
                int64_t slot = kept ? (int64_t)run[t * S + owner] +
                                      __popc(peers & lower) : 0;
                __syncwarp();
                if (kept && !(peers & lower)) {
                    run[t * S + owner] += __popc(peers);
                }
                __syncwarp();
                if (kept && slot < r.capacity) {
                    r.send[(int64_t)(t * S + (int)owner) * r.capacity +
                           slot] = (int32_t)lidx;
                }
            }
        }
    }
}

// ------------------------------------------------------------ the screen

constexpr int kScreenThreads = 256;
constexpr int kScreenWarps = kScreenThreads / 32;
constexpr int kScreenRun = 4;        // windows a thread takes (more: a row
                                     // of more than 256 runs)
constexpr int kScreenChunk = 4;      // windows whose word loads fly together

// One read batch's screen over packed sample words (see kt_screen_reads).
struct ScreenReadsArgs {
    const uint32_t *words[kMaxWords];  // [ntables, tablesize] each
    const uint8_t *codes;       // [nrows, L] base codes, >= 4 invalid
    const int32_t *lengths;     // [nrows]
    int32_t *hit_idx;           // [max_hits]
    uint8_t *hit_ab;            // [nsamples, max_hits]
    int32_t *n_hits;            // one
    uint8_t *discard, *skip;    // [nrows], 0 or 1
    unsigned *ticket;           // the blocks' order of start, zeroed
    unsigned long long *status; // [blocks] look-back words, zeroed
    int64_t nrows;
    int32_t L, P, k;
    int32_t rows, run, runs_per_row, code_bytes;
    int32_t nwords, nsamples, ncase, ntables, max_hits;
    uint32_t tablesize, magic;
    uint32_t bandmask, band;
    uint32_t casemin, ctrlmax;  // each in [0, 255]
    int32_t screen;             // in [0, 255]; -1: no abundance screen
    RollConstants rc;
};

// Bytes [begin, end) of p set to v by the whole block, 16 bytes a store
// between the aligned edges.
__device__ __forceinline__ void fill_bytes(uint8_t *p, int64_t begin,
                                           int64_t end, uint8_t v) {
    int64_t a16 = begin +
        (int64_t)((16 - ((reinterpret_cast<uintptr_t>(p) + begin) & 15)) &
                  15);
    if (a16 > end) a16 = end;
    const int64_t e16 = a16 + ((end - a16) & ~(int64_t)15);
    const uint32_t w = v * 0x01010101u;
    for (int64_t i = begin + threadIdx.x; i < a16; i += blockDim.x) p[i] = v;
    for (int64_t i = a16 + 16 * (int64_t)threadIdx.x; i < e16;
         i += 16 * (int64_t)blockDim.x)
        *reinterpret_cast<uint4 *>(p + i) = make_uint4(w, w, w, w);
    for (int64_t i = e16 + threadIdx.x; i < end; i += blockDim.x) p[i] = v;
}

// A thread's run of nw windows, the first at s (in shared memory) and at
// flat index flat0: K1's rolling hashes, then per chunk of kScreenChunk
// windows the word gather of the kept ones (valid, in the band) with
// every load in flight, __vminu4 over the tables and the four-byte tests.
// Returns the run's hits.  The first pass (!WRITE) marks the row for
// discard (*disc = 1) where a kept window's first case below casemin, in
// case order, is below the abundance screen; the second (WRITE) stores
// the hits from slot `slot` on, below the capacity.  W word tensors (the
// first nwords live); T tables, or T = 0 for any count.
template <bool POLY, int W, int T, bool WRITE>
__device__ __forceinline__ int32_t screen_run(const ScreenReadsArgs &a,
                                              const uint8_t *s, int nw,
                                              int64_t flat0, uint8_t *disc,
                                              int32_t slot) {
    // byte j of word w belongs to sample 4w + j: a case, a control or none
    uint32_t casem[W], ctrlm[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        casem[w] = ctrlm[w] = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int smp = 4 * w + j;
            if (smp < a.ncase) casem[w] |= 0xffu << (8 * j);
            else if (smp < a.nsamples) ctrlm[w] |= 0xffu << (8 * j);
        }
    }
    const uint32_t cmin = a.casemin * 0x01010101u;
    const uint32_t cmax = a.ctrlmax * 0x01010101u;
    // without the abundance screen, a window whose case count in table 0 is
    // below casemin cannot be a hit: its other tables are not loaded
    const bool early = a.screen < 0;
    const int hi_len = a.k > 16 ? a.k - 16 : 0;
    Roller<POLY> roller;
    roller.build(s, a.k, hi_len);
    int32_t hits = 0;
    for (int c0 = 0; c0 < nw; c0 += kScreenChunk) {
        uint32_t x[kScreenChunk], y[kScreenChunk];
        bool keep[kScreenChunk];
#pragma unroll
        for (int c = 0; c < kScreenChunk; ++c) {
            const int j = c0 + c;
            keep[c] = false;
            x[c] = y[c] = 0u;
            if (j < nw) {
                if (j) roller.roll(s, j, a.k, hi_len, a.rc);
                uint8_t v;
                roller.emit(j, &x[c], &y[c], &v);
                keep[c] = v && (x[c] & a.bandmask) == a.band;
            }
        }
        uint32_t m[kScreenChunk][W];
        if constexpr (T > 0) {
            uint32_t idx[kScreenChunk][T], word[kScreenChunk][W][T];
#pragma unroll
            for (int c = 0; c < kScreenChunk; ++c) {
#pragma unroll
                for (int t = 0; t < T; ++t)
                    idx[c][t] = mod_by(x[c] + (uint32_t)t * y[c],
                                       a.tablesize, a.magic);
            }
            // table 0 of every kept window (all tables without the early
            // exit), every load issued before any is used
#pragma unroll
            for (int c = 0; c < kScreenChunk; ++c) {
#pragma unroll
                for (int w = 0; w < W; ++w) {
#pragma unroll
                    for (int t = 0; t < T; ++t) {
                        word[c][w][t] = 0xffffffffu;
                        if (keep[c] && w < a.nwords && (t == 0 || !early))
                            word[c][w][t] = load_word_streamed(
                                a.words[w] + (int64_t)t * a.tablesize +
                                idx[c][t]);
                    }
                }
            }
            if (early) {
#pragma unroll
                for (int c = 0; c < kScreenChunk; ++c) {
                    uint32_t low = 0u;
#pragma unroll
                    for (int w = 0; w < W; ++w)
                        low |= ~__vcmpgeu4(word[c][w][0], cmin) & casem[w];
                    keep[c] = keep[c] && !low;
                }
#pragma unroll
                for (int c = 0; c < kScreenChunk; ++c) {
#pragma unroll
                    for (int w = 0; w < W; ++w) {
#pragma unroll
                        for (int t = 1; t < T; ++t) {
                            if (keep[c] && w < a.nwords)
                                word[c][w][t] = load_word_streamed(
                                    a.words[w] + (int64_t)t * a.tablesize +
                                    idx[c][t]);
                        }
                    }
                }
            }
#pragma unroll
            for (int c = 0; c < kScreenChunk; ++c) {
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    m[c][w] = word[c][w][0];
#pragma unroll
                    for (int t = 1; t < T; ++t)
                        m[c][w] = __vminu4(m[c][w], word[c][w][t]);
                }
            }
        } else {
#pragma unroll
            for (int c = 0; c < kScreenChunk; ++c) {
#pragma unroll
                for (int w = 0; w < W; ++w) m[c][w] = 0xffffffffu;
            }
            for (int t = 0; t < a.ntables; ++t) {
                uint32_t word[kScreenChunk][W];
#pragma unroll
                for (int c = 0; c < kScreenChunk; ++c) {
                    const uint32_t idx = mod_by(x[c] + (uint32_t)t * y[c],
                                                a.tablesize, a.magic);
#pragma unroll
                    for (int w = 0; w < W; ++w) {
                        word[c][w] = 0xffffffffu;
                        if (keep[c] && w < a.nwords)
                            word[c][w] = load_word_streamed(
                                a.words[w] + (int64_t)t * a.tablesize + idx);
                    }
                }
#pragma unroll
                for (int c = 0; c < kScreenChunk; ++c) {
                    uint32_t low = 0u;
#pragma unroll
                    for (int w = 0; w < W; ++w) {
                        m[c][w] = __vminu4(m[c][w], word[c][w]);
                        low |= ~__vcmpgeu4(m[c][w], cmin) & casem[w];
                    }
                    if (early && t == 0) keep[c] = keep[c] && !low;
                }
            }
        }
#pragma unroll
        for (int c = 0; c < kScreenChunk; ++c) {
            if (!keep[c]) continue;
            uint32_t below[W], any_below = 0u, above = 0u;
#pragma unroll
            for (int w = 0; w < W; ++w) {
                below[w] = ~__vcmpgeu4(m[c][w], cmin) & casem[w];
                any_below |= below[w];
                above |= ~__vcmpleu4(m[c][w], cmax) & ctrlm[w];
            }
            if (!WRITE && any_below && a.screen >= 0) {
                // the abundance of the first case (in case order) below
                // casemin
                uint32_t fail = 0u;
                bool found = false;
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    if (!found && below[w]) {
                        fail = (m[c][w] >> ((__ffs(below[w]) - 1) & ~7)) &
                               0xffu;
                        found = true;
                    }
                }
                if (fail < (uint32_t)a.screen) *disc = 1;
            }
            if (any_below || above) continue;
            if (WRITE) {
                if (slot >= a.max_hits) return hits;
                a.hit_idx[slot] = (int32_t)(flat0 + c0 + c);
#pragma unroll
                for (int w = 0; w < W; ++w) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int smp = 4 * w + q;
                        if (smp < a.nsamples)
                            a.hit_ab[(int64_t)smp * a.max_hits + slot] =
                                (uint8_t)(m[c][w] >> (8 * q));
                    }
                }
                ++slot;
            }
            ++hits;
        }
    }
    return hits;
}

// A block takes a block index from a ticket (so that every block it waits
// on has started) and owns `rows` whole reads.  It stages their codes in
// shared memory with 16-byte loads (as K1), marks the reads to skip from
// there (a code >= 4 within the length, or a length below k), and gives
// each thread one run of `run` consecutive windows of one read, threads in
// the flat order of their runs.  A thread rolls its windows' hashes with
// K1's Roller, gathers and tests them (screen_run) and counts its hits;
// the block scans the counts in thread order and finds its first rank by a
// decoupled look-back over the earlier blocks (route_lookback); then each
// thread with hits below the capacity walks its run again and stores
// them at their ranks, ascending, as jnp.nonzero(..., size=max_hits)
// orders them.  No hashes and no hit scratch go through device memory.
// The last block in ticket order learns the number of hits from its
// look-back, writes it and fills the slots past the hits with -1 and 0.
template <bool POLY, int W, int T>
__global__ void __launch_bounds__(kScreenThreads)
screen_reads_kernel(const __grid_constant__ ScreenReadsArgs a) {
    extern __shared__ uint4 smem[];
    __shared__ int32_t s_len[kScreenThreads];
    __shared__ uint8_t s_skip[kScreenThreads], s_disc[kScreenThreads];
    __shared__ int32_t s_warp[kScreenWarps];
    __shared__ int32_t s_base, s_total;
    __shared__ unsigned s_blk;
    uint8_t *s_codes = reinterpret_cast<uint8_t *>(smem);
    if (threadIdx.x == 0) s_blk = atomicAdd(a.ticket, 1u);
    __syncthreads();
    const int64_t blk = s_blk;
    const int64_t row0 = blk * a.rows;
    const int nr = row0 >= a.nrows ? 0 : (int)(a.nrows - row0 < a.rows ?
                                               a.nrows - row0 : a.rows);
    const uint8_t *g = a.codes + row0 * a.L;
    const int lead = (int)(reinterpret_cast<uintptr_t>(g) & 15);
    const int nbytes = nr * a.L;
    const uint8_t *ga = g - lead;
    const int nchunks = nr ? (lead + nbytes + 15) / 16 : 0;
    for (int c = threadIdx.x; c < nchunks; c += blockDim.x) {
        const int b0 = c * 16;
        if (b0 >= lead && b0 + 16 <= lead + nbytes) {
            smem[c] = __ldg(reinterpret_cast<const uint4 *>(ga) + c);
        } else {
            for (int b = b0; b < b0 + 16; ++b) {
                if (b >= lead && b < lead + nbytes) s_codes[b] = ga[b];
            }
        }
    }
    for (int r = threadIdx.x; r < nr; r += blockDim.x) {
        const int32_t len = __ldg(a.lengths + row0 + r);
        s_len[r] = len;
        s_skip[r] = len < a.k;
        s_disc[r] = 0;
    }
    __syncthreads();

    // this thread's run: windows p0 .. p0 + nw - 1 of row `row`; it looks
    // for invalid bases among the bases its windows start at (the row's
    // last run also past them, to the end of the row)
    const int row = threadIdx.x / a.runs_per_row;
    const int p0 = (threadIdx.x - row * a.runs_per_row) * a.run;
    const bool mine = row < nr && p0 < a.P;
    const int nw = mine ? (a.P - p0 < a.run ? a.P - p0 : a.run) : 0;
    const uint8_t *s = s_codes + lead + row * a.L + p0;
    if (mine) {
        const int len = s_len[row];
        const int end = p0 + nw < a.P ? p0 + nw : a.L;
        for (int i = p0; i < end && i < len; ++i) {
            if (s[i - p0] >= 4) {
                s_skip[row] = 1;
                break;
            }
        }
    }
    __syncthreads();
    const bool kept = mine && !s_skip[row];
    const int64_t flat0 = (row0 + row) * a.P + p0;
    const int32_t count = kept ? screen_run<POLY, W, T, false>(
        a, s, nw, flat0, s_disc + row, 0) : 0;

    // the hits before this thread's: in the block by a scan in thread
    // order, before the block by the look-back
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int32_t incl = warp_inclusive_scan(count);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int32_t c = lane < kScreenWarps ? s_warp[lane] : 0;
        const int32_t wincl = warp_inclusive_scan(c);
        const int32_t total = __shfl_sync(kFull, wincl, 31);
        if (lane < kScreenWarps) s_warp[lane] = wincl - c;
        const int32_t base = route_lookback(a.status, blk, 1, 0, total);
        if (lane == 0) {
            s_base = base;
            s_total = base + total;
        }
    }
    __syncthreads();
    const int32_t slot = s_base + s_warp[warp] + incl - count;
    if (count && slot < a.max_hits)
        screen_run<POLY, W, T, true>(a, s, nw, flat0, s_disc + row, slot);
    for (int r = threadIdx.x; r < nr; r += blockDim.x) {
        a.skip[row0 + r] = s_skip[r];
        a.discard[row0 + r] = s_disc[r] && !s_skip[r];
    }
    if (blk == gridDim.x - 1) {
        const int32_t n = s_total;
        if (threadIdx.x == 0) *a.n_hits = n;
        if (n < a.max_hits) {
            fill_bytes(reinterpret_cast<uint8_t *>(a.hit_idx), 4 * (int64_t)n,
                       4 * (int64_t)a.max_hits, 0xff);
            for (int q = 0; q < a.nsamples; ++q)
                fill_bytes(a.hit_ab, (int64_t)q * a.max_hits + n,
                           (int64_t)(q + 1) * a.max_hits, 0);
        }
    }
}

// Warps a block of the count and write passes beyond kRouteLaneShards
// shards, by their shared memory.
inline int route_warps(int64_t per_warp) {
    int64_t w = (200 * 1024) / per_warp;
    return (int)(w < 1 ? 1 : (w > kRouteWarps ? kRouteWarps : w));
}

inline int64_t route_rounds(int nbins) {
    return (nbins + kRouteBinsPerRound - 1) / kRouteBinsPerRound;
}

inline int64_t route_nwarps(int64_t n, int nbins) {
    int64_t per = route_rounds(nbins) * kRouteRound;
    return (n + per - 1) / per;
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

template <int W>
int launch_gather_words(const WordsArgs &args, int nwords, int nsamples,
                        int ntables, uint32_t tablesize, uint32_t magic,
                        const int32_t *h1, const int32_t *h2, int64_t n,
                        uint8_t *out, cudaStream_t stream) {
    if (ntables == 4) {
        gather_words_kernel<W, 4><<<blocks_for(n), kThreads, 0, stream>>>(
            args, nwords, nsamples, ntables, tablesize, magic, h1, h2, n,
            out);
    } else {
        gather_words_kernel<W, 0><<<blocks_for(n), kThreads, 0, stream>>>(
            args, nwords, nsamples, ntables, tablesize, magic, h1, h2, n,
            out);
    }
    return (int)cudaGetLastError();
}

// The screen's geometry at P windows a row: a thread's run of windows,
// the runs of a row, the rows of a block and the blocks.
struct ScreenGeometry {
    int run, runs_per_row, rows;
    int64_t blocks;
};

inline ScreenGeometry screen_geometry(int64_t nrows, int P) {
    ScreenGeometry g;
    g.run = kScreenRun;
    g.runs_per_row = (P + g.run - 1) / g.run;
    if (g.runs_per_row > kScreenThreads) {
        g.run = (P + kScreenThreads - 1) / kScreenThreads;
        g.runs_per_row = (P + g.run - 1) / g.run;
    }
    g.rows = kScreenThreads / g.runs_per_row;
    if ((int64_t)g.rows > nrows) g.rows = nrows > 0 ? (int)nrows : 1;
    g.blocks = nrows > 0 ? (nrows + g.rows - 1) / g.rows : 1;
    return g;
}

template <bool POLY, int W>
int launch_screen_reads(const ScreenReadsArgs &a, unsigned blocks,
                        size_t smem, cudaStream_t stream) {
    auto kernel = a.ntables == 4 ? screen_reads_kernel<POLY, W, 4>
                                 : screen_reads_kernel<POLY, W, 0>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<blocks, kScreenThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool POLY>
int dispatch_screen_reads(const ScreenReadsArgs &a, unsigned blocks,
                        size_t smem, cudaStream_t stream) {
    switch (a.nwords) {
    case 1:
        return launch_screen_reads<POLY, 1>(a, blocks, smem, stream);
    case 2:
        return launch_screen_reads<POLY, 2>(a, blocks, smem, stream);
    default:
        return launch_screen_reads<POLY, kMaxWords>(a, blocks, smem, stream);
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

// The word gather: `words` points to nwords (1 .. kMaxWords) device
// pointers, each to a [ntables, tablesize] uint32 word tensor whose byte j
// holds sample 4w + j; out is uint8 [nsamples, n] with nsamples in
// (4 * (nwords - 1), 4 * nwords].  `magic` as for kt_gather_counts.
int kt_gather_words(const void *const *words, int nwords, int nsamples,
                    int ntables, int64_t tablesize, uint32_t magic,
                    const void *h1, const void *h2, int64_t n, void *out,
                    void *stream) {
    if (n == 0) return 0;
    if (nwords < 1 || nwords > kMaxWords || nsamples <= 4 * (nwords - 1) ||
        nsamples > 4 * nwords || ntables < 1 || tablesize < 1 ||
        tablesize >= (int64_t)1 << 31)
        return (int)cudaErrorInvalidValue;
    WordsArgs a;
    for (int w = 0; w < kMaxWords; ++w)
        a.words[w] = w < nwords ? (const uint32_t *)words[w] : nullptr;
    const int32_t *p1 = (const int32_t *)h1, *p2 = (const int32_t *)h2;
    uint8_t *o = (uint8_t *)out;
    cudaStream_t st = (cudaStream_t)stream;
    uint32_t z = (uint32_t)tablesize;
    switch (nwords) {
    case 1:
        return launch_gather_words<1>(a, 1, nsamples, ntables, z, magic, p1,
                                      p2, n, o, st);
    case 2:
        return launch_gather_words<2>(a, 2, nsamples, ntables, z, magic, p1,
                                      p2, n, o, st);
    default:
        return launch_gather_words<kMaxWords>(a, nwords, nsamples, ntables,
                                              z, magic, p1, p2, n, o, st);
    }
}

// The int64 scratch kt_screen_reads needs for nrows rows of P windows:
// the blocks' ticket, then a look-back word a block.
int64_t kt_screen_reads_scratch(int64_t nrows, int P) {
    if (P < 1) return 1;
    return 1 + screen_geometry(nrows, P).blocks;
}

// The screen of one read batch over packed sample words, in one launch
// (after a memset of the scratch).  `words` points to nwords (1 ..
// kMaxWords) device pointers, each to a [ntables, tablesize] uint32 word
// tensor whose byte j holds sample 4w + j's 8-bit counter; nsamples lies in
// (4 * (nwords - 1), 4 * nwords], the first ncase of them cases.  codes
// [nrows, L] uint8 (>= 4 invalid), lengths [nrows] int32; the windows are
// hashed as kt_kmer_hashes hashes them (`rc` points to the 8 uint32 of
// RollConstants).  A window (row r, offset p < P = L - k + 1) is a hit
// where it holds no code >= 4, (h1 & bandmask) == band, row r is not
// skipped, every case's minimum over the tables is >= casemin and every
// control's <= ctrlmax.  hit_idx [max_hits] int32 gets the flat indices r
// * P + p of the first max_hits hits, ascending, then -1; hit_ab
// [nsamples, max_hits] uint8 their counts, then 0; n_hits (one int32) the
// number of hits, however many.  skip[r] = 1 where a code >= 4 lies within
// lengths[r] or lengths[r] < k; with screen >= 0, discard[r] = 1 where row
// r is not skipped and some kept window of it has a first case (in case
// order) below casemin whose count is below screen; both 0 otherwise.
// `scratch` is kt_screen_reads_scratch(nrows, P) int64; `magic` as for
// kt_gather_counts.
int kt_screen_reads(const void *const *words, int nwords, int nsamples,
                    int ncase, int ntables, int64_t tablesize,
                    uint32_t magic, const void *codes, const void *lengths,
                    int64_t nrows, int L, int k, const uint32_t *rc,
                    uint32_t bandmask, uint32_t band, int casemin,
                    int ctrlmax, int screen, int max_hits, void *hit_idx,
                    void *hit_ab, void *n_hits, void *discard, void *skip,
                    void *scratch, void *stream) {
    if (nwords < 1 || nwords > kMaxWords || nsamples <= 4 * (nwords - 1) ||
        nsamples > 4 * nwords || ncase < 1 || ncase > nsamples ||
        ntables < 1 || tablesize < 1 || tablesize >= (int64_t)1 << 31 ||
        k < 1 || L < k || nrows < 0 ||
        nrows * (L - k + 1) >= (int64_t)1 << 31 || casemin < 0 ||
        casemin > 255 || ctrlmax < 0 || ctrlmax > 255 || screen < -1 ||
        screen > 255 || max_hits < 1)
        return (int)cudaErrorInvalidValue;
    const int P = L - k + 1;
    const ScreenGeometry geo = screen_geometry(nrows, P);
    ScreenReadsArgs a;
    for (int w = 0; w < kMaxWords; ++w)
        a.words[w] = w < nwords ? (const uint32_t *)words[w] : nullptr;
    a.codes = (const uint8_t *)codes;
    a.lengths = (const int32_t *)lengths;
    a.hit_idx = (int32_t *)hit_idx;
    a.hit_ab = (uint8_t *)hit_ab;
    a.n_hits = (int32_t *)n_hits;
    a.discard = (uint8_t *)discard;
    a.skip = (uint8_t *)skip;
    a.ticket = (unsigned *)scratch;
    a.status = (unsigned long long *)scratch + 1;
    a.nrows = nrows;
    a.L = L;
    a.P = P;
    a.k = k;
    a.rows = geo.rows;
    a.run = geo.run;
    a.runs_per_row = geo.runs_per_row;
    // the tile, up to 15 bytes of lead, rounded up to whole 16-byte chunks
    a.code_bytes = (int)(((int64_t)geo.rows * L + 15 + 15) / 16 * 16);
    a.nwords = nwords;
    a.nsamples = nsamples;
    a.ncase = ncase;
    a.ntables = ntables;
    a.max_hits = max_hits;
    a.tablesize = (uint32_t)tablesize;
    a.magic = magic;
    a.bandmask = bandmask;
    a.band = band;
    a.casemin = (uint32_t)casemin;
    a.ctrlmax = (uint32_t)ctrlmax;
    a.screen = screen;
    a.rc = {rc[0], rc[1], rc[2], rc[3], rc[4], rc[5], rc[6], rc[7]};
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(
        scratch, 0, sizeof(int64_t) * (1 + geo.blocks), st);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)a.code_bytes;
    if (k > 32)
        return dispatch_screen_reads<true>(a, (unsigned)geo.blocks, smem, st);
    return dispatch_screen_reads<false>(a, (unsigned)geo.blocks, smem, st);
}

// acc [ntables, span] int32 += 1 at every index in [0, span) of the
// segments' rows (any other index is skipped).  `segs` points to nsegs
// ScatterSeg on the host, each a [ntables, n] block of int32 indices with
// its row stride and, where pop is not null, its rows' filled lengths
// (see ScatterSeg).  One launch takes up to kMaxSegs segments; more are
// launched kMaxSegs at a time.
int kt_scatter_add(void *acc, int64_t span, int ntables, const void *segs,
                   int nsegs, void *stream) {
    if (ntables == 0 || nsegs == 0) return 0;
    if (ntables < 0 || ntables > 65535 || nsegs < 0 || span < 1 ||
        span >= (int64_t)1 << 31)
        return (int)cudaErrorInvalidValue;
    const ScatterSeg *sg = (const ScatterSeg *)segs;
    cudaStream_t st = (cudaStream_t)stream;
    for (int first = 0; first < nsegs; first += kMaxSegs) {
        int m = nsegs - first < kMaxSegs ? nsegs - first : kMaxSegs;
        ScatterArgs a;
        a.acc = (int32_t *)acc;
        a.span = span;
        int64_t most = 0;
        for (int i = 0; i < m; ++i) {
            a.s[i] = sg[first + i];
            if (a.s[i].n < 0) return (int)cudaErrorInvalidValue;
            most = a.s[i].n > most ? a.s[i].n : most;
        }
        if (most == 0) continue;
        dim3 grid(blocks_for(most), (unsigned)ntables, (unsigned)m);
        scatter_add_kernel<<<grid, kThreads, 0, st>>>(a);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
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

// The int32 scratch kt_route needs for n k-mers, ntables tables and
// nshards shards: up to kRouteLaneShards shards the blocks' ticket and
// look-back words, beyond a count a bin and warp.
int64_t kt_route_scratch(int64_t n, int ntables, int nshards) {
    const int nbins = ntables * nshards;
    if (nshards <= kRouteLaneShards) {
        int64_t per_block = (int64_t)kRouteWarps * kRouteRound;
        return 2 + 2 * (int64_t)nbins * ((n + per_block - 1) / per_block);
    }
    return (int64_t)nbins * route_nwarps(n, nbins);
}

// Bins n hashed k-mers by owner shard: for every k-mer with valid != 0 and
// every table t, bucket g = (h1 + t * h2) mod 2^32 mod total goes to bin
// (t, g / shard_size) of send [ntables, nshards, capacity] int32, as g mod
// shard_size, at the slot of its rank among the bin's k-mers in k-mer
// order, where that slot is below `capacity`; the other slots are not
// written.  pop [ntables, nshards] int32 gets each bin's k-mers, slots
// beyond `capacity` included.  `scratch` is kt_route_scratch(n, ntables,
// nshards) int32 (8-byte aligned); total <= nshards * shard_size.
// `magic` and `shard_magic` are floor(2^32 / d) of total and shard_size,
// as for kt_gather_counts.  Up to kRouteLaneShards shards: a memset and
// one launch; beyond: count, scan and write launches.
int kt_route(const void *h1, const void *h2, const void *valid, int64_t n,
             int64_t total, uint32_t magic, int64_t shard_size,
             uint32_t shard_magic, int ntables, int nshards,
             int64_t capacity, void *send, void *pop, void *scratch,
             void *stream) {
    if (ntables == 0) return 0;
    if (n < 0 || total < 1 || total >= (int64_t)1 << 31 || shard_size < 1 ||
        shard_size >= (int64_t)1 << 31 || nshards < 1 ||
        total > (int64_t)nshards * shard_size || capacity < 1 ||
        ntables < 0 || ntables * nshards > kRouteMaxBins ||
        n >= (int64_t)1 << 31)
        return (int)cudaErrorInvalidValue;
    const int nbins = ntables * nshards;
    RouteArgs a;
    a.h1 = (const int32_t *)h1;
    a.h2 = (const int32_t *)h2;
    a.valid = (const uint8_t *)valid;
    a.n = n;
    a.send = (int32_t *)send;
    a.pop = (int32_t *)pop;
    a.counts = (int32_t *)scratch;
    a.ticket = (unsigned *)scratch;
    a.status = (unsigned long long *)scratch + 1;
    a.nwarps = route_nwarps(n, nbins);
    a.rounds = (int32_t)route_rounds(nbins);
    a.total = (uint32_t)total;
    a.magic = magic;
    a.shard_size = (uint32_t)shard_size;
    a.shard_magic = shard_magic;
    a.ntables = ntables;
    a.nshards = nshards;
    a.owner_bits = 0;
    while ((1 << a.owner_bits) < nshards) ++a.owner_bits;
    a.capacity = capacity;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (n == 0) {
        err = cudaMemsetAsync(pop, 0, sizeof(int32_t) * nbins, st);
        return (int)err;
    }
    if (nshards <= kRouteLaneShards) {
        int64_t per_block = (int64_t)kRouteWarps * kRouteRound;
        int64_t blocks = (n + per_block - 1) / per_block;
        err = cudaMemsetAsync(
            scratch, 0, sizeof(int32_t) * kt_route_scratch(n, ntables, nshards),
            st);
        if (err != cudaSuccess) return (int)err;
        route_lanes_kernel<<<(unsigned)blocks, kRouteWarps * 32, 0, st>>>(a);
        return (int)cudaGetLastError();
    }
    int64_t per_warp = 4 * (int64_t)nbins;
    int w = route_warps(per_warp);
    size_t smem = (size_t)w * per_warp;
    unsigned blocks = (unsigned)((a.nwarps + w - 1) / w);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            route_count_many_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(
                route_write_many_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        }
        if (err != cudaSuccess) return (int)err;
    }
    route_count_many_kernel<<<blocks, 32 * w, smem, st>>>(a);
    route_scan_kernel<<<(unsigned)nbins, kRouteScanThreads, 0, st>>>(
        a.counts, a.nwarps, a.pop);
    route_write_many_kernel<<<blocks, 32 * w, smem, st>>>(a);
    return (int)cudaGetLastError();
}

const char *kt_kmer_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
