// Count-Min sketch kernels for Hopper (sm_90a): k-mer hashing (K1), the
// min-over-tables count gather (K2) and the per-table scatter-add (K3).
//
// K1 kt_kmer_hashes replaces the XLA program of
//   kevlar_tpu/ops/hashing.py :: unpack_bases + kmer_codes + hash_pair
//   (jitted inside sketch_ops.consume_batch_stack_packed and
//   novel_ops.novel_screen_compact_stack_packed).
//   One thread per k-window.  It reads its k bases straight from the 2-bit
//   wire format (k/4 packed bytes plus k/8 bad-mask bytes, which neighbouring
//   threads share through L1), so the [N, L] base array the XLA program
//   materialises never exists; it is bound by the 9 bytes a window writes
//   (h1, h2, valid) and by ~4k integer operations per window.
// K2 kt_gather_counts replaces
//   kevlar_tpu/ops/sketch_ops.py :: gather_counts (B4).
//   One thread per k-mer; T dependent random byte reads into tables far
//   larger than L2 (a 500 MB sample sketch).  Bound by DRAM sector latency:
//   many threads in flight are its only defence in this first version.
// K3 kt_scatter_add replaces
//   tools/scatter_probe.py :: pallas_scatter_add (B10, the pl.pallas_call at
//   :76), the core of sketch_ops._scatter_hashes_i32.
//   acc[t, idx[t, n]] += 1 for every idx >= 0 (and < C), one thread per
//   (t, n), as a global 32-bit atomicAdd.  The TPU kernel walked the index
//   stream sequentially against a VMEM-resident table; here every update is
//   an independent atomic, and integer adds commute, so the result is exact
//   in any order.  Bound by random 4-byte atomics into an accumulator
//   (2 GB for a 500 MB sketch) that L2 cannot hold.
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

// base code at position pos of row `prow` / `brow`: 0-3, or 4 when the bad
// mask (np.packbits order: bit 7 - pos % 8) marks it invalid
__device__ __forceinline__ uint32_t base_at(const uint8_t *prow,
                                            const uint8_t *brow, int pos) {
    uint32_t bad = (brow[pos >> 3] >> (7 - (pos & 7))) & 1u;
    uint32_t b = (prow[pos >> 2] >> (2 * (pos & 3))) & 3u;
    return bad ? 4u : b;
}

__global__ void kmer_hashes_kernel(const uint8_t *__restrict__ packed,
                                   const uint8_t *__restrict__ badmask,
                                   int64_t nrows, int pw, int bw, int P,
                                   int k, int32_t *__restrict__ h1_out,
                                   int32_t *__restrict__ h2_out,
                                   uint8_t *__restrict__ valid_out) {
    int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= nrows * P) return;
    int64_t n = g / P;
    int p = (int)(g - n * P);
    const uint8_t *prow = packed + n * pw;
    const uint8_t *brow = badmask + n * bw;
    uint32_t f_lo = 0, f_hi = 0, r_lo = 0, r_hi = 0;
    bool ok = true;
    if (k > 32) {
        // f = sum_i w_i M^(k-1-i) by Horner; r = sum_i c_i M^i by a running
        // power: both exact in the ring of integers mod 2^32
        uint32_t pw1 = 1u, pw2 = 1u;
        for (int i = 0; i < k; ++i) {
            uint32_t w = base_at(prow, brow, p + i);
            uint32_t c = 3u - (w < 3u ? w : 3u);
            ok = ok && w < 4u;
            f_lo = f_lo * kPolyM1 + w;
            f_hi = f_hi * kPolyM2 + w;
            r_lo += c * pw1;
            r_hi += c * pw2;
            pw1 *= kPolyM1;
            pw2 *= kPolyM2;
        }
    } else {
        int lo_len = k < 16 ? k : 16;
        int hi_len = k - lo_len;
        for (int i = 0; i < k; ++i) {
            uint32_t w = base_at(prow, brow, p + i);
            uint32_t c = 3u - (w < 3u ? w : 3u);
            ok = ok && w < 4u;
            if (i >= k - lo_len) {
                f_lo += w << (2 * (k - 1 - i));
            } else {
                f_hi += w << (2 * (hi_len - 1 - i));
            }
            if (i < lo_len) {
                r_lo += c << (2 * i);
            } else {
                r_hi += c << (2 * (i - lo_len));
            }
        }
    }
    bool use_f = (f_hi < r_hi) || (f_hi == r_hi && f_lo <= r_lo);
    uint32_t c_hi = use_f ? f_hi : r_hi;
    uint32_t c_lo = use_f ? f_lo : r_lo;
    uint32_t h1 = fmix32(c_lo ^ fmix32(c_hi ^ kGolden1));
    uint32_t h2 = fmix32(c_hi ^ fmix32(c_lo ^ kGolden2)) | 1u;
    h1_out[g] = (int32_t)h1;
    h2_out[g] = (int32_t)h2;
    valid_out[g] = ok ? 1 : 0;
}

__global__ void gather_counts_kernel(const uint8_t *__restrict__ tables,
                                     int ntables, int64_t width,
                                     uint32_t tablesize, int bits,
                                     const int32_t *__restrict__ h1,
                                     const int32_t *__restrict__ h2,
                                     int64_t n, uint8_t *__restrict__ out) {
    int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n) return;
    uint32_t a = (uint32_t)h1[g];
    uint32_t b = (uint32_t)h2[g];
    uint32_t m = 255u;
    for (int t = 0; t < ntables; ++t) {
        uint32_t idx = (a + (uint32_t)t * b) % tablesize;
        const uint8_t *row = tables + (int64_t)t * width;
        uint32_t c;
        if (bits == 8) {
            c = row[idx];
        } else if (bits == 4) {
            c = (row[idx >> 1] >> ((idx & 1u) << 2)) & 0xFu;
        } else {
            c = (row[idx >> 3] >> (idx & 7u)) & 1u;
        }
        m = c < m ? c : m;
    }
    out[g] = (uint8_t)m;
}

__global__ void scatter_add_kernel(int32_t *__restrict__ acc, int64_t C,
                                   const int32_t *__restrict__ idx,
                                   int64_t ntables, int64_t n) {
    int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= ntables * n) return;
    int32_t j = idx[g];
    if (j < 0 || j >= C) return;
    int64_t t = g / n;
    atomicAdd(acc + t * C + j, 1);
}

inline unsigned blocks_for(int64_t total) {
    return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int kt_kmer_hashes(const void *packed, const void *badmask, int64_t nrows,
                   int pw, int bw, int P, int k, void *h1, void *h2,
                   void *valid, void *stream) {
    int64_t total = nrows * (int64_t)P;
    if (total == 0) return 0;
    kmer_hashes_kernel<<<blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t *)packed, (const uint8_t *)badmask, nrows, pw, bw, P,
        k, (int32_t *)h1, (int32_t *)h2, (uint8_t *)valid);
    return (int)cudaGetLastError();
}

int kt_gather_counts(const void *tables, int ntables, int64_t width,
                     int64_t tablesize, int bits, const void *h1,
                     const void *h2, int64_t n, void *out, void *stream) {
    if (n == 0) return 0;
    gather_counts_kernel<<<blocks_for(n), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint8_t *)tables, ntables, width, (uint32_t)tablesize, bits,
        (const int32_t *)h1, (const int32_t *)h2, n, (uint8_t *)out);
    return (int)cudaGetLastError();
}

int kt_scatter_add(void *acc, int64_t C, const void *idx, int64_t ntables,
                   int64_t n, void *stream) {
    int64_t total = ntables * n;
    if (total == 0) return 0;
    scatter_add_kernel<<<blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (int32_t *)acc, C, (const int32_t *)idx, ntables, n);
    return (int)cudaGetLastError();
}

const char *kt_kmer_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
