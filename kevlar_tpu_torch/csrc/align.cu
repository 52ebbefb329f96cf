// Exact ksw2 ksw_extz global alignment (affine gaps, N scores 0) for a batch
// of (target, query) pairs, with the traceback, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel kevlar_tpu/ops/align_pallas.py
// (_kernel_factory.kernel, launched by _align_pallas_batch, plus the jitted
// traceback _traceback_packed) and its XLA twin kevlar_tpu/ops/align_ops.py
// (_align_wavefront_batch, _traceback_batch).  Same cell arithmetic,
// tie-breaks, boundary values and direction codes; the plain PyTorch version
// of both kernels is kevlar_tpu_torch/ops/align_cuda.py::_ksw_extz_plain.
//
// What bounds it on the card.  Each cell is ~30 integer operations on
// values in on-chip memory, plus one direction byte stored to device memory
// that the traceback reads back.  The DP along one pair is a chain of
// anti-diagonals (cell (i, j) needs diagonals d-1 and d-2), so a pair's
// parallelism is one diagonal wide (<= min(tlen, qlen) cells) and every
// diagonal costs a block-wide barrier.  So the kernel is bound by barrier
// latency and by how many pairs are in flight at once, not by DRAM
// bandwidth: a call-stage batch of thousands of ~700 x ~800 pairs moves a
// few GB of direction bytes at 3.35 TB/s, a millisecond-scale floor.
//
// What the design does about it.
//  * One thread block per pair, threads striding over the cells of the
//    current diagonal, so thousands of independent pairs fill the 132 SMs.
//  * The wavefront state lives in shared memory, in five arrays that make
//    every cell's reads and writes private to it within a diagonal:
//      Hi[i]  H of row i at its latest cell       -> H(i, j-1)
//      Fi[i]  F of row i at its latest cell       -> F(i, j-1)
//      Hj[j]  H of column j at its latest cell    -> H(i-1, j)
//      Ej[j]  E of column j at its latest cell    -> E(i-1, j)
//      Hk[k]  H of main diagonal k = i - j        -> H(i-1, j-1)
//    Cells of one anti-diagonal differ in i, in j and in k, so each slot is
//    read and then overwritten by the one thread that owns the cell: ONE
//    __syncthreads() per diagonal, no double buffers, and no initialisation
//    (every slot a cell reads was written by an in-bounds cell on an earlier
//    diagonal, or is replaced by a boundary value).  The state is
//    4 * (3 * (T + Q) - 1) bytes per pair; beyond the shared-memory budget
//    the wrapper hands in a global-memory scratch area instead.
//  * Each pair loops over its own tlen + qlen - 1 diagonals: no power-of-two
//    padding of T, Q or the batch, and no 512 cap (both were TPU compile
//    and VMEM constraints).
//  * Direction codes are one byte per cell in a ragged per-pair region of
//    one buffer (offsets: int64 prefix sum of tlen * qlen, row-major).
//  * The traceback is a second kernel with one thread per pair; only the op
//    stream (B x (T + Q) bytes) and the exit cells leave the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -0x40000000;
constexpr int kDpThreads = 256;
constexpr int kTbThreads = 128;

__global__ void __launch_bounds__(kDpThreads)
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
        return;  // uniform across the block: no barrier is skipped
    }
    int32_t* st = gscratch
        ? gscratch + (int64_t)pair * (3 * (T + Q) - 1) : smem;
    int32_t* Hi = st;
    int32_t* Fi = Hi + T;
    int32_t* Hj = Fi + T;
    int32_t* Ej = Hj + Q;
    int32_t* Hk = Ej + Q;  // T + Q - 1 slots, index i - j + Q - 1
    const uint8_t* t = targets + (int64_t)pair * T;
    const uint8_t* q = queries + (int64_t)pair * Q;
    uint8_t* zp = z + zoff[pair];

    const int ndiag = tlen + qlen - 1;
    for (int d = 0; d < ndiag; ++d) {
        const int ilo = max(0, d - qlen + 1);
        const int ihi = min(d, tlen - 1);
        for (int i = ilo + threadIdx.x; i <= ihi; i += blockDim.x) {
            const int j = d - i;
            const int k = i - j + Q - 1;
            int hd;  // H(i-1, j-1)
            if (i == 0) {
                hd = j == 0 ? 0 : -(gapoe + gape * (j - 1));
            } else if (j == 0) {
                hd = -(gapoe + gape * (i - 1));
            } else {
                hd = Hk[k];
            }
            const int e = i == 0 ? -(gapoe + gapoe + gape * j)
                                 : max(Ej[j] - gape, Hj[j] - gapoe);
            const int f = j == 0 ? -(gapoe + gapoe + gape * i)
                                 : max(Fi[i] - gape, Hi[i] - gapoe);
            const int tc = t[i];
            const int qc = q[j];
            const int sub = (tc >= 4 || qc >= 4) ? 0 : (tc == qc ? a : b);
            const int hdiag = hd + sub;
            // ties: the diagonal wins against E, H keeps its value against F
            int code = hdiag >= e ? 0 : 1;
            int h = max(hdiag, e);
            code = h >= f ? code : 2;
            h = max(h, f);
            const int hh = h - gapoe;
            // continuation bits need a strict '>'
            code |= (e - gape > hh) << 3;
            code |= (f - gape > hh) << 4;
            zp[(int64_t)i * qlen + j] = (uint8_t)code;
            Hi[i] = h;
            Hj[j] = h;
            Hk[k] = h;
            Ej[j] = e;
            Fi[i] = f;
            if (i == tlen - 1 && j == qlen - 1) scores[pair] = h;
        }
        __syncthreads();
    }
}

// Walk the direction codes back from (tlen-1, qlen-1): the state machine of
// align_ops._traceback_batch.  ops_rev[b, step] = 0 M, 1 D, 2 I; 3 after the
// walk leaves the matrix.  exit_i/exit_j are the residual (i, j) for the
// leading gap run.
__global__ void __launch_bounds__(kTbThreads)
ksw_extz_traceback(const int32_t* __restrict__ tlens,
                   const int32_t* __restrict__ qlens,
                   const int64_t* __restrict__ zoff,
                   const uint8_t* __restrict__ z, int B, int S,
                   uint8_t* __restrict__ ops_rev,
                   int32_t* __restrict__ exit_i, int32_t* __restrict__ exit_j)
{
    const int pair = blockIdx.x * blockDim.x + threadIdx.x;
    if (pair >= B) return;
    const int tlen = tlens[pair];
    const int qlen = qlens[pair];
    const uint8_t* zp = z + zoff[pair];
    uint8_t* ops = ops_rev + (int64_t)pair * S;
    int i = tlen - 1, j = qlen - 1, state = 0, step = 0;
    if (tlen > 0 && qlen > 0) {
        while (i >= 0 && j >= 0) {
            const int code = zp[(int64_t)i * qlen + j];
            int s = state;
            if (s == 0 || !((code >> (s + 2)) & 1)) s = code & 7;
            ops[step++] = (uint8_t)s;
            if (s == 0 || s == 1) --i;
            if (s == 0 || s == 2) --j;
            state = s;
        }
    }
    for (; step < S; ++step) ops[step] = 3;
    exit_i[pair] = i;
    exit_j[pair] = j;
}

}  // namespace

// Host entry point, bound with ctypes.  All pointers are device pointers;
// the kernels run on `stream` and nothing synchronises.  `gscratch` null
// means the wavefront state goes to `smem_bytes` of dynamic shared memory
// per block; otherwise it is B * (3 * (T + Q) - 1) int32 of device memory.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int kt_ksw_extz(const void* targets, const void* tlens, int T,
                           const void* queries, const void* qlens, int Q,
                           int B, const void* zoff, void* z, void* scores,
                           void* ops_rev, int S, void* exit_i, void* exit_j,
                           void* gscratch, int smem_bytes, int match,
                           int mismatch, int gapopen, int gapextend,
                           void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int b = mismatch < 0 ? mismatch : -mismatch;
    const int shared = gscratch ? 0 : smem_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        ksw_extz_dp, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
    ksw_extz_dp<<<B, kDpThreads, shared, s>>>(
        static_cast<const uint8_t*>(targets),
        static_cast<const int32_t*>(tlens), T,
        static_cast<const uint8_t*>(queries),
        static_cast<const int32_t*>(qlens), Q,
        static_cast<const int64_t*>(zoff), static_cast<uint8_t*>(z),
        static_cast<int32_t*>(scores), static_cast<int32_t*>(gscratch),
        match, b, gapopen + gapextend, gapextend);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ksw_extz_traceback<<<(B + kTbThreads - 1) / kTbThreads, kTbThreads, 0,
                         s>>>(
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
