// K4: connected components of the read <-> k-mer incidence by min-label
// propagation, for Hopper (nvcc -gencode arch=compute_90a,code=sm_90a).
//
// Replaces the XLA program of kevlar_tpu/ops/cc_ops.py
// (connected_components_bipartite, jitted at :51), which the partition
// stage runs at >= 200,000 incidence pairs.  Each label is the smallest
// read index in the read's component; k-mer labels start at 2^30.
//
// Design.  The JAX program is a Jacobi step: a fresh k-mer label array is
// scatter-min'd from the read labels, then a new read label array from the
// k-mer labels, until nothing changes.  Here both arrays are relaxed in
// place with atomicMin, one thread per incidence pair:
//
//   kt_cc_kmer_min:  kl[kmer[e]]  = min(kl[kmer[e]],  lab[read[e]])
//   kt_cc_read_min:  lab[read[e]] = min(lab[read[e]], kl[kmer[e]]),
//                    raising a device flag when a read label falls.
//
// Labels only fall, and every label is a read index of its component, so
// the relaxation reaches the same unique fixed point as the Jacobi step
// (the component minimum); only the number of iterations may differ.  The
// host side of kt_cc_labels loops until an iteration lowers no read label,
// or n_reads + 2 iterations, reading the flag back once per iteration.
//
// Bound: random 4-byte gathers and atomics over the incidence (8 bytes a
// pair read twice, plus the label traffic) once per iteration, and one
// host round trip per iteration; a long chain therefore costs its
// diameter in launches.  Pointer jumping and fewer host syncs are the
// known ways to make it fast.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKmerInit = 1 << 30;

__global__ void kt_cc_fill(int32_t* __restrict__ x, int64_t n, int32_t value,
                           int iota) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    x[i] = iota ? (int32_t)i : value;
  }
}

__global__ void kt_cc_kmer_min(const int32_t* __restrict__ read,
                               const int32_t* __restrict__ kmer, int64_t E,
                               const int32_t* __restrict__ lab,
                               int32_t* __restrict__ kl) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * blockDim.x) {
    int32_t v = lab[read[e]];
    int32_t* slot = kl + kmer[e];
    if (v < *slot) atomicMin(slot, v);
  }
}

__global__ void kt_cc_read_min(const int32_t* __restrict__ read,
                               const int32_t* __restrict__ kmer, int64_t E,
                               const int32_t* __restrict__ kl,
                               int32_t* __restrict__ lab,
                               int32_t* __restrict__ changed) {
  bool lowered = false;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * blockDim.x) {
    int32_t v = kl[kmer[e]];
    int32_t* slot = lab + read[e];
    if (v < *slot && v < atomicMin(slot, v)) lowered = true;
  }
  if (lowered) *changed = 1;
}

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

// Labels of n_reads reads from E incidence pairs (read[e], kmer[e]), all
// int32 device pointers; read ids in [0, n_reads), k-mer ids in
// [0, n_kmers) (the wrapper checks).  lab [n_reads] receives the labels;
// kl [n_kmers] and changed [1] are scratch.  *iterations receives the
// number of propagation iterations run.  Returns a cudaError_t.
int kt_cc_labels(const int32_t* read, const int32_t* kmer, int64_t E,
                 int64_t n_reads, int64_t n_kmers, int32_t* lab, int32_t* kl,
                 int32_t* changed, int64_t max_iterations,
                 int64_t* iterations, cudaStream_t stream) {
  *iterations = 0;
  if (n_reads > 0) {
    kt_cc_fill<<<grid_for(n_reads), kThreads, 0, stream>>>(lab, n_reads, 0,
                                                           1);
  }
  if (n_kmers > 0) {
    kt_cc_fill<<<grid_for(n_kmers), kThreads, 0, stream>>>(kl, n_kmers,
                                                           kKmerInit, 0);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || E == 0) return (int)err;
  int grid = grid_for(E);
  int32_t host_changed = 1;
  while (host_changed && *iterations < max_iterations) {
    err = cudaMemsetAsync(changed, 0, sizeof(int32_t), stream);
    if (err != cudaSuccess) return (int)err;
    kt_cc_kmer_min<<<grid, kThreads, 0, stream>>>(read, kmer, E, lab, kl);
    kt_cc_read_min<<<grid, kThreads, 0, stream>>>(read, kmer, E, kl, lab,
                                                  changed);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyAsync(&host_changed, changed, sizeof(int32_t),
                          cudaMemcpyDeviceToHost, stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return (int)err;
    ++*iterations;
  }
  return (int)cudaSuccess;
}

const char* kt_cc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
