// K4: connected components of the read <-> k-mer incidence by a lock-free
// union-find, for Hopper (nvcc -gencode arch=compute_90a,code=sm_90a).
//
// Replaces the XLA program of kevlar_tpu/ops/cc_ops.py
// (connected_components_bipartite, jitted at :51), which the partition
// stage runs at >= 200,000 incidence pairs.  Each label is the smallest
// read index in the read's component.
//
// Design.  The JAX program is a Jacobi min-label propagation whose number
// of steps is the graph's diameter; a step-for-step port pays a host round
// trip (or at least a launch) per step.  Here the pairs are read once.
// Reads are nodes 0..n_reads-1, k-mer j is node n_reads + j, and one int32
// array holds each node's parent (parent[i] = i at the start):
//
//   kt_cc_init:     parent[i] = i
//   kt_cc_hook:     one thread a pair (read[e], kmer[e]): find the roots of
//                   both nodes, halving the paths on the way, and while
//                   they differ atomicCAS the larger root onto the smaller;
//                   a lost CAS retries from the new roots
//   kt_cc_flatten:  one thread a read: lab[i] = root(i)
//
// A link always points to a smaller index, so no interleaving can close a
// cycle, and a node that has been given a parent is never a root again, so
// a path-halving store (to a non-root) and a CAS (on a root) never meet on
// one node.  A parent once read stays an ancestor for good, so a stale read
// costs a retry, never a wrong root.  When kt_cc_hook has ended, every
// pair's nodes share a tree; the smallest node of a component can never be
// linked away, so it is the tree's root, and it is a read: every k-mer of
// a pair shares a component with a read, and every read index is below
// every k-mer node.  That is the fixed point of the propagation.
//
// Bound: the pairs read once and the labels written once, 8 * E +
// 4 * (n_reads + n_kmers) bytes.  The parents of a partition's graph (a few
// hundred KB to a few MB) live in L2, where the finds and the CAS run; three
// launches in a row on one stream have a floor of a few microseconds of
// their own.  Nothing returns to the host: no flag, no copy, no
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void kt_cc_init(int32_t* __restrict__ parent, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    parent[i] = (int32_t)i;
  }
}

// Root of x, with path halving: every node passed is pointed at its
// grandparent.  Volatile accesses, so that every read sees L2.
__device__ __forceinline__ int32_t find_root(volatile int32_t* parent,
                                             int32_t x) {
  int32_t p = parent[x];
  while (p != x) {
    int32_t g = parent[p];
    if (g != p) parent[x] = g;
    x = p;
    p = g;
  }
  return x;
}

__global__ void kt_cc_hook(const int32_t* __restrict__ read,
                           const int32_t* __restrict__ kmer, int64_t E,
                           int32_t n_reads, int32_t* parent) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * blockDim.x) {
    int32_t a = find_root(parent, read[e]);
    int32_t b = find_root(parent, n_reads + kmer[e]);
    while (a != b) {
      int32_t hi = a > b ? a : b;
      int32_t lo = a > b ? b : a;
      int32_t seen = atomicCAS(parent + hi, hi, lo);
      if (seen == hi) break;
      // hi was linked away meanwhile: go on from where it points now
      a = find_root(parent, seen);
      b = find_root(parent, lo);
    }
  }
}

__global__ void kt_cc_flatten(const int32_t* __restrict__ parent,
                              int64_t n_reads, int32_t* __restrict__ lab) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < n_reads; i += (int64_t)gridDim.x * blockDim.x) {
    int32_t x = (int32_t)i;
    int32_t p = parent[x];
    while (p != x) {
      x = p;
      p = parent[x];
    }
    lab[i] = x;
  }
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
// [0, n_kmers), n_reads + n_kmers < 2^31 (the wrapper checks).  lab
// [n_reads] receives the labels; parent [n_reads + n_kmers] is scratch.
// Enqueues three kernels on the stream and returns a cudaError_t without
// waiting for them.
int kt_cc_labels(const int32_t* read, const int32_t* kmer, int64_t E,
                 int64_t n_reads, int64_t n_kmers, int32_t* lab,
                 int32_t* parent, cudaStream_t stream) {
  int64_t nodes = n_reads + n_kmers;
  if (n_reads <= 0) return (int)cudaSuccess;
  kt_cc_init<<<grid_for(nodes), kThreads, 0, stream>>>(parent, nodes);
  if (E > 0) {
    kt_cc_hook<<<grid_for(E), kThreads, 0, stream>>>(read, kmer, E,
                                                     (int32_t)n_reads, parent);
  }
  kt_cc_flatten<<<grid_for(n_reads), kThreads, 0, stream>>>(parent, n_reads,
                                                            lab);
  return (int)cudaGetLastError();
}

const char* kt_cc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
