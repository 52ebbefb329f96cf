"""Connected components on the read <-> k-mer bipartite graph.

Port of ``kevlar_tpu/ops/cc_ops.py`` (B6).  The reference builds a networkx
read graph and extracts its connected components
(kevlar/readgraph.py:104-161); here the components come from the
bipartite (read, k-mer) incidence without read-read edges.  Each read's
label is the smallest read index in its component; an isolated read keeps
its own index.

:func:`connected_components` dispatches as ``kevlar_tpu`` does: below
``HOST_CC_THRESHOLD`` incidence pairs the host union-find, at or above it
the components on ``device`` (:func:`connected_components_bipartite`: K4 of
:mod:`kevlar_tpu_torch.ops.cc_cuda`, a one-pass union-find, on a CUDA
tensor; the plain PyTorch version, min-label propagation, on a CPU
tensor).
"""

import numpy as np
import torch

from kevlar_tpu_torch.ops import cc_cuda

KMER_LABEL_INIT = 2 ** 30


def connected_components_plain(read_ids, kmer_ids, n_reads, n_kmers):
    """Plain PyTorch version of K4, step for step the JAX program: each
    step scatter-mins the read labels into fresh k-mer labels (starting at
    2^30), then the k-mer labels into the read labels, until no label
    changes or ``n_reads + 2`` further steps."""
    r = read_ids.to(torch.int64)
    k = kmer_ids.to(torch.int64)
    dev = read_ids.device

    def step(labels):
        kl = torch.full((n_kmers,), KMER_LABEL_INIT, dtype=torch.int32,
                        device=dev)
        kl.scatter_reduce_(0, k, labels[r], 'amin', include_self=True)
        return labels.clone().scatter_reduce_(0, r, kl[k], 'amin',
                                              include_self=True)

    prev = torch.arange(n_reads, dtype=torch.int32, device=dev)
    labels = step(prev)
    it = 0
    while it < n_reads + 2 and bool((labels != prev).any()):
        prev, labels = labels, step(labels)
        it += 1
    return labels


def _check(read_ids, kmer_ids, n_reads, n_kmers):
    for name, x in (('read_ids', read_ids), ('kmer_ids', kmer_ids)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError('{} must be a contiguous 1-D int32 tensor'
                             .format(name))
    if read_ids.shape != kmer_ids.shape:
        raise ValueError('read_ids and kmer_ids differ in shape')
    if read_ids.device != kmer_ids.device:
        raise ValueError('read_ids is on {}, kmer_ids on {}'.format(
            read_ids.device, kmer_ids.device))
    if n_reads < 1 or n_kmers < 1 or n_reads >= KMER_LABEL_INIT:
        raise ValueError('need 1 <= n_reads < 2^30 and n_kmers >= 1')
    if n_reads + n_kmers >= 2 ** 31:
        # K4 numbers k-mer j as node n_reads + j in int32
        raise ValueError('need n_reads + n_kmers < 2^31')
    for name, x, n in (('read', read_ids, n_reads),
                       ('k-mer', kmer_ids, n_kmers)):
        if x.numel():
            lo, hi = torch.aminmax(x)
            if int(lo) < 0 or int(hi) >= n:
                raise ValueError('{} ids outside [0, {})'.format(name, n))


def connected_components_bipartite(read_ids, kmer_ids, n_reads, n_kmers):
    """Labels for each read: the min read index reachable via shared
    k-mers.  ``read_ids``, ``kmer_ids``: int32 [E] incidence pairs on one
    device.  A CUDA tensor launches K4, a CPU tensor runs
    :func:`connected_components_plain`; returns int32 [n_reads] there."""
    _check(read_ids, kmer_ids, n_reads, n_kmers)
    kind = read_ids.device.type
    if kind == 'cuda':
        return cc_cuda.cc_labels_cuda(read_ids, kmer_ids, n_reads, n_kmers)
    if kind == 'cpu':
        return connected_components_plain(read_ids, kmer_ids, n_reads,
                                          n_kmers)
    raise ValueError('no components engine for device ' +
                     str(read_ids.device))


def host_connected_components(read_ids, kmer_ids, n_reads, n_kmers):
    """Union-find for small graphs: the same labels as the propagation
    (the smallest read index in each component)."""
    parent = list(range(n_reads))

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    first_read_for_kmer = {}
    for r, k in zip(read_ids, kmer_ids):
        r = int(r)
        k = int(k)
        if k in first_read_for_kmer:
            ra, rb = find(first_read_for_kmer[k]), find(r)
            if ra != rb:
                if ra < rb:
                    parent[rb] = ra
                else:
                    parent[ra] = rb
        else:
            first_read_for_kmer[k] = r
    return np.array([find(i) for i in range(n_reads)], dtype=np.int32)


# below this many incidence pairs the host union-find runs (kevlar_tpu's
# dispatch, unchanged)
HOST_CC_THRESHOLD = 200_000


def connected_components(read_ids, kmer_ids, n_reads, n_kmers,
                         device='cuda'):
    """Dispatch to the host union-find or to the components on
    ``device``; numpy int32 arrays in, numpy int32 labels out."""
    if len(read_ids) < HOST_CC_THRESHOLD:
        return host_connected_components(read_ids, kmer_ids, n_reads,
                                         n_kmers)
    labels = connected_components_bipartite(
        torch.from_numpy(np.ascontiguousarray(read_ids, np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(kmer_ids, np.int32)).to(device),
        n_reads, n_kmers)
    return labels.cpu().numpy()
