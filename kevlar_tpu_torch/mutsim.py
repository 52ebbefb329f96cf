"""``mutsim``: novel-k-mer histograms for hypothetical mutations.

Re-implements the reference's eval-only C++ mutation simulator
(notebook/mutsim/src/: mut-hist.cpp driving snv.cpp /
del.cpp / hist.cpp) as a batched array program:

- **snv mode** (snv.cpp:11-40): for every genome position (sampled at
  rate ``r``), take the (2k-1)-window centred there and substitute each
  of the 3 alternate bases; histogram the counttable abundance of every
  k-mer of every mutated window (``abund_hist``, clamped at ``histmax``)
  and the number of zero-abundance ("novel") k-mers per mutation
  (``unique_hist``, 0..k).
- **del mode** (del.cpp:11-45): per position, the (2k-1)-window formed by
  deleting ``delsize`` bases; same two histograms.

Output: the two histogram lines exactly as the reference's artifacts
(notebook/mutsim/k31-snv.txt): ``[n0, n1, ...]`` abundance histogram,
then ``[u0 ... uk]`` novel-k-mer histogram.

Where the reference walks positions one at a time through khmer point
lookups, every window here is a row of a columnar batch: windows build
by vectorised gather and a batch of windows is one ``query_batch`` of the
counttable on its device (K1 and K2 on a GPU); with ``--device cpu`` the
counters stay a memory map of the file and the lookups are numpy's, as for
a khmer-format table.  Position sampling uses numpy's
PCG64 rather than the reference's mt19937 (the sample is statistical;
histograms at rate 1.0 are exact and deterministic).

Usage:
    python -m kevlar_tpu_torch.mutsim -k 31 -t snv genome.fa counts.ct
    python -m kevlar_tpu_torch.mutsim -k 31 -t del -z 5 genome.fa counts.ct
    python -m kevlar_tpu_torch.mutsim --device cpu genome.fa counts.ct
"""

import sys

import numpy as np

from kevlar_tpu_torch import dna


def _window_counts(windows, sketch):
    """Abundances for every k-mer of [B, 2k-1] base-code windows."""
    if getattr(sketch, 'backend', 'host') == 'device':
        counts, valid = sketch.query_batch(windows)
        return counts.cpu().numpy(), valid.cpu().numpy().astype(bool)
    h1, h2, valid = dna.kmer_hashes(windows, sketch.ksize())
    counts = sketch._host_counts(h1.ravel(), h2.ravel())
    counts = counts.reshape(h1.shape)
    return np.where(valid, counts, 0), valid


def _emit(abund_hist, unique_hist, outstream):
    for hist in (abund_hist, unique_hist):
        outstream.write('[' + ', '.join(str(int(v)) for v in hist) + ']\n')


def mutsim(seqs, sketch, muttype='snv', delsize=5, histmax=16, rate=1.0,
           seed=42, limit=None, batch=8192):
    """(abund_hist, unique_hist) over all sequences; see module docstring."""
    k = sketch.ksize()
    W = 2 * k - 1
    abund_hist = np.zeros(histmax + 1, dtype=np.int64)
    unique_hist = np.zeros(k + 1, dtype=np.int64)
    rng = np.random.default_rng(seed)
    nmut = 0

    def tally(windows):
        counts, valid = _window_counts(windows, sketch)
        # windows with any non-ACGT base are skipped wholesale (the
        # reference prep-genome strips ambiguity; khmer would throw)
        ok = valid.all(axis=1)
        counts = counts[ok].astype(np.int64)
        if not len(counts):
            return 0
        abund_hist[:] += np.bincount(
            np.minimum(counts, histmax).ravel(), minlength=histmax + 1)
        unique_hist[:] += np.bincount(
            (counts == 0).sum(axis=1), minlength=k + 1)
        return len(counts)

    for seq in seqs:
        g = dna.encode(seq)
        N = len(g)
        # SNV: centres i in [k-1, N-k]; del: i in [k-1, N-k-delsize]
        hi = (N - k + 1) if muttype == 'snv' else (N - k - delsize + 1)
        if hi <= k - 1:
            continue
        centres = np.arange(k - 1, hi, dtype=np.int64)
        if rate < 0.9999:
            centres = centres[rng.random(len(centres)) < rate]
        if limit:
            centres = centres[:max(0, limit - nmut)]
        nmut += len(centres)
        for lo in range(0, len(centres), batch):
            cs = centres[lo:lo + batch]
            starts = cs - (k - 1)
            if muttype == 'snv':
                win = g[starts[:, None] + np.arange(W)]
                centre = win[:, k - 1]
                rows = []
                for alt in range(4):
                    pick = centre != alt
                    mut = win[pick].copy()
                    mut[:, k - 1] = alt
                    rows.append(mut)
                windows = np.concatenate(rows)
            else:
                left = g[starts[:, None] + np.arange(k - 1)]
                right = g[(cs + delsize)[:, None] + np.arange(k)]
                windows = np.concatenate([left, right], axis=1)
            tally(windows)
        if limit and nmut >= limit:
            break
    return abund_hist, unique_hist


def main(argv=None):
    import argparse
    from kevlar_tpu_torch import sketch as sketch_mod
    from kevlar_tpu_torch import seqio
    ap = argparse.ArgumentParser(description='novel-k-mer histograms for '
                                 'hypothetical mutations (mutsim parity)')
    ap.add_argument('-k', '--ksize', type=int, default=31)
    ap.add_argument('-t', '--muttype', choices=('snv', 'del'), default='snv')
    ap.add_argument('-z', '--delsize', type=int, default=5)
    ap.add_argument('-m', '--histmax', type=int, default=16)
    ap.add_argument('-r', '--rate', type=float, default=1.0)
    ap.add_argument('-s', '--seed', type=int, default=42)
    ap.add_argument('-l', '--limit', type=int, default=None)
    ap.add_argument('--device', default='cuda', help='device that holds '
                    'the counttable and answers the queries; default cuda')
    ap.add_argument('seqfile', help='genome Fasta')
    ap.add_argument('counts', help='genome counttable (.ct)')
    args = ap.parse_args(argv)
    if args.device.startswith('cpu'):
        # the counters stay a memory map of the file
        sketch = sketch_mod.load(args.counts, backend='host')
    else:
        sketch = sketch_mod.load(args.counts, device=args.device)
    seqs = (r.sequence for r in
            seqio.multi_file_iter([args.seqfile]))
    abund, unique = mutsim(seqs, sketch, muttype=args.muttype,
                           delsize=args.delsize, histmax=args.histmax,
                           rate=args.rate, seed=args.seed, limit=args.limit)
    _emit(abund, unique, sys.stdout)


if __name__ == '__main__':
    main()
