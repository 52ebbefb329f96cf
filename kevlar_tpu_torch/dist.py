"""``dist`` stage: abundance distribution of k-mers inside a mask.

Port of ``kevlar_tpu.dist`` (reference kevlar/dist.py): count masked k-mers
(e.g. single-copy exonic k-mers), histogram distinct k-mer abundances,
output weighted mean/stddev as JSON plus an optional TSV and plot.  Feeds
``simlike --mu/--sigma``.

Both passes run on the sketch's device, batch by batch in the order of
``kevlar_tpu``'s (:func:`kevlar_tpu_torch.batch.base_batches_from_files`):
the first counts only the k-mers in the mask (``consume_batch`` with
``consume_masked``: K1, K2 on the mask, K3's consume); the second hashes
each batch again (K1), reads the mask, a tracking sketch and the counts in
one gather (K2), histograms the counts of the distinct k-mers the tracking
sketch has not seen, and marks them there (K3's kernel in mark mode).
``kevlar_tpu`` keeps a 1-bit tracking sketch and the three lookups of the
second pass on the host; the buckets it has set are those set to 1 in the
tracking sketch here, so the histogram is the same.
"""

from collections import defaultdict
import json
import math

import numpy as np
import torch

import kevlar_tpu_torch
from kevlar_tpu_torch.batch import base_batches_from_files
from kevlar_tpu_torch.ops import hashing, sketch_ops
from kevlar_tpu_torch.sketch import Sketch


class KevlarZeroAbundanceDistError(ValueError):
    pass


def count_first_pass(infiles, counts, mask):
    kevlar_tpu_torch.plog('[kevlar::dist] Processing input')
    ksize = counts.ksize()
    maskspec = counts._mask_spec(mask)
    with counts.consuming() as acc:
        for filename in infiles:
            kevlar_tpu_torch.plog('    -', filename)
            for bases in base_batches_from_files([filename]):
                sketch_ops.consume_codes(
                    acc, counts._codes(bases), ksize, mask=maskspec,
                    mask_threshold=1, consume_masked=True)
    kevlar_tpu_torch.plog('[kevlar::dist] Done processing input!')


def _fresh_histogram(ccnt, keys):
    """Of one batch's fresh windows (their counts and 64-bit hash keys, both
    on the device): the histogram of the counts of the distinct keys, and
    for each count value the rank at which it first appears among those
    keys in ascending unsigned order (``kevlar_tpu`` walks them in that
    order, and the order of first appearance is the order of its result's
    entries).  Two int64 [256] tensors."""
    # torch sorts int64 as signed: flipping the top bit makes that the
    # unsigned order of the keys
    uniq, inverse = torch.unique(keys ^ (-1 << 63), return_inverse=True)
    # equal keys have equal counts: any window of a key gives its count
    per_key = torch.empty(uniq.numel(), dtype=torch.int64,
                          device=keys.device)
    per_key[inverse] = ccnt.to(torch.int64)
    hist = torch.bincount(per_key, minlength=256)
    first = torch.full((256,), uniq.numel(), dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, per_key, torch.arange(
        uniq.numel(), device=keys.device), 'amin', include_self=True)
    return hist, first


def count_second_pass(infiles, counts, mask):
    """Histogram of abundances over distinct masked k-mers.

    Distinct-k-mer dedup runs through a presence (tracking) sketch, khmer
    style (reference dist.py:49-57): bounded memory whatever the genome
    size.  The tracking sketch is of the counts' shape on their device,
    a byte a bucket: K2 reads it and K3's kernel in mark mode sets a
    batch's fresh k-mers in it before the next batch is looked up, with
    nothing to unpack or pack in between (``kevlar_tpu``'s is a 1-bit host
    sketch, an eighth of the memory).
    """
    kevlar_tpu_torch.plog('[kevlar::dist] Second pass over the data')
    abundance = defaultdict(int)
    ksize = counts.ksize()
    tracking = torch.zeros((counts.ntables, counts.tablesize),
                           dtype=torch.uint8, device=counts.device)
    samples = [counts._mask_spec(mask), (tracking, 8, counts.tablesize),
               counts.table_spec()]
    for filename in infiles:
        kevlar_tpu_torch.plog('    -', filename)
        for bases in base_batches_from_files([filename]):
            h1, h2, valid = hashing.kmer_hashes_codes(
                counts._codes(bases), ksize)
            h1, h2, valid = h1.reshape(-1), h2.reshape(-1), valid.reshape(-1)
            mcnt, tcnt, ccnt = sketch_ops.gather_counts_multi(samples, h1,
                                                              h2)
            fresh = (valid != 0) & (mcnt > 0) & (tcnt == 0)
            sel = torch.nonzero(fresh).reshape(-1)
            if not sel.numel():
                continue
            keys = (hashing.to_u32(h1[sel]) << 32) | hashing.to_u32(h2[sel])
            hist, first = (x.cpu().numpy()
                           for x in _fresh_histogram(ccnt[sel], keys))
            for cnt in np.argsort(first, kind='stable').tolist():
                if cnt > 0 and hist[cnt] > 0:
                    abundance[cnt] += int(hist[cnt])
            sketch_ops.mark_hashes(tracking, h1, h2, fresh.to(torch.uint8))
    kevlar_tpu_torch.plog('[kevlar::dist] Done second pass over input!')
    return abundance


def weighted_mean_std_dev(values, weights):
    mu = np.average(values, weights=weights)
    sigma = math.sqrt(np.average((np.array(values) - mu) ** 2,
                                 weights=weights))
    return mu, sigma


def calc_mu_sigma(abundance):
    total = sum(abundance.values())
    if total == 0:
        raise KevlarZeroAbundanceDistError(
            'all k-mer abundances are 0, please check input files')
    return weighted_mean_std_dev(list(abundance.keys()),
                                 list(abundance.values()))


def compute_dist(abundance):
    """Rows of (Abundance, Count, CumulativeCount, CumulativeFraction)."""
    total = sum(abundance.values())
    rows = []
    cuml = 0
    for abund, count in sorted(abundance.items()):
        assert count > 0, (abund, count)
        cuml += count
        rows.append({
            'Abundance': abund,
            'Count': count,
            'CumulativeCount': cuml,
            'CumulativeFraction': cuml / total,
        })
    return rows


def write_dist_tsv(rows, outstream):
    fields = ['Abundance', 'Count', 'CumulativeCount', 'CumulativeFraction']
    print(*fields, sep='\t', file=outstream)
    for row in rows:
        print(*[row[f] for f in fields], sep='\t', file=outstream)


def _abundance_oxli(infiles, mask, ksize, memory):
    """khmer-engine distribution for khmer-format masks (hash spaces
    cannot mix): masked counting + tracking-deduped histogram, matching
    the reference's two khmer passes (dist.py:25-79), on the host."""
    from kevlar_tpu_torch.oxli import OxliSketch
    counts = OxliSketch(ksize, int(memory) // 4, 4, counter_bits=8)
    kevlar_tpu_torch.plog('[kevlar::dist] Processing input')
    for filename in infiles:
        kevlar_tpu_torch.plog('    -', filename)
        counts.consume_seqfile(filename, mask=mask, threshold=1,
                               consume_masked=True)
    kevlar_tpu_torch.plog('[kevlar::dist] Done processing input!')
    kevlar_tpu_torch.plog('[kevlar::dist] Second pass over the data')
    tracking = OxliSketch(ksize, counts.hashsizes(), counter_bits=1)
    abundance = defaultdict(int)
    for filename in infiles:
        kevlar_tpu_torch.plog('    -', filename)
        hist = counts.abundance_distribution(filename, tracking)
        for i, count in enumerate(hist.tolist()):
            if i > 0 and count > 0:
                abundance[i] += count
    kevlar_tpu_torch.plog('[kevlar::dist] Done second pass over input!')
    return abundance


def dist(infiles, mask, ksize=31, memory=1e6, threads=1, device='cuda'):
    from kevlar_tpu_torch.oxli import OxliSketch
    if isinstance(mask, OxliSketch):
        abundance = _abundance_oxli(infiles, mask, ksize, memory)
    else:
        counts = Sketch(ksize, int(memory) // 4, 4, counter_bits=8,
                        device=device)
        count_first_pass(infiles, counts, mask)
        abundance = count_second_pass(infiles, counts, mask)
    mu, sigma = calc_mu_sigma(abundance)
    data = compute_dist(abundance)
    return mu, sigma, data


def main(args):
    from kevlar_tpu_torch import sketch as sketch_mod
    mask = sketch_mod.load(args.mask, device=args.device)
    mu, sigma, data = dist(
        args.infiles, mask, ksize=args.ksize, memory=args.memory,
        threads=args.threads, device=args.device)
    out = {'mu': mu, 'sigma': sigma}
    print(json.dumps(out))
    if args.tsv:
        with kevlar_tpu_torch.open(args.tsv, 'w') as fh:
            write_dist_tsv(data, fh)
    if args.plot:
        try:
            import matplotlib
            matplotlib.use('Agg')
            from matplotlib import pyplot as plt
        except ImportError:
            kevlar_tpu_torch.plog('[kevlar::dist] matplotlib unavailable; '
                                  'skipping plot')
            return
        matplotlib.rcParams['figure.figsize'] = [12, 6]
        plt.plot([r['Abundance'] for r in data],
                 [r['Count'] for r in data], color='blue')
        plt.axvline(x=mu, color='blue', linestyle='--')
        plt.axvline(x=mu - sigma, color='red', linestyle=':')
        plt.axvline(x=mu + sigma, color='red', linestyle=':')
        if args.plot_xlim:
            plt.xlim(args.plot_xlim)
        plt.xlabel('K-mer abundance')
        plt.ylabel('Frequency')
        plt.savefig(args.plot, dpi=300)
