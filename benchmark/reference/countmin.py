"""Count-Min counting and the novel-k-mer screen in plain PyTorch.

:func:`count` is what a trio sample's sketch must hold after its reads are
counted: every valid k-window adds one to its bucket in each of the
``ntables`` tables (a window that the mask holds is left out), and each
counter then saturates at the counter width's largest value.  :func:`screen`
is the novel screen: a window of a case read is a hit when its count, the
least over the tables, is at least ``casemin`` in the case sample and at
most ``ctrlmax`` in every control.  Both read only the inputs the benchmark
made (base codes) and tables this module made itself; the system's
outputs are read only to be judged (:func:`unpack`).

Hash bands (kevlar's ``--num-bands N --band b``, ``count.py`` and
``novel.py``): band ``b`` of ``N`` (``N`` a power of two, ``b`` from 0)
keeps only the windows whose ``h1 % N`` is ``b``, so that a trio's k-mers
are counted and screened in ``N`` passes, each with one band's tables;
:func:`unband` is ``kevlar unband``'s merge of the bands' screens.
"""

import torch

from benchmark.reference import kmers


def least_count(tables, h1, h2):
    """Count of each hashed window in ``tables`` (uint8 [T, Z] counter
    values): the least over the tables, as int32."""
    tablesize = tables.shape[1]
    out = None
    for t in range(tables.shape[0]):
        c = tables[t][kmers.bucket(h1, h2, t, tablesize)].to(torch.int32)
        out = c if out is None else torch.minimum(out, c)
    return out


def in_band(h1, band):
    """Which hashed windows band ``band = (b, N)`` keeps: those with ``h1 %
    N == b``."""
    b, numbands = band
    return (h1 % numbands) == b


def count(batches, ksize, ntables, tablesize, maxcount, mask=None,
          touched=None, band=None):
    """Counter values (uint8 [ntables, tablesize]) after counting every
    batch of base codes (uint8 [B, L] tensors) in ``batches``.  ``mask``,
    where given, is a uint8 [T, Zm] table of presence values: a window
    whose least mask value is above 0 is not counted.  ``band``, where
    given, is ``(b, N)``: only band ``b``'s windows are counted.
    ``touched``, where given, is a list that receives for each batch
    ``(kept, distinct)``: the windows counted and the distinct ``(table,
    bucket)`` pairs they touch."""
    device = batches[0].device
    acc = torch.zeros((ntables, tablesize), dtype=torch.int32, device=device)
    for codes in batches:
        h1, h2, valid = kmers.hashes(codes, ksize)
        h1, h2, keep = h1.reshape(-1), h2.reshape(-1), valid.reshape(-1)
        if band is not None:
            keep = keep & in_band(h1, band)
        if mask is not None:
            keep = keep & (least_count(mask, h1, h2) == 0)
        h1, h2 = h1[keep], h2[keep]
        keys = []
        for t in range(ntables):
            idx = kmers.bucket(h1, h2, t, tablesize)
            acc[t].index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
            if touched is not None:
                keys.append(idx + t * tablesize)
        if touched is not None:
            touched.append((int(h1.numel()),
                            int(torch.unique(torch.cat(keys)).numel())))
    return acc.clamp_(max=maxcount).to(torch.uint8)


def screen(reads, samples, ncase, ksize, casemin, ctrlmax, rows,
           words=None, band=None):
    """Hits of the novel screen over ``reads`` (uint8 [N, L] base codes).

    ``samples`` are uint8 [T, Z] counter tables, the ``ncase`` case
    samples first.  ``band``, where given, is ``(b, N)``: only band
    ``b``'s windows can be hits.  Returns ``(read, offset, abund)``: int64
    [H] read rows and window offsets in ascending order, and uint8 [S, H]
    counts.  ``words``, where given, is a list that receives for each
    batch of ``rows`` reads the number of distinct ``(table, bucket)``
    words the predicates of the band's valid windows need: one where some
    table's case count is below ``casemin`` (table 0's), else every
    table's.  The reads are hashed 16 batches at a time."""
    out_read, out_off, out_ab = [], [], []
    ntables, tablesize = samples[0].shape
    for start in range(0, reads.shape[0], 16 * rows):
        codes = reads[start:start + 16 * rows]
        h1, h2, valid = kmers.hashes(codes, ksize)
        windows = h1.shape[1]
        h1, h2, valid = h1.reshape(-1), h2.reshape(-1), valid.reshape(-1)
        if band is not None:
            valid = valid & in_band(h1, band)
        counts = [least_count(s, h1, h2) for s in samples]
        hit = valid.clone()
        for s, c in enumerate(counts):
            hit &= (c >= casemin) if s < ncase else (c <= ctrlmax)
        flat = torch.nonzero(hit).reshape(-1)
        out_read.append(flat // windows + start)
        out_off.append(flat % windows)
        out_ab.append(torch.stack([c[flat] for c in counts]).to(torch.uint8))
        if words is not None:
            # each window's key offset by its batch's, so that one unique
            # counts the words of each batch apart
            span = ntables * tablesize
            batch = (torch.arange(h1.numel(), device=h1.device) //
                     (windows * rows))[valid] * span
            h1, h2 = h1[valid], h2[valid]
            low = torch.zeros_like(h1, dtype=torch.bool)
            for t in range(ntables):
                idx = kmers.bucket(h1, h2, t, tablesize)
                for s in range(ncase):
                    low |= samples[s][t][idx] < casemin
            keys = [kmers.bucket(h1, h2, 0, tablesize) + batch]
            for t in range(1, ntables):
                idx = kmers.bucket(h1[~low], h2[~low], t, tablesize)
                keys.append(idx + t * tablesize + batch[~low])
            found = torch.unique(torch.cat(keys)) // span
            words.extend(torch.bincount(
                found, minlength=-(-codes.shape[0] // rows)).tolist())
    return (torch.cat(out_read), torch.cat(out_off),
            torch.cat(out_ab, dim=1))


def unband(bands):
    """``kevlar unband``'s result from each band's screen: ``bands`` holds
    for each band ``(read, offset, abund)`` as :func:`screen` returns it.
    Returns a dict: each read with a hit in any band, once, to the tuple
    of its hits over all bands, ``(offset, counts)`` sorted by offset."""
    out = {}
    for read, offset, abund in bands:
        for r, o, c in zip(read.tolist(), offset.tolist(),
                           abund.t().tolist()):
            out.setdefault(r, []).append((o, tuple(c)))
    return {r: tuple(sorted(hits)) for r, hits in out.items()}


def pack(values, counter_bits):
    """The packed rows (uint8 [T, ceil(Z * counter_bits / 8)]) of counter
    values: :func:`unpack`'s layout, the bits past the last bucket 0."""
    if counter_bits == 8:
        return values.contiguous()
    per_byte = 8 // counter_bits
    pad = (-values.shape[1]) % per_byte
    values = torch.nn.functional.pad(values, (0, pad)).to(torch.int32)
    shifts = torch.arange(per_byte, device=values.device) * counter_bits
    words = values.reshape(values.shape[0], -1, per_byte) << shifts
    return words.sum(dim=2).to(torch.uint8)


def unpack(packed, counter_bits, tablesize):
    """Counter values (uint8 [T, tablesize]) of a table row set held
    ``counter_bits`` to a counter, least significant bits first: bucket
    ``i`` in bits ``counter_bits * (i % per_byte)`` of byte ``i //
    per_byte``.  This reads a sketch as the system keeps it, to judge it."""
    if counter_bits == 8:
        return packed[:, :tablesize]
    per_byte = 8 // counter_bits
    shifts = torch.arange(per_byte, device=packed.device,
                          dtype=torch.uint8) * counter_bits
    values = (packed[:, :, None] >> shifts) & ((1 << counter_bits) - 1)
    return values.reshape(packed.shape[0], -1)[:, :tablesize]
