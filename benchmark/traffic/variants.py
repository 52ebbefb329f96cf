"""A trio's variants, drawn on the device from a seeded generator.

The draws follow kevlar's ``gentrio`` (``kevlar_tpu_torch.gentrio``):
SNVs turn a base into one of the other three; an insertion puts a copy of
a genome segment, changed at 5% of its bases, after a position; a deletion
removes a run of bases.  An inherited variant takes one of the 14
Mendelian genotype codes of (proband, mother, father), each code 0 for
both alleles reference, 2 for both alternate and 1 for one of the two at
random.  A de novo variant is on one of the proband's two haplotypes and
on neither parent's.  Unlike ``gentrio``, positions are drawn one to a
1,000-base slot, so that no two variants overlap and every one is
applied as drawn, and the kinds and sizes are the same for every seed
(:func:`_kinds_and_sizes`).
"""

import torch

from benchmark.traffic.genome import diverge, randint

KINDS = ('snv', 'ins', 'del')
SLOT = 1000
# (proband, mother, father) genotype codes with an alternate allele in a
# parent that Mendelian inheritance allows (gentrio's scenarios)
SCENARIOS = ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 1), (1, 0, 2),
             (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 2, 0), (1, 2, 1),
             (2, 1, 1), (2, 1, 2), (2, 2, 1), (2, 2, 2))


def _alleles(gen, codes):
    """Haplotype allele pairs of genotype codes ([N, 3] int64):
    [N, 3, 2] of 0 (reference) and 1 (alternate)."""
    first = (randint(gen, 0, 2, codes.shape) == 1).to(torch.int64)
    hap0 = torch.where(codes == 1, first, codes // 2)
    hap1 = torch.where(codes == 1, 1 - first, codes // 2)
    return torch.stack([hap0, hap1], dim=2)


def _kinds_and_sizes(gen, n, spec):
    """``n`` kinds (indices into KINDS) and sizes, the same for every seed
    and in an order drawn from it, so that every seed asks the same work:
    each kind takes its share of ``n`` by ``spec['weights']`` (largest
    remainders first), and a kind's indels take the bands of
    ``spec['sizes']`` in turn, spread evenly over each band (where
    ``gentrio`` draws kinds and sizes at random)."""
    weights = [float(spec['weights'].get(k, 0)) for k in KINDS]
    exact = [n * w / sum(weights) for w in weights]
    counts = [int(e) for e in exact]
    for i in sorted(range(len(KINDS)), key=lambda i: counts[i] - exact[i])[
            :n - sum(counts)]:
        counts[i] += 1
    bands = spec['sizes']
    kinds, sizes = [], []
    for kind, count in enumerate(counts):
        per_band = -(-count // len(bands))
        for j in range(count):
            lo, hi = bands[j % len(bands)]
            step = j // len(bands)
            kinds.append(kind)
            sizes.append(1 if kind == 0 else
                         lo + (hi - lo) * (2 * step + 1) // (2 * per_band))
    order = torch.randperm(n, generator=gen, device=gen.device)
    dev = gen.device
    return (torch.tensor(kinds, dtype=torch.int64, device=dev)[order],
            torch.tensor(sizes, dtype=torch.int64, device=dev)[order])


def draw(gen, genome, spec):
    """Variants of a trio: a dict of int64 tensors over the variants,
    sorted by position: ``pos``, ``kind`` (index into KINDS), ``size``
    (bases inserted or deleted; 1 for an SNV), ``alleles`` [N, 3, 2] (see
    :func:`_alleles`) and ``alt`` (an SNV's base, or the start of an
    insertion's bases in ``inserted``, a uint8 tensor)."""
    dev = gen.device
    size = len(genome)
    inh, dn = spec['inherited'], spec['denovo']
    fixed = dn.get('fixed')
    ndn = len(fixed) if fixed else int(dn['count'])
    ninh = int(inh['count'])
    lo_slot, hi_slot = 1, size // SLOT - 1
    slots = lo_slot + torch.randperm(hi_slot - lo_slot, generator=gen,
                                     device=dev)
    if fixed:
        # de novo variants in the span the quick-start scenario keeps to
        lo, hi = (int(f * size) // SLOT for f in dn['span'])
        inside = (slots >= lo) & (slots < hi)
        dn_slots = slots[inside][:ndn]
        inh_slots = slots[~inside][:ninh]
        dn_kind = torch.tensor([KINDS.index(k) for k, _ in fixed],
                               device=dev)
        dn_size = torch.tensor([s for _, s in fixed], device=dev)
    else:
        dn_slots, inh_slots = slots[:ndn], slots[ndn:ndn + ninh]
        dn_kind, dn_size = _kinds_and_sizes(gen, ndn, dn)
    inh_kind, inh_size = _kinds_and_sizes(gen, ninh, inh)
    scen = torch.tensor(SCENARIOS, dtype=torch.int64, device=dev)
    inh_codes = scen[randint(gen, 0, len(SCENARIOS), (ninh,))]
    dn_codes = torch.zeros((ndn, 3), dtype=torch.int64, device=dev)
    dn_codes[:, 0] = 1
    slot = torch.cat([inh_slots, dn_slots])
    kind = torch.cat([inh_kind, dn_kind])
    vsize = torch.cat([inh_size, dn_size])
    alleles = _alleles(gen, torch.cat([inh_codes, dn_codes]))
    pos = slot * SLOT + randint(gen, 0, SLOT // 2, slot.shape)
    order = torch.argsort(pos)
    pos, kind, vsize, alleles = pos[order], kind[order], vsize[order], \
        alleles[order]

    # alternate alleles: an SNV's base, an insertion's changed copy
    turn = randint(gen, 1, 4, pos.shape)
    alt = (genome[pos].to(torch.int64) + turn) & 3
    ins = kind == 1
    ins_size = vsize[ins]
    src = randint(gen, 0, size - ins_size, ins_size.shape)
    first = ins_size.cumsum(0) - ins_size
    copy = torch.repeat_interleave(torch.arange(len(ins_size), device=dev),
                                   ins_size)
    offset = torch.arange(int(ins_size.sum()), device=dev) - first[copy]
    inserted = diverge(gen, genome[src[copy] + offset], 0.05)
    alt[ins] = first
    return {'pos': pos, 'kind': kind, 'size': vsize, 'alleles': alleles,
            'alt': alt, 'inserted': inserted}


def haplotype(genome, variants, person, hap):
    """One haplotype (uint8 codes) of ``person`` (0 proband, 1 mother, 2
    father): the genome with the variants whose allele ``hap`` is
    alternate applied."""
    size = len(genome)
    pool = [genome]
    pool_len = size
    take = variants['alleles'][:, person, hap].tolist()
    pos = variants['pos'].tolist()
    kind = variants['kind'].tolist()
    vsize = variants['size'].tolist()
    alt = variants['alt'].tolist()
    snv_base = variants['alt'][variants['kind'] == 0].to(torch.uint8)
    snv_at = {}
    for i, k in enumerate(kind):
        if k == 0:
            snv_at[i] = pool_len + len(snv_at)
    pool.append(snv_base)
    ins_at = pool_len + len(snv_base)
    pool.append(variants['inserted'])
    starts, lengths = [], []
    prev = 0
    for i, on in enumerate(take):
        if not on:
            continue
        starts.append(prev)
        lengths.append(pos[i] - prev)
        if kind[i] == 0:
            starts.append(snv_at[i])
            lengths.append(1)
            prev = pos[i] + 1
        elif kind[i] == 1:
            starts.append(ins_at + alt[i])
            lengths.append(vsize[i])
            prev = pos[i]
        else:
            prev = pos[i] + vsize[i]
    starts.append(prev)
    lengths.append(size - prev)
    dev = genome.device
    starts = torch.tensor(starts, dtype=torch.int64, device=dev)
    lengths = torch.tensor(lengths, dtype=torch.int64, device=dev)
    first = lengths.cumsum(0) - lengths
    seg = torch.repeat_interleave(torch.arange(len(lengths), device=dev),
                                  lengths)
    idx = starts[seg] + torch.arange(int(lengths.sum()), device=dev) - \
        first[seg]
    return torch.cat(pool)[idx]
