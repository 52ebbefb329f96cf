"""Genomes drawn on the device from a seeded generator.

:func:`uniform` is a genome of independent uniform bases, as kevlar's
quick-start simulates one.  :func:`repeats` adds the repeat structure of a
human chromosome, as the kevlar paper's chr17 trio has it (the classes and
shares of ``kevlar_tpu_torch.bench.bigsim.simulate_repeat_genome``, drawn
here in bulk on the device): SINE-class 300 bp elements at 12% divergence
over 10% of the genome, 5'-truncated copies of a 6 kb LINE-class element
at 12% over 17%, tandem repeats of 2-50 bp units at 2% over 3%, and
segmental duplications of 20-50 kb at 2% over 5%, placed in that order,
later copies over earlier ones.  Bases are codes 0-3 in a uint8 tensor.
"""

import torch


def randint(gen, low, high, shape):
    """int64 draws in ``[low, high)``; ``high`` may be a tensor."""
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float64)
    return low + (u * (high - low)).to(torch.int64)


def diverge(gen, bases, rate):
    """``bases`` with each base changed, at ``rate``, to one of the other
    three (uniformly)."""
    hit = torch.rand(bases.shape, generator=gen, device=gen.device) < rate
    turn = torch.randint(1, 4, bases.shape, generator=gen, device=gen.device,
                         dtype=torch.uint8)
    return torch.where(hit, (bases + turn) & 3, bases)


def uniform(gen, size):
    """``size`` uniform random bases."""
    return torch.randint(0, 4, (size,), generator=gen, device=gen.device,
                         dtype=torch.uint8)


def _lengths_to_budget(gen, low, high, budget):
    """Lengths drawn uniformly in ``[low, high]`` until they sum to at
    least ``budget`` (the last one crossing it)."""
    most = budget // low + 1
    lengths = randint(gen, low, high + 1, (most,))
    total = lengths.cumsum(0)
    return lengths[:int((total < budget).sum()) + 1]


def _segments(starts, lengths):
    """Flat ``(copy, offset)`` of every base of copies of ``lengths``."""
    copy = torch.repeat_interleave(torch.arange(len(lengths),
                                                device=lengths.device),
                                   lengths)
    first = lengths.cumsum(0) - lengths
    offset = torch.arange(int(lengths.sum()), device=lengths.device) - \
        first[copy]
    return copy, offset


def repeats(gen, size):
    """``size`` bases with hg38-class repeats (see the module's text)."""
    dev = gen.device
    genome = uniform(gen, size)
    where, what = [], []

    # SINE-class: copies of one 300 bp consensus
    sine = uniform(gen, 300)
    n = int(0.10 * size / 300)
    starts = randint(gen, 0, size - 300, (n,))
    lengths = torch.full((n,), 300, dtype=torch.int64, device=dev)
    copy, offset = _segments(starts, lengths)
    where.append(starts[copy] + offset)
    what.append(diverge(gen, sine[offset], 0.12))

    # LINE-class: the 3' ends of one 6 kb consensus
    line = uniform(gen, 6000)
    lengths = _lengths_to_budget(gen, 500, 6000, int(0.17 * size))
    starts = randint(gen, 0, size - lengths, lengths.shape)
    copy, offset = _segments(starts, lengths)
    where.append(starts[copy] + offset)
    what.append(diverge(gen, line[6000 - lengths[copy] + offset], 0.12))

    # tandem repeats: 10 or more copies of a 2-50 bp unit
    budget = int(0.03 * size)
    units = _lengths_to_budget(gen, 2, 50, budget // 10)
    ncopies = randint(gen, 10, torch.clamp(2000 // units, min=11),
                       units.shape)
    lengths = units * ncopies
    keep = int((lengths.cumsum(0) < budget).sum()) + 1
    units, lengths = units[:keep], lengths[:keep]
    unit_bases = uniform(gen, keep * 50).reshape(keep, 50)
    starts = randint(gen, 0, size - lengths, lengths.shape)
    copy, offset = _segments(starts, lengths)
    where.append(starts[copy] + offset)
    what.append(diverge(gen, unit_bases[copy, offset % units[copy]], 0.02))

    # later copies over earlier ones: each base keeps its last writer
    where = torch.cat(where)
    what = torch.cat(what)
    order = torch.arange(len(where), device=dev)
    last = torch.full((size,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, where, order, reduce='amax')
    won = last[where] == order
    genome[where[won]] = what[won]

    # segmental duplications, each copied from the genome as it then is
    lengths = _lengths_to_budget(gen, 20_000, 50_000, int(0.05 * size))
    src = randint(gen, 0, size - lengths, lengths.shape).tolist()
    dst = randint(gen, 0, size - lengths, lengths.shape).tolist()
    for ln, s, d in zip(lengths.tolist(), src, dst):
        genome[d:d + ln] = diverge(gen, genome[s:s + ln].clone(), 0.02)
    return genome
