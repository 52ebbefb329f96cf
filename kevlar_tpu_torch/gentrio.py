"""``gentrio`` stage: simulate a trio with inherited and de novo variants.

Generates random SNVs/insertions/deletions over a genome, assigns each an
inheritance scenario (de novo variants are proband-het, parents hom-ref),
writes two haplotype FASTAs per individual, and emits a truth VCF.
Behavioral contract: reference kevlar/gentrio.py:38-257 — left-anchored
VCF-style indel alleles, ±(k-1) REFR/ALT windows, the 14 Mendelian
genotype-code scenarios, insertions sourced from a mutagenized copy of a
random genome segment.
"""

import random
import sys

import kevlar_tpu_torch
from kevlar_tpu_torch.support import MutableString
from kevlar_tpu_torch.vcf import Variant

_BASES = 'ACGT'

DWEIGHTS = {'snv': 0.8, 'ins': 0.1, 'del': 0.1}

# (child, mother, father) genotype codes, 0=hom ref / 1=het / 2=hom alt;
# exactly the combinations consistent with Mendelian inheritance where the
# alt allele is present in at least one parent.
inheritance_scenarios = [
    (0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 1), (1, 0, 2), (1, 1, 0),
    (1, 1, 1), (1, 1, 2), (1, 2, 0), (1, 2, 1), (2, 1, 1), (2, 1, 2),
    (2, 2, 1), (2, 2, 2),
]


def _as_rng(spec):
    """Normalize a seed spec (None / int / Random) to a Random instance."""
    if isinstance(spec, random.Random):
        return spec
    if spec is None:
        spec = random.randrange(sys.maxsize)
        kevlar_tpu_torch.plog('[kevlar::gentrio] using random seed', spec)
    return random.Random(spec)


def _rotate_base(base, turns):
    return _BASES[(_BASES.index(base) + turns) % 4]


def weighted_choice(values, weights, rng=random.Random()):
    assert len(values) == len(weights)
    return rng.choices(list(values), weights=list(weights), k=1)[0]


def mutagenize(sequence, rng=None, rate=0.05):
    out = []
    for base in sequence:
        if rng and rng.random() < rate:
            base = _rotate_base(base, rng.choice([1, 2, 3]))
        out.append(base)
    return ''.join(out)


def _window(sequence, lo, hi):
    return sequence[max(lo, 0):min(hi, len(sequence))]


def mutate_snv(sequence, position, offset, ksize=31):
    refr = sequence[position]
    alt = _rotate_base(refr, offset)
    refrwindow = _window(sequence, position - ksize + 1, position + ksize)
    altwindow = (_window(sequence, position - ksize + 1, position) + alt +
                 _window(sequence, position + 1, position + ksize))
    return refr, alt, refrwindow, altwindow


def mutate_insertion(sequence, position, length, duplpos, rng=None, ksize=31):
    insseq = mutagenize(sequence[duplpos:duplpos + length], rng, rate=0.05)
    anchor = sequence[position - 1]
    refrwindow = _window(sequence, position - ksize + 1, position + ksize - 1)
    altwindow = (_window(sequence, position - ksize + 1, position) + insseq +
                 _window(sequence, position, position + ksize - 1))
    return anchor, anchor + insseq, refrwindow, altwindow


def mutate_deletion(sequence, position, length, ksize=31):
    anchor = sequence[position - 1]
    gone = sequence[position:position + length]
    refrwindow = _window(sequence, position - ksize + 1,
                         position + length + ksize - 1)
    altwindow = (_window(sequence, position - ksize + 1, position) +
                 _window(sequence, position + length,
                         position + length + ksize - 1))
    return anchor + gone, anchor, refrwindow, altwindow


def _indel_size(rng, size_bands):
    """Indel span: uniform 5-350 by default (the reference's gentrio
    draw, kevlar/gentrio.py:169/175); with ``size_bands`` a band is
    picked uniformly, then a size uniformly within it — the composition
    of the reference's published bigsim truth set, whose mutsim
    generators are size-parameterized per band (notebook/mutsim/src/
    del.cpp:5-14, snv.cpp) and land ~250-290 variants in each of the
    1-10/11-100/101-200/201-300/301-400 bp classes."""
    if not size_bands:
        return rng.randint(5, 350)
    lo, hi = rng.choice(size_bands)
    return rng.randint(lo, hi)


def parse_size_bands(spec):
    """``'1-10,11-100'`` -> [(1, 10), (11, 100)]; None/'' -> None."""
    if not spec:
        return None
    bands = []
    for part in spec.split(','):
        lo, _, hi = part.partition('-')
        bands.append((int(lo), int(hi or lo)))
    return bands


def _random_variant(sequences, rng, weights, ksize, size_bands=None):
    seqid = rng.choice(sorted(sequences.keys()))
    seq = sequences[seqid]
    position = rng.randint(0, len(seq) - 1)
    kinds = sorted(weights.keys())
    kind = weighted_choice(kinds, [weights[k] for k in kinds], rng)
    if kind == 'snv':
        alleles = mutate_snv(seq, position, rng.randint(1, 3), ksize)
    elif kind == 'ins':
        span = _indel_size(rng, size_bands)
        source = rng.randint(0, len(seq))
        alleles = mutate_insertion(seq, position, span, source, rng, ksize)
    elif kind == 'del':
        alleles = mutate_deletion(seq, position, _indel_size(rng, size_bands),
                                  ksize)
    else:
        raise ValueError('unknown mutation type {}'.format(kind))
    refr, alt, refrwindow, altwindow = alleles
    return Variant(seqid, position, refr, alt, ALTWINDOW=altwindow,
                   REFRWINDOW=refrwindow)


def generate_mutations(sequences, n=10, ksize=31, weights=DWEIGHTS, rng=None,
                       size_bands=None):
    rng = _as_rng(rng)
    for _ in range(n):
        yield _random_variant(sequences, rng, weights, ksize,
                              size_bands=size_bands)


def pick_inheritance_genotypes(rng):
    codes = rng.choice(inheritance_scenarios)
    return tuple(
        '0/0' if code == 0 else
        '1/1' if code == 2 else
        rng.choice(['0/1', '1/0'])
        for code in codes
    )


def simulate_variant_genotypes(sequences, ninh=20, ndenovo=10,
                               weights=DWEIGHTS, rng=None, size_bands=None):
    rng = _as_rng(rng)
    for variant in generate_mutations(sequences, n=ninh, weights=weights,
                                      rng=rng, size_bands=size_bands):
        variant.annotate('GT', ','.join(pick_inheritance_genotypes(rng)))
        yield variant
    for variant in generate_mutations(sequences, n=ndenovo, weights=weights,
                                      rng=rng, size_bands=size_bands):
        denovo_gt = (rng.choice(['0/1', '1/0']), '0/0', '0/0')
        variant.annotate('GT', ','.join(denovo_gt))
        yield variant


def apply_mutation(sequence, position, refr, alt):
    """Edit ``sequence`` (a MutableString) in place."""
    if len(refr) == len(alt):
        assert sequence[position] == refr
        sequence[position] = alt
    elif len(refr) < len(alt):
        sequence[position:position] = alt[1:]
    else:
        del sequence[position:position + len(refr) - len(alt)]


def weights_str_to_dict(wstring):
    raw = dict(pair.split('=') for pair in wstring.split(','))
    total = sum(float(v) for v in raw.values())
    return {kind: float(v) / total for kind, v in raw.items()}


def _haplotype_pair(sequence, seqid, variants, individual):
    """Both haplotypes of one individual for one chromosome."""
    haplos = (MutableString(sequence), MutableString(sequence))
    for variant in variants:
        if variant.seqid != seqid:
            continue
        genotype = variant.genotypes[individual]
        for hap, allele in zip(haplos, (genotype[0], genotype[2])):
            if allele != '0':
                apply_mutation(hap, variant.position, variant._refr,
                               variant._alt)
    return haplos


def gentrio(sequences, outstreams, ninh=20, ndenovo=10, weights=DWEIGHTS,
            seed=None, upint=100, logstream=sys.stderr, size_bands=None):
    assert len(outstreams) == 3
    variants = list(simulate_variant_genotypes(
        sequences, ninh=ninh, ndenovo=ndenovo, weights=weights, rng=seed,
        size_bands=size_bands))
    # apply bottom-up so positions stay valid through indel edits
    variants.sort(key=lambda v: v.position, reverse=True)

    for seqid, sequence in sequences.items():
        for individual, stream in enumerate(outstreams):
            haplos = _haplotype_pair(sequence, seqid, variants, individual)
            for hapnum, hap in enumerate(haplos, 1):
                print('>', seqid, '_haplo', hapnum, '\n', hap, sep='',
                      file=stream)

    variants.sort(key=lambda v: (v.seqid, v.position))
    yield from variants


def main(args):
    from kevlar_tpu_torch import seqio
    genomeseqs = seqio.parse_seq_dict(kevlar_tpu_torch.open(args.genome, 'r'))

    outstreams = [
        kevlar_tpu_torch.open('{:s}-{:s}.fasta'.format(args.prefix, person), 'w')
        for person in ('proband', 'mother', 'father')
    ]
    vcfout = None
    if args.vcf:
        vcfout = kevlar_tpu_torch.open(args.vcf, 'w')
        kevlar_tpu_torch.vcf_header(vcfout, source='kevlar::gentrio',
                              infoheader=True)
    for variant in gentrio(genomeseqs, outstreams, ninh=args.inherited,
                           ndenovo=args.de_novo,
                           weights=weights_str_to_dict(args.weights),
                           seed=args.seed,
                           size_bands=parse_size_bands(
                               getattr(args, 'indel_sizes', None))):
        if vcfout:
            print(variant.vcf, file=vcfout)
    for stream in outstreams:
        stream.close()
