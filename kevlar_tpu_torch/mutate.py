"""``mutate`` stage: apply an explicit mutation table to a genome.

The table is whitespace-delimited ``seqid pos type data`` rows (types snv /
ins / del / inv; contract: reference kevlar/mutate.py:41-106). SNV data is
a base rotation count through the A→C→G→T cycle; per sequence, mutations
apply in descending-position order so earlier edits don't shift later
coordinates.
"""

from collections import defaultdict, namedtuple

import kevlar_tpu_torch
from kevlar_tpu_torch.sequence import Record, parse_augmented_fastx, write_record

Mutation = namedtuple('Mutation', 'seq pos type data')

_BASES = 'ACGT'


def mutate_snv(sequence, mutation):
    at = mutation.pos
    rotated = _BASES[(_BASES.index(sequence[at]) + int(mutation.data)) % 4]
    return ''.join((sequence[:at], rotated, sequence[at + 1:]))


def mutate_insertion(sequence, mutation):
    at = mutation.pos
    return ''.join((sequence[:at], mutation.data, sequence[at:]))


def mutate_deletion(sequence, mutation):
    at = mutation.pos
    return sequence[:at] + sequence[at + int(mutation.data):]


def mutate_inversion(sequence, mutation):
    at, span = mutation.pos, int(mutation.data)
    flipped = sequence[at:at + span][::-1]
    return ''.join((sequence[:at], flipped, sequence[at + span:]))


_APPLY = {
    'snv': mutate_snv,
    'ins': mutate_insertion,
    'del': mutate_deletion,
    'inv': mutate_inversion,
}


def load_mutations(instream, logstream=None):
    table = defaultdict(list)
    total = 0
    for line in instream:
        row = line.strip()
        if not row or row.startswith('#'):
            continue
        fields = row.split()
        if len(fields) != 4:
            raise ValueError('error parsing mutation: ' + line)
        seqid, pos, vartype, data = fields
        if vartype not in _APPLY:
            raise ValueError('invalid variant type "{:s}"'.format(vartype))
        table[seqid].append(Mutation(seqid, int(pos), vartype, data))
        total += 1
    kevlar_tpu_torch.plog('    loaded {:d} mutations on {:d} sequences'.format(
        total, len(table)))
    return table


def mutate_sequence(sequence, mutlist):
    for mutation in mutlist:
        sequence = _APPLY[mutation.type](sequence, mutation)
    return sequence


def mutate_genome(infile, mutations):
    for record in parse_augmented_fastx(kevlar_tpu_torch.open(infile, 'r')):
        seq = record.sequence
        todo = mutations.get(record.name)
        if todo:
            seq = mutate_sequence(
                seq, sorted(todo, key=lambda m: m.pos, reverse=True))
        yield Record(name=record.name, sequence=seq)


def main(args):
    kevlar_tpu_torch.plog('[kevlar::mutate] loading mutations')
    mutations = load_mutations(kevlar_tpu_torch.open(args.mutations, 'r'))
    kevlar_tpu_torch.plog('[kevlar::mutate] mutating genome')
    outstream = kevlar_tpu_torch.open(args.out, 'w')
    for record in mutate_genome(args.genome, mutations):
        write_record(record, outstream)
