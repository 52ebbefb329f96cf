"""Read records with "interesting k-mer" annotations + augmented FASTX I/O.

Behavioral parity with the reference's sequence module
(kevlar/sequence.pyx): the augmented FASTX format is the
exchange contract between pipeline stages (docs/formats.rst) — a normal
FASTA/FASTQ record followed by indented k-mer lines
``{' '*offset}{kmerseq}{10 spaces}{abund abund ...}#`` and optional
``#mateseq=SEQ#`` lines.

Host-side only.
"""

from collections import namedtuple
import re

from kevlar_tpu_torch.dna import revcom

KmerOfInterest = namedtuple('KmerOfInterest', 'ksize offset abund')


class Record:
    __slots__ = ('name', 'sequence', 'quality', 'annotations', 'mates',
                 'ikmers')

    def __init__(self, name, sequence, quality=None, annotations=None,
                 mates=None, ikmers=None):
        self.name = name
        self.sequence = sequence
        self.quality = quality
        self.mates = [] if mates is None else mates
        if annotations is None:
            self.annotations = []
            self.ikmers = {}
        else:
            self.annotations = annotations
            if ikmers is None:
                self.ikmers = {}
                for kmer in annotations:
                    kmerseq = self.ikmerseq(kmer)
                    self.ikmers[kmerseq] = kmer
                    self.ikmers[revcom(kmerseq)] = kmer
            else:
                self.ikmers = ikmers

    def __len__(self):
        return len(self.sequence)

    def add_mate(self, mateseq):
        self.mates.append(mateseq)

    def annotate(self, sequence, offset, abundances):
        checkseq = self.sequence[offset:offset + len(sequence)]
        assert checkseq == sequence, (checkseq, sequence)
        ikmer = KmerOfInterest(len(sequence), offset, abundances)
        self.annotations.append(ikmer)
        self.ikmers[sequence] = ikmer
        self.ikmers[revcom(sequence)] = ikmer

    @property
    def id(self):
        return self.name.split()[0]

    def ikmerseq(self, ikmer):
        return self.sequence[ikmer.offset:ikmer.offset + ikmer.ksize]


def copy_record(record):
    qual = getattr(record, 'quality', None)
    return Record(record.name, record.sequence, qual)


def print_augmented_fastx(record, outstream):
    if record.quality is not None:
        recstr = '@{}\n{}\n+\n{}\n'.format(record.name, record.sequence,
                                           record.quality)
    else:
        recstr = '>{}\n{}\n'.format(record.name, record.sequence)
    if record.annotations:
        annstrs = []
        for kmer in sorted(record.annotations, key=lambda k: k.offset):
            abundstr = ' '.join(str(a) for a in kmer.abund)
            annstrs.append('{}{}{}{}#'.format(
                ' ' * kmer.offset,
                record.sequence[kmer.offset:kmer.offset + kmer.ksize],
                ' ' * 10, abundstr))
        recstr += '\n'.join(annstrs) + '\n'
    if record.mates:
        recstr += '\n'.join(
            '#mateseq={:s}#'.format(m) for m in record.mates) + '\n'
    try:
        outstream.write(bytes(recstr, 'ascii'))
    except TypeError:
        outstream.write(recstr)


write_record = print_augmented_fastx


def parse_augmented_fastx(instream):
    """Parse augmented FASTA/FASTQ records (generator)."""
    record = None
    for line in instream:
        if line.strip() == '':
            continue
        firstchar = line[0]
        if firstchar in ('@', '>'):
            if record is not None:
                yield record
            readname = line[1:].strip()
            seq = next(instream).strip()
            if firstchar == '@':
                next(instream)
                qual = next(instream).strip()
            else:
                qual = None
            record = Record(name=readname, sequence=seq, quality=qual)
        elif line.rstrip('\n').endswith('#'):
            if line.startswith('#mateseq='):
                match = re.search(r'^#mateseq=(\S+)#', line)
                record.add_mate(match.group(1))
                continue
            offset = len(line) - len(line.lstrip())
            body = line.strip()[:-1]
            fields = re.split(r'\s+', body)
            kmer = fields.pop(0)
            abundances = tuple(int(a) for a in fields)
            record.annotate(kmer, offset, abundances)
        else:
            raise ValueError('unparseable augmented FASTX line: ' + line)
    if record is not None:
        yield record
