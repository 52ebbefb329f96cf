"""Host sequence I/O: FASTA/FASTQ parsing and partitioned-read streams.

Behavioral contract (reference kevlar/seqio.py): partition streams group
consecutive reads sharing a ``kvcc=N`` label in the read name; mixing
labeled and unlabeled reads is an error; unlabeled input forms one group
keyed ``None``. The grouping here is built on ``itertools.groupby`` over a
label-tagging generator rather than the reference's explicit state machine.
"""

from itertools import groupby
import re

import kevlar_tpu_torch
from kevlar_tpu_torch.sequence import Record, parse_augmented_fastx

_PART_LABEL = re.compile(r'kvcc=(\d+)')


class KevlarPartitionLabelError(ValueError):
    pass


def parse_fasta(data):
    """Yield (defline, sequence) tuples from FASTA text lines."""
    defline = None
    chunks = []
    for raw in data:
        text = raw.rstrip()
        if text[:1] == '>':
            if defline is not None:
                yield defline, ''.join(chunks)
            defline = text
            chunks = []
        else:
            chunks.append(text)
    if defline is not None:
        yield defline, ''.join(chunks)


def parse_seq_dict(data):
    """Load FASTA into {seqid: sequence}, keyed on the first defline token."""
    seqs = {}
    for defline, seq in parse_fasta(data):
        key = defline[1:].replace('\t', ' ').split(' ')[0]
        assert key not in seqs, key
        seqs[key] = seq
    return seqs


def _lines(instream):
    for line in instream:
        if line.strip():
            yield line.rstrip('\n')


def parse_fastx(instream):
    """Yield plain Records from FASTA or FASTQ text (no annotations)."""
    lines = _lines(instream)
    head = next(lines, None)
    if head is None:
        return
    if head[0] == '>':
        defline = head
        body = []
        for line in lines:
            if line[0] == '>':
                yield Record(name=defline[1:].strip(),
                             sequence=''.join(body))
                defline, body = line, []
            else:
                body.append(line.strip())
        yield Record(name=defline[1:].strip(), sequence=''.join(body))
    elif head[0] == '@':
        while head is not None:
            seq = next(lines)
            next(lines)  # '+' separator
            qual = next(lines)
            yield Record(name=head[1:].strip(), sequence=seq.strip(),
                         quality=qual.strip())
            head = next(lines, None)
    else:
        raise ValueError('unrecognized sequence format: ' + head[:40])


def multi_file_iter(filenames, parser=parse_fastx):
    for filename in filenames:
        with kevlar_tpu_torch.open(filename, 'r') as fh:
            yield from parser(fh)


def afxstream(filelist):
    for infile in filelist:
        yield from parse_augmented_fastx(kevlar_tpu_torch.open(infile, 'r'))


def partition_id(readname):
    hit = _PART_LABEL.search(readname)
    return hit.group(1) if hit else None


def _tag_with_labels(readstream):
    """Yield (label, read); raise on a labeled/unlabeled mix."""
    expect_labels = None
    for read in readstream:
        name = getattr(read, 'name', None)
        if name is None:
            name = read.defline
        label = partition_id(name)
        if expect_labels is None:
            expect_labels = label is not None
        elif expect_labels != (label is not None):
            raise KevlarPartitionLabelError(
                'reads with and without partition labels (kvcc=#)')
        yield label, read


def parse_partitioned_reads(readstream):
    empty = True
    for label, group in groupby(_tag_with_labels(readstream),
                                key=lambda pair: pair[0]):
        empty = False
        yield label, [read for _, read in group]
    if empty:
        yield None, []


def parse_single_partition(readstream, partid):
    for label, reads in parse_partitioned_reads(readstream):
        if label == partid:
            yield label, reads
