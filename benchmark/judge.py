"""Judging the screen's output, and ``kevlar unband``'s merge of several
bands' outputs: augmented FASTQ text read back and held against the
reference's hits.

The novel stage writes each read that holds a hit as its FASTQ record,
followed by one line for each hit: the hit's k-mer under its place in the
read (``offset`` spaces first), ten spaces, the hit's count in each sample
separated by spaces, and ``#``.
"""


def parse(text, ksize):
    """``[(name, sequence, [(offset, kmer, counts), ...]), ...]`` of an
    augmented FASTQ text."""
    lines = text.split('\n')
    out = []
    i = 0
    while i < len(lines) and lines[i]:
        head = lines[i]
        if head[0] != '@' or i + 3 >= len(lines):
            raise ValueError('not a FASTQ record at line {}: {!r}'.format(
                i + 1, head[:80]))
        name, seq = head[1:], lines[i + 1]
        i += 4
        hits = []
        while i < len(lines) and lines[i].endswith('#'):
            line = lines[i]
            rest = line.lstrip(' ')
            offset = len(line) - len(rest)
            counts = tuple(int(x) for x in rest[ksize:-1].split())
            hits.append((offset, rest[:ksize], counts))
            i += 1
        out.append((name, seq, hits))
    return out


def compare(text, expected, sequence_of, index_of, ksize):
    """``(missing, extra, wrong)`` hits of one screen's ``text`` against
    ``expected``, a dict ``(read, offset) -> counts``.  ``sequence_of(read)``
    is a read's bases as text and ``index_of(name)`` the read a name names.
    A hit is wrong where its read's sequence, its k-mer or its counts
    differ from the reference's; it is extra where the reference has no
    hit there."""
    try:
        records = parse(text, ksize)
    except ValueError:
        # text that is not augmented FASTQ holds none of the hits
        return len(expected), 1, 0
    seen = set()
    extra = wrong = 0
    for name, seq, hits in records:
        try:
            read = index_of(name)
            truth = sequence_of(read)
        except (ValueError, IndexError):
            extra += len(hits)
            continue
        for offset, kmer, counts in hits:
            key = (read, offset)
            if key in seen or key not in expected:
                extra += 1
                continue
            seen.add(key)
            if seq != truth or kmer != truth[offset:offset + ksize] or \
                    counts != expected[key]:
                wrong += 1
    return len(expected) - len(seen), extra, wrong


def compare_merged(text, expected, sequence_of, index_of, ksize):
    """Reads of one merged output ``text`` (``kevlar unband``'s) that
    differ from ``expected``, a dict ``read -> ((offset, counts), ...)``
    sorted by offset: a read missing, a read extra (a second record of a
    read counts too) and a read whose sequence or list of hits, in order,
    differs from the reference's."""
    try:
        records = parse(text, ksize)
    except ValueError:
        return len(expected) + 1
    seen = set()
    extra = wrong = 0
    for name, seq, hits in records:
        try:
            read = index_of(name)
            truth = sequence_of(read)
        except (ValueError, IndexError):
            extra += 1
            continue
        if read in seen or read not in expected:
            extra += 1
            continue
        seen.add(read)
        want = [(offset, truth[offset:offset + ksize], counts)
                for offset, counts in expected[read]]
        if seq != truth or hits != want:
            wrong += 1
    return len(expected) - len(seen) + extra + wrong
