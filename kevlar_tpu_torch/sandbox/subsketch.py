"""Sample selected sequences' k-mer counts out of a sketch into a new
(smaller) sketch.

For each canonical k-mer of the given sequences, reads its count in the
source sketch and adds it that many times to a freshly allocated sketch
of the requested type/size, then reports the estimated FPR (behavior
spec: reference kevlar/sandbox/subsketch.py).
"""

import argparse

from kevlar_tpu_torch import dna, sketch


# sketch-type name -> (count, smallcount, graph) allocator traits
ALLOCATORS = {
    'nodegraph': (False, False, True),
    'countgraph': (True, False, True),
    'smallcountgraph': (True, True, True),
    'nodetable': (False, False, False),
    'counttable': (True, False, False),
    'smallcounttable': (True, True, False),
}


def main(argv=None):
    cli = argparse.ArgumentParser(prog='kevlar-tpu-torch-subsketch')
    cli.add_argument('--sketch-type', metavar='T',
                     choices=sorted(ALLOCATORS), default='counttable',
                     help='Sketch type to use for output')
    cli.add_argument('--num-tables', type=int, default=4, metavar='N')
    cli.add_argument('--table-size', type=int, default=1000, metavar='X')
    cli.add_argument('--device', default='cuda', metavar='DEV',
                     help='torch device of both sketches: "cuda" (default; '
                          'the new sketch counts through the CUDA kernels) '
                          'or "cpu" (their plain PyTorch versions)')
    cli.add_argument('sketch', help='original sketch')
    cli.add_argument('subsketch', help='new sketch to create')
    cli.add_argument('sequence', nargs='+',
                     help='sequences to sample from sketch')
    args = cli.parse_args(argv)

    src = sketch.load(args.sketch, device=args.device)
    count, smallcount, graph = ALLOCATORS[args.sketch_type]
    sub = sketch.allocate(src.ksize(), args.table_size, args.num_tables,
                          count=count, smallcount=smallcount, graph=graph,
                          device=args.device)

    kmers = set()
    for seq in args.sequence:
        for kmer in src.get_kmers(seq):
            kmers.add(dna.revcommin(kmer))
    for kmer in sorted(kmers):
        for _ in range(src.get(kmer)):
            sub.add(kmer)

    sub.save(args.subsketch)
    print('Estimated FPR: {:.4f}'.format(sketch.estimate_fpr(sub)))


if __name__ == '__main__':
    main()
