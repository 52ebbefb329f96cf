"""A configuration's trio, made on the device from a seed: the genome, the
variants, each sample's reads and the genome's k-mer rows for a mask.

Everything is drawn from one ``torch.Generator`` on the device, in a fixed
order, so one seed gives the same inputs on every run.  A configuration's
file gives the sizes (see ``benchmark/configs/``).
"""

import numpy as np
import torch

from benchmark.traffic import genome as genome_mod
from benchmark.traffic import reads as reads_mod
from benchmark.traffic import variants as variants_mod

SAMPLES = ('proband', 'mother', 'father')


def generator(seed, device):
    """A generator on ``device`` seeded from any whole number."""
    seq = np.random.SeedSequence(abs(int(seed)))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seq.generate_state(1, np.uint64)[0] >> 1))
    return gen


class Trio:
    """The inputs of one configuration and seed, on the device.

    ``genome`` holds the base codes; ``reads[name]`` is a sample's uint8
    ``[rows, width]`` code rows, its ``nreads[name]`` reads first and rows
    of code 4 after them up to a whole number of ``batch_rows``."""

    def __init__(self, config, seed, device, batch_rows):
        gen = generator(seed, device)
        spec = config['genome']
        draw = genome_mod.repeats if spec.get('repeats') else \
            genome_mod.uniform
        self.genome = draw(gen, int(spec['size']))
        self.variants = variants_mod.draw(gen, self.genome,
                                          config['variants'])
        rd = config['reads']
        self.readlen, self.width = int(rd['length']), int(rd['width'])
        self.reads, self.nreads = {}, {}
        for person, name in enumerate(SAMPLES):
            haps = [variants_mod.haplotype(self.genome, self.variants,
                                           person, h) for h in (0, 1)]
            n = reads_mod.count([len(h) for h in haps], int(rd['coverage']),
                                self.readlen)
            rows = -(-n // batch_rows) * batch_rows
            out = torch.full((rows, self.width), 4, dtype=torch.uint8,
                             device=device)
            got = reads_mod.draw(gen, haps, int(rd['coverage']),
                                 self.readlen, float(rd['error']), out)
            if got != n:
                raise RuntimeError('{} reads drawn for {}, not {}'.format(
                    got, name, n))
            self.reads[name], self.nreads[name] = out, n
            del haps

    def stack(self, name, batch_rows):
        """A sample's reads as ``[NB, batch_rows, width]`` batches."""
        return self.reads[name].view(-1, batch_rows, self.width)

    def genome_rows(self, ksize, width, batch_rows):
        """The genome as ``[NB, batch_rows, width]`` rows overlapping by
        ``ksize - 1`` bases, so every k-mer lies in exactly one row; the
        tail and the rows past the last hold code 4."""
        stride = width - (ksize - 1)
        nrows = -(-(len(self.genome) - ksize + 1) // stride)
        nrows = -(-nrows // batch_rows) * batch_rows
        dev = self.genome.device
        idx = torch.arange(nrows, device=dev)[:, None] * stride + \
            torch.arange(width, device=dev)
        inside = idx < len(self.genome)
        rows = torch.where(inside, self.genome[idx.clamp(
            max=len(self.genome) - 1)], 4).to(torch.uint8)
        return rows.view(-1, batch_rows, width)
