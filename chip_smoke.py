#!/usr/bin/env python3
"""GPU smoke run of kevlar_tpu_torch: build, check and drive its slices.

    python3 chip_smoke.py        # needs one CUDA GPU; about 15 minutes
    python3 chip_smoke.py --compare-parent DIR
                                 # the aligner, the consume step, the routed
                                 # consume's kernels and a helium sample
                                 # count (unsharded and routed) of this tree
                                 # against an older checkout in DIR
    python3 chip_smoke.py --profile-workflow
                                 # the helium trio workflow under
                                 # torch.profiler: the card's busy share
    python3 chip_smoke.py --count-screen
                                 # the word gather's and the screen
                                 # kernel's checks, the fused count and
                                 # screen (phase 13) at bench.py's trio and
                                 # on random reads of helium's shape, and
                                 # phase 14's count_novel entry, without
                                 # the rest; ~2 minutes
    python3 chip_smoke.py --compare-screen DIR
                                 # the screen alone at phase 5's shapes,
                                 # the fused count and screen at helium and
                                 # the novel stage of this tree against an
                                 # older checkout in DIR; ~4 minutes
    python3 chip_smoke.py --bench-tools
                                 # the builds, the helium trio and phase 15
                                 # (the three bench tools and K4 at the
                                 # control plane's scale) without the rest
    python3 chip_smoke.py --bigsim
                                 # the builds and phase 16 (the bigsim run
                                 # at its 10 Mb cut and its forensics)
                                 # without the rest
    python3 chip_smoke.py --rank RANK WORLD PORT BACKEND SPEC
                                 # one rank of phase 12 (the smoke starts
                                 # them itself)
    python3 chip_smoke.py --workflow-only DIR
                                 # phase 15 (b)'s process (the smoke starts
                                 # it itself)

Phases (any failure raises, and the script exits non-zero):

1. card: a CUDA device must be present; print its name and power limit;
2. build: ``csrc/align.cu``, ``csrc/kmer.cu`` and ``csrc/cc.cu`` with nvcc
   for sm_90a, the C++ assembler and the FASTA/FASTQ reader with g++, all
   five compilers started together, into the package's build directory;
   print the seconds each took;
3. kernel: the ksw_extz kernel against its plain PyTorch version on the
   card, on seeded pairs at the call stage's shapes (targets 100-2,000 bp,
   queries 100-1,000 bp, a few 10,000 bp targets, queries of every strip
   width and wider than one pass of the kernel, one pair whose pass edges
   need global memory, N bases, tandem-repeat ties) under gap penalties
   (5,0), (5,2) and (3,1) and under scores wider than a byte: scores, op
   streams and exit cells must be identical (tolerance 0: the DP is
   integer arithmetic); the DP and the traceback kernels are timed apart;
4. alac slice: :func:`make_alac_case` writes a bigsim-scale input (80 Mb
   reference, 1,500 de novo loci in the bigsim class mix, 150 bp reads at
   15x from the alt haplotype, one ``kvcc=`` partition per locus); the seed
   index is built apart (timed), then ``kevlar_tpu_torch.cli.main(['alac',
   ..., '--device', 'cuda'])`` runs the slice.  Every pair the run aligned
   is aligned again with the plain version on the card (results must be
   identical, and both are timed, the kernel's DP and traceback apart),
   the kernel's launch count over the run
   must be positive, and the VCF is scored against the truth: recall below
   0.90 fails.  Then the ``call`` path from files, on the same reads:
   ``split`` into two shards, ``assemble``, ``localize`` and ``call
   --device cuda`` each; B1 must launch, and the shards' records together
   must be the alac run's.  Then the seeds phase: the alac run's seed set
   through ``SeedIndex`` with the host and the device backend on the same
   index (ranges and lookup dicts identical; the keys' copy to the card,
   the device search queued behind a spin kernel, host ``np.searchsorted``
   and each whole lookup timed, the search's bound printed), and shard 0's
   ``localize`` with ``KEVLAR_SEED_BACKEND=device`` (cutouts identical to
   the host run's; the device search must run);
5. count kernels: K1 (k-mer hashing of base codes) at k = 15, 21, 31, 32,
   33 and 51 with N bases, padding rows, row lengths that are not a
   multiple of 4, 8 or 16, rows of 1,024 bases and rows that start off a
   16-byte boundary; K2 (count gather) with 1, 3 and 9 sketches in a call,
   at 1, 4 and 8 bits, uniform and mixed, at odd and edge table sizes (1,
   2, 2^31 - 1) and with a three-table sketch; and K3 (scatter-add), from
   indices with heavy duplicates and negative indices, and from hashes
   (the consume) with a band, a mask in both senses, duplicates, odd and
   edge table sizes, three tables, unaligned views and the 2 GB
   accumulator of a sample count, and the consume's two other modes
   (counting what it kept; marking an 8-bit presence table) on the same
   inputs; each against its plain PyTorch version
   on the card (tolerance 0: integer arithmetic), then timed against it at
   the helium run's shapes; and the word gather (``kt_gather_words``, four
   samples' 8-bit counters to a uint32 word) against its plain version and
   K2 at S = 1, 4 and 5 (a partial word) and with three tables, then at
   K2's S=3 screen shape, timed beside K2 on the same tables; then the
   screen's kernel (``kt_screen_reads``: the reads hashed, the words
   gathered, the predicates tested and the hits stored at their ranks
   below a fixed capacity, in one launch) against its plain version and
   the unfused screen, on three samples' 4 x 124,999,999 tables in one
   word tensor, at the novel stage's 4,096 rows and B.1's 8,192, with the
   abundance screen off and at 3, a band, a capacity below the hits and
   every k-mer a hit, then timed behind a spin kernel beside K1 alone and
   the unfused screen (K1, the word gather, torch predicates and
   compaction);
6. count -> novel slice: :func:`make_trio_case` writes the helium trio
   (the reference's quick-start: 25 Mb genome, 30x trio of 150 bp reads
   with 0.5% errors, 20 inherited and 5 de novo variants), and the trio
   workflow's first steps run through ``kevlar_tpu_torch.cli.main`` with
   ``--device cuda``: the reference mask (1-bit, 50M), the reference count
   (4-bit, 50M), the masked 8-bit counts of the three samples (500M each)
   and the novel screen (``--case-min 5 --ctrl-max 1``: the trio's tables
   packed to words, ``kt_screen_reads`` a batch).
   K1, K2 (the counts' masks), K3's consume and the screen kernel
   must each launch during that run (K3's entry from indices is driven
   apart, through a device sketch's ``consume_hashes``, and held to the
   consume kernel's tables).  A dense screen of the proband's first 1,000
   reads (``--case-min 0 --ctrl-max 255``: every k-mer a hit, past the
   capacity of 32,768) must launch the screen kernel and then the word
   gather (the uncapped screen over the same words).  The mask, refr and
   proband tables and both novel texts must equal those of the same
   commands run with the plain versions on the card; and each de novo
   locus must have a novel read whose annotated k-mer spans it.  Stage
   walls, reads per second and the novel output's size are printed;
7. K4 (read-graph components, a one-pass union-find) against its plain
   PyTorch version, min-label propagation, on the card: seeded random
   incidences, a chain of 5,000 reads (diameter in the thousands),
   isolated reads, single-read k-mers and duplicate pairs, E = 0 and E = 1
   (labels identical: tolerance 0; each graph's kernel time printed beside
   its bound), then both timed on phase 8's incidence (so phase 7 runs
   after phase 8);
8. partition at bigsim scale: phase 4's reads with their ``kvcc=`` labels
   stripped go through ``cli.main(['partition', ..., '--device',
   'cuda'])``.  The read-k-mer pair count must reach
   ``HOST_CC_THRESHOLD`` (so K4 runs, as in ``kevlar_tpu`` the device
   program), K4's launch count must be positive, its labels must equal the
   plain version's on the card, and every partition must hold the reads
   of exactly one locus;
9. the trio workflow: ``kevlar_tpu_torch.workflow.run_mark1`` on phase 6's
   helium trio with the helium configuration of
   tools/sim_trio_bench.py (seed index built beforehand, timed apart).  K1,
   K2 (the counts' masks), K3's consume, the screen kernel (a novel batch
   each) and B1 must each launch during the run, every
   checkpoint must
   exist, the four de novo SNVs must be PASS calls at their positions, and
   no PASS call may lie more than 10 bp from a de novo locus.  Whether the
   300 bp insertion was called, the stage walls, the peak RSS and the read
   and call counts of each stage are printed.  Then the simlike phase: the
   run's preliminary calls through ``cli.main(['simlike', ..., '--device',
   'cuda'])`` on the trio's tables, host (default), with
   ``KEVLAR_SIMLIKE_BATCH=1`` (VCF text identical; K1 and K2 must launch)
   and with ``KEVLAR_SIMLIKE_DEVICE=1`` (the same PASS set, every LIKESCORE
   within rel 1e-4, abs 1e-2 of host's); and ``score_bundles`` on 100,000
   seeded trio bundles (K 0-64) on the card, timed beside its bound, 1,000
   of them held to the float64 host functions (rel 2e-5, abs 2e-3, the
   same ranking);
10. dist: ``cli.main(['dist', ..., '--device', 'cuda'])`` with the trio's
   1-bit reference mask over the proband's FASTQ (``-M 500M``).  K1, K2
   and K3's consume must each launch, mu must lie in ``DIST_MU_BAND``
   around ``DIST_MU``, and on the first 200,000 reads ``--device cuda``
   and ``--device cpu`` must print the same JSON and write the same TSV.
   Then ``Sketch.query_batch`` of one batch of reads against the proband's
   table on the card must equal the host mirror's counts.
11. sharded (``kevlar_tpu_torch.parallel``), every mesh naming this one
   card several times: after the seeds phase, the alac run's seeds through
   ``seed_ranges_sharded`` over the bigsim keys cut in 4 shards (ranges ==
   the device search's) and its pairs through B1 on a (2, 1) mesh (==
   unsharded); after phase 9, on the helium trio at ``-M 500M``: the
   proband counted on a (1, 4) mesh down the routed consume (``kt_route``,
   the all_to_all's parts, ``kt_scatter_add`` on each received bin's
   filled prefix; tables == an unsharded count), the
   case on a (2, 2) mesh with the workflow's mask re-sharded (the replicate
   consume: K2 and ``kt_consume`` with bucket ranges; tables == the
   workflow's ``case.ct``), the novel screen over the workflow's three
   tables re-sharded on (1, 4) (text == the workflow's), ``count`` and
   ``novel --shards 1`` through the CLI (== phase 6's), and a forced
   overflow (capacity 1,024: the batch re-runs down the replicate path,
   tables equal).  The routed and replicated batches, the walls and the
   launches are printed, and one batch's all_to_all is timed in both forms
   (parts and stacked) with the bytes each moved; K1, ``kt_route``,
   ``kt_scatter_add`` over parts and both range variants must launch.
   ``kt_route`` (every bin's filled prefix slot by slot, unsorted, and the
   populations: 4 and 8 shards, a whole batch, overflowing bins), the
   range variants and ``kt_scatter_add`` on the routed count's received
   parts (one owner's four [4, capacity] views from a (1, 4) mesh, into
   its 4 x 31,250,000 int32 accumulator) are held to their plain versions
   and timed after phase 5.
12. distributed (``kevlar_tpu_torch.parallel.init_distributed``), after
   phase 11, each rank a process the smoke starts once the libraries are
   built: two ranks over gloo on this card (every crossing through pinned
   host memory) count the helium proband routed on a (1, 4) mesh, two
   shards a rank (each rank's shards == phase 11's one-process (1, 4)
   count, saved to a file), then masked on a (2, 2) mesh, one data row a
   rank (shards == the workflow's ``case.ct``), then screen the first
   500,000 reads and query one batch on (2, 2) (== the same on a
   one-process (2, 2) mesh in the rank); then one NCCL rank
   (``world_size`` 1: the process-group path with NCCL's collectives on
   the card) counts routed on (1, 4) (shards == phase 11's).  K1,
   ``kt_route`` and ``kt_scatter_add`` over parts (routed), K1 and the
   range variants (masked) must launch in every rank.  Each rank's walls,
   batches, launches, the bytes it sent across ranks (a batch and in all)
   and the routed exchange's time a batch are printed beside the
   one-process (1, 4) wall of phase 11 and the card's name and power
   limit.  A failed or late rank fails the smoke.
13. count and screen as one program (B.1), after phase 6:
   ``ops.novel_ops.count_and_screen_stack_packed`` on the card at (a)
   bench.py's trio (200 kb genome, 30x, 150 bp reads padded to 160, batches
   of 8,192, 4 x 2,000,003 buckets, casemin 6, ctrlmax 1; the generators
   and numpy ``host_pipeline`` of ``kevlar_tpu_torch.bench.count_novel``,
   the port's bench.py) and (b) phase 6's
   helium FASTQ (5.0M reads a sample through the port's reader into
   [611, 8,192, 160] stacks, packed on the host, 4 x 124,999,999 buckets).
   For each: the stacks' H2D, the program's wall (best of 3 after a warm
   run, each under ``torch.cuda.set_sync_debug_mode('error')`` and ending
   in one synchronise), ``count_novel_reads_per_s`` (the case twice plus
   the controls, as bench.py counts), the interesting k-mers, the bound
   and a profiled run's device busy share; K1, ``kt_consume`` and
   ``kt_screen_reads`` must launch.  At (a) the
   interesting k-mers must equal ``host_pipeline``'s on the same reads,
   and ``host_pipeline`` on bench.py's subset gives ``vs_baseline``; at
   (b) the program runs once more with the plain versions, every output
   and table equal.
14. bench entries, after phase 13: the four entries of
   ``kevlar_tpu_torch.bench`` (the port's ``bench.py``, ``bench_call.py``,
   ``bench_configs.py`` and ``tools/sim_trio_bench.py``), each ``main``
   called in this process with ``--device cuda`` at its defaults, its
   standard output captured and printed on the smoke's lines.
   ``count_novel`` (bench.py's trio; the stacks' copies inside the timed
   region, as bench.py times it): its last line has exactly bench.py's
   keys, K1, ``kt_consume`` and ``kt_screen_reads`` launch, and its
   interesting k-mers equal phase 13 (a)'s.  ``call`` (64 loci): three
   lines with bench_call.py's metric names, B1 launches, and the 128 rows'
   (cigar, score) pairs from the card equal the plain version's on the
   CPU.  ``configs`` (400 kb, 30x, ``-M 32M``): bench_configs.py's five
   configs in order, K1, ``kt_consume``, ``kt_screen_reads`` and B1
   launch, every de novo variant a PASS call (config 4) and the sharded
   novel text equal to the unsharded one (config 5).  ``sim_trio`` (1 Mb,
   25x, 11 de novo; the helium preset's workflow is phase 9's): the
   ``trio_workflow`` line with tools/sim_trio_bench.py's keys, K1, K2,
   ``kt_consume``, ``kt_screen_reads`` and B1 launch, and the final VCF
   (its ``##fileDate`` line aside) and its score are ``kevlar_tpu``'s on
   the same draw (``SIM_TRIO_VCF_SHA256``, ``SIM_TRIO_SCORE``: 10 of 11
   de novo variants found, 12 PASS calls, 2 false positives).
15. bench tools, after phase 10, in the helium work directory: (a)
   ``python -m kevlar_tpu_torch.bench.verify_e2e --device cuda`` (the
   port's tools/verify_e2e.py: a 20 kb trio through nine stage processes)
   must exit 0 with VERIFY_PASS and three PASS calls, the de novo truth
   rows; (b) ``kevlar_tpu_torch.bench.helium_workflow_only`` (the port's
   tools/helium_workflow_only.py) on phase 6's helium trio at 30x, in a
   directory of links and a process of its own (``--workflow-only``,
   forked by a shell so that its ``ru_maxrss`` is not the smoke's): JAX's
   keys and
   ``run_mark1``'s stage names, K1, K2, ``kt_consume``,
   ``kt_screen_reads`` and B1 launched, and its PASS calls through phase
   9's de novo gate; (c) ``kevlar_tpu_torch.bench.control_plane`` (the
   port's tools/control_plane_stress.py) at scale 1 and at its default 40
   in this process: JAX's keys, K4 launched and its labels equal to the
   host union-find's; then K4 alone on the incidence of scale 40
   (4,830,162 pairs), queued behind a spin kernel, beside its plain
   version and its bound.  The wall, RSS and control-plane figures are
   printed beside the card's name and power limit.
16. bigsim, after phase 15 (the helium work directory removed): (a)
   ``kevlar_tpu_torch.bench.bigsim`` (the port's tools/bigsim_bench.py)
   in this process with ``--device cuda`` and :data:`BIGSIM_ARGV`, the
   tool's defaults cut to 1/8 (a 10 Mb repeat-rich genome, 188 de novo
   variants balanced over the six classes, 125 inherited; 30x, 2.0M reads
   a sample, 171,600,000-byte sketches), its work directory and ``--out``
   in a temporary directory: the whole pipeline (count x 3, novel,
   filter, partition, alac, refr count, simlike) through the port's
   command line; JAX's result keys and last line, K1, ``kt_consume``,
   ``kt_screen_reads`` and B1 launched, and a recall of at least
   ``MIN_RECALL`` under both the evaluation and the reference protocol;
   (b) ``kevlar_tpu_torch.bench.miss_forensics`` (the port's
   tools/miss_forensics.py) on that work directory: its misses are the
   reference protocol's missing variants, each given one stage.  The
   stage walls, both scorers' recall, FDR and per-class recall, the
   misses by stage and the peak RSS are printed beside the card's name and
   power limit.

Before the card's name, a JSON line ``{"programs": [...]}`` records the XLA
programs ported as torch (B7 ``seed_ranges``, B8 ``score_bundles``, B.1
``count_and_screen_stack_packed`` at both of phase 13's sizes): launches on
their paths, ms, the host version's ms and the bound. The last two lines of
standard output are the kernels record (JSON: B1, K1, K2, the word gather
(launched by phase 6's dense screen), ``kt_screen_reads`` (launched by
phase 9's novel stage), K3's three
entries (the consume from hashes; ``kt_scatter_add`` from indices at
phase 5's shape, launched by the trio's device recount, and over the
received parts at the routed count's shape,
launched by the sharded phase's routed count), K4 (with phase 15's shape
under ``control_plane``), ``kt_route`` and the
range variants of K2 and K3's consume, each with its launches on its path's
run, max_abs_err, ms, plain_ms, its bound on this run's inputs
(``bound_ms``, ``bound_by``: the larger of bytes over ``HBM_BYTES_PER_S``
and operations over ``OPS_PER_S``) and ``library_ms``, the time of one
PyTorch call computing the same function where there is one) and ``{"ok":
true, "device": {...}}``. The generators import nothing but numpy, so tests
import them to build small cases.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

GENOME_LEN = 80_000_000
NLOCI = 1500
READLEN = 150
COVERAGE = 15          # per haplotype
KSIZE = 31
DEFAULT_SCREEN_READS = 4096     # kevlar_tpu_torch.batch.DEFAULT_BATCH_SIZE
SEED = 20261016
MIN_RECALL = 0.90

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory, and float32 outside the tensor cores.  The kernels here
# are integer code, which runs at no more than half the float32 rate, so
# a bound by operations is lenient.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
SECTOR = 32        # bytes a random access into device memory costs
SPIN_CYCLES = 20_000_000       # ~10 ms of the card's clock
L2_BYTES = 50e6

# (class, min size, max size, share of loci): the class mix of the bigsim
# trio (ACCURACY_BIGSIM_CLASSMIX.json: 264 SNVs, ~250 per indel band)
CLASSES = [('SNVs', 0, 0, 264), ('INDELs 1-10bp', 1, 10, 248),
           ('INDELs 11-100bp', 11, 100, 247),
           ('INDELs 101-200bp', 101, 200, 247),
           ('INDELs 201-300bp', 201, 300, 247),
           ('INDELs 301-400bp', 301, 400, 247)]

_BASES = np.frombuffer(b'ACGT', dtype=np.uint8)
_RC = str.maketrans('ACGT', 'TGCA')

# The helium trio: the reference's quick-start scenario (kevlar
# docs/quick-start.rst), as tools/sim_trio_bench.py --preset helium builds
# it: a 25 Mb genome, a trio at 30x of 150 bp reads with 0.5% substitution
# errors, 20 inherited variants, and 5 de novo variants in the proband
# (4 SNVs and one 300 bp insertion, a 5%-mutated copy of another stretch
# of the genome).
HELIUM_GENOME_LEN = 25_000_000
HELIUM_COVERAGE = 30
HELIUM_ERROR = 0.005
HELIUM_INHERITED = 20
HELIUM_INSERTION = 300
SAMPLES = ('proband', 'mother', 'father')


def _revcom(seq):
    return seq.translate(_RC)[::-1]


def _canon(kmer):
    rc = _revcom(kmer)
    return kmer if kmer <= rc else rc


def _class_counts(nloci):
    """Largest-remainder apportionment of ``nloci`` over CLASSES."""
    shares = np.array([c[3] for c in CLASSES], dtype=np.float64)
    exact = nloci * shares / shares.sum()
    counts = np.floor(exact).astype(int)
    for k in np.argsort(-(exact - counts), kind='stable')[:nloci -
                                                          counts.sum()]:
        counts[k] += 1
    return counts


def _write_fasta(path, name, codes):
    seq = _BASES[codes]
    full = len(seq) // 80
    lines = np.concatenate(
        [seq[:full * 80].reshape(full, 80),
         np.full((full, 1), ord('\n'), dtype=np.uint8)], axis=1)
    with open(path, 'wb') as fh:
        fh.write(b'>' + name.encode() + b'\n')
        fh.write(lines.tobytes())
        tail = seq[full * 80:].tobytes()
        if tail:
            fh.write(tail + b'\n')


def make_alac_case(workdir, genome_len=GENOME_LEN, nloci=NLOCI,
                   seed=SEED, readlen=READLEN, coverage=COVERAGE,
                   ksize=KSIZE):
    """Write ``refr.fa`` and ``partitioned.augfastq`` into ``workdir``.

    A uniform random genome ``chr1`` carries ``nloci`` de novo variants,
    one per equal window, in the CLASSES mix (insertions and deletions
    equally likely, sizes uniform in the band).  For each locus, reads of
    ``readlen`` bp are drawn at ``coverage`` x from the alt haplotype around
    it (random starts and strands); a read is kept when it holds one of the
    locus's novel k-mers — alt k-mers spanning the variant that the local
    reference lacks — and those k-mers are annotated with abundance
    ``n 0 0``, n the number of kept reads holding them.  Each locus is one
    ``kvcc=`` partition.  Returns (refr path, reads path, truth) with truth
    a list of (pos0, ref, alt, class name) sorted by position.
    """
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, genome_len, dtype=np.uint8)
    refrpath = os.path.join(workdir, 'refr.fa')
    _write_fasta(refrpath, 'chr1', codes)
    genome = _BASES[codes].tobytes().decode()
    del codes

    classes = np.repeat(np.arange(len(CLASSES)), _class_counts(nloci))
    rng.shuffle(classes)
    flank = readlen + 50
    window = genome_len // nloci
    margin = flank + 500
    if window < 2 * margin + 400 + 1:
        raise ValueError('genome too short for {} loci'.format(nloci))
    truth = []
    readspath = os.path.join(workdir, 'partitioned.augfastq')
    qual = 'I' * readlen
    with open(readspath, 'w') as out:
        for locus, cls in enumerate(classes):
            name, lo, hi, _ = CLASSES[cls]
            pos = locus * window + margin + int(
                rng.integers(0, window - 2 * margin - 400))
            refbase = genome[pos]
            if hi == 0:
                alt = 'ACGT'[('ACGT'.index(refbase) +
                              int(rng.integers(1, 4))) % 4]
                ref, insert = refbase, alt
                var = (pos, refbase, alt)
            else:
                size = int(rng.integers(lo, hi + 1))
                if rng.random() < 0.5:
                    ins = _BASES[rng.integers(0, 4, size)].tobytes().decode()
                    ref, insert = refbase, refbase + ins
                    var = (pos, refbase, refbase + ins)
                else:
                    ref = genome[pos:pos + 1 + size]
                    insert = refbase
                    var = (pos, ref, refbase)
            truth.append(var + (name,))
            # alt haplotype around the locus; the variant occupies
            # [flank, flank + len(insert)) in its coordinates
            left = genome[pos - flank:pos]
            right = genome[pos + len(ref):pos + len(ref) + flank]
            althap = left + insert + right
            refwin = genome[pos - flank - ksize:
                            pos + len(ref) + flank + ksize]
            refkmers = {_canon(refwin[s:s + ksize])
                        for s in range(len(refwin) - ksize + 1)}
            novel = np.zeros(len(althap) - ksize + 1, dtype=bool)
            for s in range(max(0, flank - ksize + 1),
                           min(len(novel), flank + len(insert))):
                novel[s] = _canon(althap[s:s + ksize]) not in refkmers
            nreads = int(round(coverage * len(althap) / readlen))
            starts = rng.integers(0, len(althap) - readlen + 1, nreads)
            strands = rng.random(nreads) < 0.5
            span = readlen - ksize + 1
            kept = [(int(s0), bool(rc)) for s0, rc in zip(starts, strands)
                    if novel[s0:s0 + span].any()]
            abund = np.zeros(len(novel), dtype=np.int64)
            for s0, _ in kept:
                abund[s0:s0 + span] += 1
            for n, (s0, rc) in enumerate(kept):
                seq = althap[s0:s0 + readlen]
                hits = np.flatnonzero(novel[s0:s0 + span])
                if rc:
                    seq = _revcom(seq)
                    hits = hits[::-1]
                lines = ['@read{}_{} kvcc={}'.format(locus, n, locus + 1),
                         seq, '+', qual]
                for h in hits:
                    off = span - 1 - h if rc else h
                    lines.append('{}{}{}{} 0 0#'.format(
                        ' ' * off, seq[off:off + ksize], ' ' * 10,
                        abund[s0 + h]))
                out.write('\n'.join(lines) + '\n')
    truth.sort()
    return refrpath, readspath, truth


def _apply_edits(genome, edits):
    """A haplotype: ``genome`` (codes) with ``edits`` [(pos, reflen,
    alt codes)] applied, positions in genome coordinates."""
    pieces, last = [], 0
    for pos, reflen, alt in sorted(edits, key=lambda e: e[0]):
        pieces += [genome[last:pos], alt]
        last = pos + reflen
    pieces.append(genome[last:])
    return np.concatenate(pieces)


def _write_reads(path, haplotypes, coverage, readlen, error, rng):
    """Uniform 150 bp reads from each haplotype at ``coverage``/2 x, with
    substitution errors at rate ``error``, as fixed-width FASTQ records
    (``@r`` + 9 digits); the read simulation of
    tools/sim_trio_bench.py:82-123.  Returns the read count."""
    total = 0
    chunk = 250_000
    offsets = np.arange(readlen)
    with open(path, 'wb') as out:
        for hap in haplotypes:
            nreads = len(hap) * coverage // (2 * readlen)
            for off in range(0, nreads, chunk):
                m = min(chunk, nreads - off)
                starts = rng.integers(0, len(hap) - readlen, size=m)
                reads = hap[starts[:, None] + offsets]
                flat = reads.reshape(-1)
                nerr = int(rng.binomial(flat.size, error))
                where = rng.integers(0, flat.size, size=nerr)
                rot = rng.integers(1, 4, size=nerr).astype(np.uint8)
                flat[where] = (flat[where] + rot) & 3
                rl = readlen
                rec = np.empty((m, 15 + 2 * rl + 1), np.uint8)
                rec[:, 0] = ord('@')
                rec[:, 1] = ord('r')
                nums = np.arange(total + 1, total + m + 1, dtype=np.int64)
                for j in range(9):
                    rec[:, 2 + j] = (nums // 10 ** (8 - j)) % 10 + ord('0')
                rec[:, 11] = ord('\n')
                rec[:, 12:12 + rl] = _BASES[reads]
                rec[:, 12 + rl] = ord('\n')
                rec[:, 13 + rl] = ord('+')
                rec[:, 14 + rl] = ord('\n')
                rec[:, 15 + rl:15 + 2 * rl] = ord('I')
                rec[:, 15 + 2 * rl] = ord('\n')
                out.write(rec.tobytes())
                total += m
    return total


def make_trio_case(workdir, genome_len=HELIUM_GENOME_LEN,
                   coverage=HELIUM_COVERAGE, error=HELIUM_ERROR,
                   ninherited=HELIUM_INHERITED, readlen=READLEN,
                   insertion=HELIUM_INSERTION, ksize=KSIZE, seed=SEED):
    """Write the helium trio into ``workdir``: ``refr.fa`` and
    ``{proband,mother,father}.fq``.

    A uniform random genome ``chr1``; ``ninherited`` variants (SNVs and
    1-10 bp indels), each heterozygous in one parent and passed to the
    proband when it sits on that parent's transmitted haplotype; and 5 de
    novo variants on one proband haplotype each: 4 SNVs and one insertion
    of ``insertion`` bp.  Variants lie at least 2 kb apart.  Returns
    (refr path, {sample: reads path}, de novo list), each de novo entry
    ``(pos0, kind, alt-window k-mers)``: the canonical k-mers of the alt
    haplotype that overlap the variant.
    """
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    refrpath = os.path.join(workdir, 'refr.fa')
    _write_fasta(refrpath, 'chr1', genome)
    nvar = ninherited + 5
    lo, hi = genome_len // 20, genome_len - genome_len // 20
    slots = np.sort(rng.choice((hi - lo) // 2000, nvar, replace=False))
    positions = lo + slots * 2000 + rng.integers(0, 1000, nvar)
    order = rng.permutation(nvar)
    haps = {(who, h): [] for who in SAMPLES for h in (0, 1)}
    denovo = []
    for rank, pos in zip(order, positions.tolist()):
        if rank < 5:                                  # de novo
            ref = genome[pos:pos + 1]
            if rank < 4:
                alt = (ref + rng.integers(1, 4)).astype(np.uint8) & 3
                kind, new, start = 'SNV', alt, pos
            else:
                src = int(rng.integers(0, genome_len - insertion))
                new = genome[src:src + insertion].copy()
                mut = rng.random(insertion) < 0.05
                new[mut] = (new[mut] + rng.integers(
                    1, 4, int(mut.sum()))).astype(np.uint8) & 3
                alt = np.concatenate([ref, new])
                kind, start = 'INS {} bp'.format(insertion), pos + 1
            hap = int(rng.integers(0, 2))
            haps[('proband', hap)].append((pos, 1, alt))
            # the new bases with k-1 reference bases on each side
            window = np.concatenate([genome[start - ksize + 1:start], new,
                                     genome[pos + 1:pos + ksize]])
            seq = _BASES[window].tobytes().decode()
            kmers = {_canon(seq[s:s + ksize])
                     for s in range(len(seq) - ksize + 1)}
            denovo.append((pos, kind, kmers))
            continue
        size = int(rng.integers(1, 11))               # inherited
        kind = int(rng.integers(0, 3))
        ref = genome[pos:pos + 1]
        if kind == 0:
            alt = (ref + rng.integers(1, 4)).astype(np.uint8) & 3
        elif kind == 1:
            alt = np.concatenate([ref, rng.integers(0, 4, size,
                                                    dtype=np.uint8)])
        else:
            ref = genome[pos:pos + 1 + size]
            alt = genome[pos:pos + 1]
        parent = SAMPLES[1 + int(rng.integers(0, 2))]
        hap = int(rng.integers(0, 2))
        edit = (pos, len(ref), alt)
        haps[(parent, hap)].append(edit)
        if hap == 0:       # the proband gets hap 0 of each parent
            haps[('proband', 0 if parent == 'mother' else 1)].append(edit)
    reads = {}
    for i, who in enumerate(SAMPLES):
        path = os.path.join(workdir, who + '.fq')
        hapseqs = [_apply_edits(genome, haps[(who, h)]) for h in (0, 1)]
        _write_reads(path, hapseqs, coverage, readlen, error,
                     np.random.default_rng(seed + 7 * (i + 1)))
        reads[who] = path
    denovo.sort(key=lambda d: d[0])
    return refrpath, reads, denovo


def read_augfastx_kmers(path):
    """[(read name, [(annotated k-mer, abundances), ...])] of an augmented
    FASTQ file."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith('@'):
                out.append((line[1:].strip(), []))
                next(fh)
                next(fh)
                next(fh)
            elif line.rstrip('\n').endswith('#'):
                kmer, abund = line.strip()[:-1].split(None, 1)
                out[-1][1].append((kmer, abund))
    return out


def read_vcf_calls(path):
    """[(pos0, ref, alt, filter)] of the VCF's variant rows."""
    calls = []
    with open(path) as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.rstrip('\n').split('\t')
            if f[1] == '.' or f[3] == '.' or f[4] == '.':
                continue
            calls.append((int(f[1]) - 1, f[3], f[4], f[6]))
    return calls


def _same_haplotype(genome, call, var):
    """Whether two (pos0, ref, alt) edits make the same local haplotype —
    allele equality up to the placement of an indel in a repeat."""
    (cp, cref, calt), (tp, tref, talt) = call[:3], var[:3]
    if genome[cp:cp + len(cref)] != cref:
        return False
    lo = min(cp, tp) - 1
    hi = max(cp + len(cref), tp + len(tref)) + 1
    return (genome[lo:cp] + calt + genome[cp + len(cref):hi] ==
            genome[lo:tp] + talt + genome[tp + len(tref):hi])


def score_calls(genome, calls, truth, slack=500):
    """Per-class recall of ``truth`` by ``calls`` (any FILTER, and PASS
    only), matching by position and alleles; plus the PASS calls that
    match no truth variant."""
    import bisect
    calls = sorted(calls)
    cpos = [c[0] for c in calls]
    per_class = {c[0]: dict(total=0, found=0, found_pass=0)
                 for c in CLASSES}
    matched = set()
    for var in truth:
        row = per_class[var[3]]
        row['total'] += 1
        lo = bisect.bisect_left(cpos, var[0] - slack)
        hi = bisect.bisect_right(cpos, var[0] + slack)
        hits = [k for k in range(lo, hi)
                if _same_haplotype(genome, calls[k], var)]
        matched.update(hits)
        row['found'] += bool(hits)
        row['found_pass'] += any(calls[k][3] == 'PASS' for k in hits)
    total = sum(r['total'] for r in per_class.values())
    found = sum(r['found'] for r in per_class.values())
    found_pass = sum(r['found_pass'] for r in per_class.values())
    false_pass = sum(1 for k, c in enumerate(calls)
                     if c[3] == 'PASS' and k not in matched)
    return dict(per_class=per_class, total=total,
                recall=found / total, recall_pass=found_pass / total,
                false_pass=false_pass)


# ---------------------------------------------------------------- GPU run


def _nvidia_smi():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


def _kernel_pairs(rng):
    """Seeded (target, query) pairs at the call stage's shapes."""
    def rand(n):
        return _BASES[rng.integers(0, 4, n)].tobytes().decode()

    def mutate(seq):
        seq = list(seq)
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, len(seq)))
            kind = rng.integers(0, 4)
            if kind == 0:
                seq[p] = 'ACGTN'[int(rng.integers(0, 5))]
            elif kind == 1:
                seq[p:p] = rand(int(rng.integers(1, 60)))
            elif kind == 2:
                del seq[p:p + int(rng.integers(1, 60))]
            else:
                seq[p] = 'N'
        return ''.join(seq)

    pairs = []
    for _ in range(48):
        tlen = int(rng.integers(100, 2001))
        qlen = int(rng.integers(100, min(tlen, 1000) + 1))
        t = rand(tlen)
        if rng.random() < 0.25:
            q = rand(qlen)                       # unrelated
        else:
            start = int(rng.integers(0, tlen - qlen + 1))
            q = mutate(t[start:start + qlen])    # contig vs its cutout
        pairs.append((t, q or 'A'))
    # equal-score ties: units dropped from homopolymers and tandem repeats
    for unit, copies, drop in (('A', 20, 3), ('AC', 15, 2), ('ACG', 12, 1),
                               ('T', 9, 1), ('GT', 30, 7)):
        flank1, flank2 = rand(150), rand(150)
        t = flank1 + unit * copies + flank2
        pairs.append((t, flank1 + unit * (copies - drop) + flank2))
        pairs.append((flank1 + unit * (copies - drop) + flank2, t))
    return pairs


def _long_pairs(rng):
    """Targets at the --max-target-length default of 10,000 bp."""
    pairs = []
    for qlen in (800, 1000):
        t = _BASES[rng.integers(0, 4, 10000)].tobytes().decode()
        start = int(rng.integers(0, 10000 - qlen))
        q = t[start:start + qlen // 2] + 'ACGTTGCA' + \
            t[start + qlen // 2 + 40:start + qlen]
        pairs.append((t, q))
    return pairs


def _encode(pairs, device):
    import torch
    from kevlar_tpu_torch import dna
    targets, tlens = dna.encode_batch([p[0] for p in pairs])
    queries, qlens = dna.encode_batch([p[1] for p in pairs])
    return [torch.from_numpy(x).to(device)
            for x in (targets, tlens, queries, qlens)]


def _compare(kernel_out, plain_out, label):
    """Max abs difference over scores, op streams and exit cells; raises
    unless all are identical."""
    err = 0
    for name, k, p in zip(('scores', 'ops_rev', 'exit_i', 'exit_j'),
                          kernel_out, plain_out):
        if k.shape != p.shape:
            raise AssertionError('{}: {} shape {} vs plain {}'.format(
                label, name, tuple(k.shape), tuple(p.shape)))
        diff = int((k.long() - p.long()).abs().max()) if k.numel() else 0
        err = max(err, diff)
        if diff:
            bad = int((k != p).reshape(k.shape[0], -1).any(1).sum())
            raise AssertionError('{}: {} differ from the plain version in '
                                 '{} rows (max abs {})'.format(
                                     label, name, bad, diff))
    return err


def _timed(fn, *args, reps=1, spin=False, **kw):
    """(result, ms per call) by CUDA events, after one warm-up call.  With
    ``spin`` the calls queue up behind a spin kernel of a few milliseconds,
    so that the card runs them back to back and a kernel shorter than its
    launch's host time is not timed as that host time."""
    import torch
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn(*args, **kw)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def _align_times(fn, batches, reps):
    """[whole call (host clock, synchronised), DP kernel, traceback kernel]
    ms of the ksw_extz wrapper ``fn`` summed over ``batches`` of (encoded
    batch, scoring arguments), one entry per repetition; the kernels by
    the CUDA events the wrapper records around each."""
    import torch
    times = []
    for _ in range(reps):
        marks = []
        torch.cuda.synchronize()
        t0 = time.time()
        for batch, args in batches:
            marks.append([torch.cuda.Event(enable_timing=True)
                          for _ in range(3)])
            fn(*batch, events=marks[-1], **args)
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
        times.append((wall,
                      sum(e[0].elapsed_time(e[1]) for e in marks),
                      sum(e[1].elapsed_time(e[2]) for e in marks)))
    return times


def _timed_align(batch, reps=3, **kw):
    """(result, ms, dp_ms, traceback_ms) of the ksw_extz kernel wrapper on
    an encoded batch: means of ``reps`` calls after one warm-up call."""
    from kevlar_tpu_torch.ops import align_cuda
    out = align_cuda.ksw_extz_cuda(*batch, **kw)
    times = _align_times(align_cuda.ksw_extz_cuda, [(batch, kw)], reps)
    return (out,) + tuple(float(np.mean([t[k] for t in times]))
                          for k in range(3))


def _bound(nbytes, nops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` and do ``nops`` operations."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * nops / OPS_PER_S
    return ((by_bytes, 'bytes') if by_bytes >= by_ops
            else (by_ops, 'operations'))


def _table_bytes(tables, probes):
    """Bytes ``probes`` random single-counter reads of ``tables`` must
    move: a sector each, but no more than the tables hold."""
    return min(probes * SECTOR, tables.numel())


def _launch_times(fn, reps):
    """ms of each of ``reps`` calls of ``fn`` by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in events]


def phase_kernel(device):
    """Phase 3: kernel vs plain version and align_scalar on the card."""
    import torch
    from kevlar_tpu_torch.ops import align_cuda
    from kevlar_tpu_torch.ops.align import align_scalar
    rng = np.random.default_rng(SEED + 3)
    err = 0
    pairs = _kernel_pairs(rng)
    batch = _encode(pairs, device)
    for gapopen, gapextend in ((5, 0), (5, 2), (3, 1)):
        kw = dict(gapopen=gapopen, gapextend=gapextend)
        got, ms, dp_ms, tb_ms = _timed_align(batch, reps=5, **kw)
        t0 = time.time()
        ref = align_cuda.ksw_extz_plain(*batch, **kw)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.time() - t0)
        err = max(err, _compare(got, ref, 'pairs gap {}'.format(kw)))
        print('[smoke] kernel vs plain: {} pairs (T<={}, Q<={}) gap {}: '
              'identical; kernel {:.3f} ms (DP {:.3f} ms, traceback {:.3f} '
              'ms), plain {:.1f} ms'.format(
                  len(pairs), batch[0].shape[1], batch[2].shape[1], kw, ms,
                  dp_ms, tb_ms, plain_ms), flush=True)
    # scores too wide for the kernel's byte lookup: its comparing cell
    wide_scores = dict(match=3, mismatch=300, gapopen=260, gapextend=1)
    got = align_cuda.ksw_extz_cuda(*batch, **wide_scores)
    ref = align_cuda.ksw_extz_plain(*batch, **wide_scores)
    err = max(err, _compare(got, ref, 'pairs, scores {}'.format(wide_scores)))
    long_batch = _encode(_long_pairs(rng), device)
    for kw in (dict(gapopen=5, gapextend=0), dict(gapopen=3, gapextend=1)):
        got = align_cuda.ksw_extz_cuda(*long_batch, **kw)
        ref = align_cuda.ksw_extz_plain(*long_batch, **kw)
        err = max(err, _compare(got, ref, 'long pairs gap {}'.format(kw)))
    # queries wider than one pass of the kernel, the pass's right edge
    # parked in shared memory; and strips of every width (qlen 3 .. 1,070)
    t = _BASES[rng.integers(0, 4, 12000)].tobytes().decode()
    wide = [(t[:1500], t[:700] + t[9000:11000] + t[700:1500]),
            (t[2000:2600], t[3000:5600])]
    wide += [(t[q:q + 300], t[q + 20:q + 20 + q]) for q in range(3, 1100, 97)]
    wide = _encode(wide, device)
    if wide[2].shape[1] <= align_cuda.PASS_COLUMNS or \
            8 * wide[0].shape[1] > align_cuda.SMEM_LIMIT_BYTES:
        raise AssertionError('the wide pairs do not take the shared-memory '
                             'edge path')
    for kw in (dict(gapopen=5, gapextend=0), dict(gapopen=5, gapextend=2)):
        got = align_cuda.ksw_extz_cuda(*wide, **kw)
        ref = align_cuda.ksw_extz_plain(*wide, **kw)
        err = max(err, _compare(got, ref, 'wide pairs gap {}'.format(kw)))
    # the same beyond shared memory: the global-scratch path
    big = _encode([(t, t[500:6000] + t[6100:9600])], device)
    if big[2].shape[1] <= align_cuda.PASS_COLUMNS or \
            8 * big[0].shape[1] <= align_cuda.SMEM_LIMIT_BYTES:
        raise AssertionError('global-scratch case fits shared memory')
    got = align_cuda.ksw_extz_cuda(*big, gapopen=5, gapextend=2)
    ref = align_cuda.ksw_extz_plain(*big, gapopen=5, gapextend=2)
    err = max(err, _compare(got, ref, 'global-scratch pair'))
    print('[smoke] kernel vs plain: 10,000 bp targets, queries of 3 to 2,800 '
          'bp (every strip width; passes parked in shared memory), a 12,000 '
          'x 9,000 pair parked in global memory: identical', flush=True)
    # truncated random pairs, and tie pairs cut around their repeat
    small = [(t[:120], q[:100]) for t, q in pairs[:4]] + \
        [(t[130:200], q[130:195]) for t, q in pairs[-4:]]
    small += [('ACGTACGTTTGACCA', 'ACGTCGTTTGACNCA'),
              ('AAAAAAAAAACCCC', 'AAAAAAACCCC')]
    got = align_cuda.align_batch([p[0] for p in small],
                                 [p[1] for p in small], gapopen=5,
                                 gapextend=2, device=device)
    want = [align_scalar(t, q, gapopen=5, gapextend=2) for t, q in small]
    if got != want:
        raise AssertionError('kernel disagrees with align_scalar: {} vs '
                             '{}'.format(got, want))
    print('[smoke] kernel vs align_scalar: {} small pairs identical'.format(
        len(small)), flush=True)
    return err


def _max_diff(got, want, label):
    """Max abs difference of two integer tensors; raises unless equal."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError('{}: kernel gave {} {}, plain {} {}'.format(
            label, got.dtype, tuple(got.shape), want.dtype,
            tuple(want.shape)))
    diff = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if diff:
        raise AssertionError('{}: {} of {} values differ from the plain '
                             'version (max abs {})'.format(
                                 label, int((got != want).sum()),
                                 got.numel(), diff))
    return diff


def _read_bases(rng, nrows, L, readlen, nrate=0.002):
    """[nrows, L] base codes: reads of ``readlen`` with N bases at
    ``nrate``, padded with the invalid code 4 (a count batch)."""
    bases = rng.integers(0, 4, (nrows, L), dtype=np.uint8)
    bases[rng.random((nrows, L)) < nrate] = 4
    bases[:, readlen:] = 4
    return bases


# ops per k-window in K1 (roll both strands ~14, canonical pick ~5, four
# fmix32 of 8 each and the two outer xors) and per probe in K2 (index,
# reciprocal reduction, counter extraction, min)
K1_OPS_PER_WINDOW = 56
K2_OPS_PER_PROBE = 12


def _k1_bound(nrows, L, ksize):
    P = L - ksize + 1
    return _bound(nrows * L + nrows * P * 9, nrows * P * K1_OPS_PER_WINDOW)


def _k2_bound(samples, n):
    probes = sum(t.shape[0] for t, _, _ in samples) * n
    nbytes = n * (8 + len(samples)) + sum(
        _table_bytes(t, t.shape[0] * n) for t, _, _ in samples)
    return _bound(nbytes, probes * K2_OPS_PER_PROBE)


def _random_hashes(rng, n, device):
    import torch
    h = rng.integers(-2**31, 2**31, (2, n), dtype=np.int64).astype(np.int32)
    h[:, :4] = [[0, 1, -1, -2**31], [1, -1, 3, 2**31 - 1]]
    h = torch.from_numpy(h).to(device)
    return h[0], h[1]


def _random_sketch(rng, bits, tablesize, device, ntables=4):
    """(tables, bits, tablesize) of random counters on the card."""
    import torch
    from kevlar_tpu_torch.ops import sketch_ops
    width = sketch_ops.packed_width(tablesize, bits)
    if ntables * width > 1 << 26:
        tables = torch.randint(0, 256, (ntables, width), dtype=torch.uint8,
                               device=device)
    else:
        tables = torch.from_numpy(rng.integers(
            0, 256, (ntables, width), dtype=np.uint8)).to(device)
    return tables, bits, tablesize


def _word_gather_checks(device, rng, samples):
    """The word gather (``kt_gather_words``) against its plain version and
    against K2 on the same tables: S = 1, 4 and 5 (a partial word) and a
    sketch of three tables, then at K2's screen shape (``samples``: three
    4 x 124,999,999 sketches, 532,480 k-mers), timed beside K2."""
    import torch
    from kevlar_tpu_torch.ops import kmer_cuda, sketch_ops
    err = 0
    for S, T, tablesize in ((1, 4, 1_000_003), (4, 4, 999_999),
                            (5, 4, 65_537), (5, 3, 77_777)):
        tables = [torch.from_numpy(rng.integers(
            0, 256, (T, tablesize), dtype=np.uint8)).to(device)
            for _ in range(S)]
        words = sketch_ops.pack_sample_tables(tables)
        h1, h2 = _random_hashes(rng, 1_000_000, device)
        got = kmer_cuda.gather_words_cuda(words, S, h1, h2)
        label = 'word gather S={} T={}'.format(S, T)
        err = max(err, _max_diff(got, sketch_ops.gather_counts_words_plain(
            words, S, h1, h2), label),
            _max_diff(got, kmer_cuda.gather_counts_cuda(
                [(t, 8, tablesize) for t in tables], h1, h2),
                label + ' vs K2'))
    tables = [t for t, _, _ in samples]
    words, pack_ms = _timed(sketch_ops.pack_sample_tables, tables, reps=3)
    n = DEFAULT_SCREEN_READS * 130
    h1, h2 = _random_hashes(rng, n, device)
    got, ms = _timed(kmer_cuda.gather_words_cuda, words, 3, h1, h2, reps=20,
                     spin=True)
    want, plain_ms = _timed(sketch_ops.gather_counts_words_plain, words, 3,
                            h1, h2, reps=5)
    k2, k2_ms = _timed(kmer_cuda.gather_counts_cuda, samples, h1, h2,
                       reps=20, spin=True)
    err = max(err, _max_diff(got, want, 'word gather, screen shape'),
              _max_diff(got, k2, 'word gather vs K2, screen shape'))
    # h1, h2 read and a byte a sample written once; a word of each table
    # read as its sector
    ntables = words[0].shape[0]
    bound_ms, bound_by = _bound(
        n * (8 + 3) + min(ntables * n * SECTOR, 4 * words[0].numel()),
        ntables * n * K2_OPS_PER_PROBE)
    print('[smoke] K2 words gather_counts_words: identical to plain and to '
          'K2 (S = 1, 4, 5, three tables); {:,} k-mers x 3 samples in one '
          'word tensor of 4 x 124,999,999: kernel {:.4f} ms, K2 on the same '
          'tables {:.4f} ms, plain {:.3f} ms, bound {:.4f} ms by {} (4 '
          'sectors a k-mer, K2 12); pack_sample_tables {:.3f} ms'.format(
              n, ms, k2_ms, plain_ms, bound_ms, bound_by, pack_ms),
          flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, k2_ms=k2_ms,
                pack_ms=pack_ms, shape='532,480 k-mers, 3 samples packed '
                'in one word tensor of 4 x 124,999,999')

# integer operations per window in kt_screen_reads beyond K1's hashing and
# K2's probes (band, skip, the four-byte predicates, the scan's share)
SCREEN_OPS_PER_KMER = 20


def _screen_tables(device, tablesize, seed):
    """Three samples' 8-bit tables of 4 x ``tablesize`` on the card, made
    on the card from ``seed``: the case mostly at 5-39 with one counter in
    a thousand at 0-4, the controls mostly at 2-39 with one in two hundred
    at 0-1, so that with casemin 5 and ctrlmax 1 about one k-mer in a
    thousand is a hit and the abundance screen discards some reads."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tables = []
    for lo, low_hi, rate in ((5, 5, 0.001), (2, 2, 0.005), (2, 2, 0.005)):
        t = torch.randint(lo, 40, (4, tablesize), dtype=torch.uint8,
                          device=device, generator=gen)
        low = torch.rand((4, tablesize), device=device, generator=gen) < rate
        t[low] = torch.randint(0, low_hi, (int(low.sum()),),
                               dtype=torch.uint8, device=device,
                               generator=gen)
        tables.append(t)
        del low
    return tables


def _screen_batch(rng, nrows, device):
    """A read batch as the novel stage ships it: [nrows, 160] codes of 150
    bp reads with N bases, a few reads shorter than k, padding rows of
    length 0; and its lengths."""
    import torch
    bases = _read_bases(rng, nrows, BENCH_PADLEN, READLEN)
    lengths = np.full(nrows, READLEN, np.int32)
    lengths[5::97] = KSIZE - 1
    lengths[-17:] = 0
    bases[-17:] = 4
    return (torch.from_numpy(bases).to(device),
            torch.from_numpy(lengths).to(device))


def _unfused_screen(words, nsamples, ncase, codes, lengths, ksize, casemin,
                    ctrlmax, screen=None, numbands=None, band=None,
                    max_hits=32768):
    """The screen as separate launches on the card: K1, the word gather
    (``kt_gather_words``), then the predicates and the capped compaction in
    torch; the same five outputs as ``novel_screen_compact``."""
    from kevlar_tpu_torch.ops import hashing, novel_ops, sketch_ops
    h1, h2, valid = hashing.kmer_hashes_codes(codes, ksize)
    B, P = h1.shape
    counts = sketch_ops.gather_counts_words(
        words, nsamples, h1.reshape(-1), h2.reshape(-1)).reshape(
            nsamples, B, P)
    valid = valid != 0
    if numbands:
        valid = valid & ((hashing.to_u32(h1) & (numbands - 1)) == band)
    interesting, discard, skip = novel_ops.screen_predicates(
        counts, ncase, valid, codes, lengths, ksize, casemin, ctrlmax,
        screen)
    return novel_ops.compact_hits_capped(counts, interesting, max_hits) + (
        discard, skip)


def _screen_sectors(words, codes, lengths, casemin):
    """(windows, kept windows, word sectors) of the screen of ``codes``
    with no abundance screen and no band, by torch ops outside the kernel:
    a kept window (valid, its read not skipped) loads table 0's word of
    every word tensor, and the other tables' only where no case byte (byte
    0 of word tensor 0) lies below ``casemin`` there (the early exit)."""
    import torch
    from kevlar_tpu_torch.ops import hashing
    h1, h2, valid = hashing.kmer_hashes_codes(codes, KSIZE)
    B, P = h1.shape
    within = torch.arange(codes.shape[1], device=codes.device)[None, :] < \
        lengths.long()[:, None]
    skip = ((codes >= 4) & within).any(dim=1) | (lengths < KSIZE)
    kept = (valid != 0) & ~skip[:, None]
    T, Z = words[0].shape
    idx = hashing.to_u32(h1[kept]) % Z
    case0 = (words[0][0][idx] & 0xff) >= casemin
    nkept, W = int(kept.sum()), len(words)
    return B * P, nkept, W * nkept + W * (T - 1) * int(case0.sum())


def _screen_kernel_checks(device, rng, tablesize=None, nrows=None,
                          reps=20):
    """``kt_screen_reads`` against its plain version on the card (and the
    unfused screen: K1, the word gather, torch), then timed beside K1 alone
    and the unfused screen: three samples' tables of 4 x ``tablesize``
    (helium's) packed in one word tensor; batches of ``nrows`` rows (the
    novel stage's 4,096 and B.1's 8,192), the abundance screen off and at
    3, a band, a capacity below the hits, and every k-mer a hit (casemin
    0, ctrlmax 255).  Returns the kernel's record for the kernels line."""
    import torch
    from kevlar_tpu_torch.ops import hashing, kmer_cuda, novel_ops, \
        sketch_ops
    tablesize = tablesize or HELIUM_TABLESIZE
    nrows = nrows or (DEFAULT_SCREEN_READS, BENCH_BATCH)
    tables = _screen_tables(device, tablesize, SEED + 12)
    words = sketch_ops.pack_sample_tables(tables)
    del tables
    err = 0
    batches = {n: _screen_batch(rng, n, device) for n in nrows}
    cases = [(n, dict(casemin=5, ctrlmax=1, screen=None, numbands=None,
                      band=None), 32768) for n in nrows]
    cases += [(nrows[0], dict(casemin=5, ctrlmax=1, screen=3, numbands=4,
                              band=1), 32768),
              (nrows[-1], dict(casemin=5, ctrlmax=1, screen=3,
                               numbands=None, band=None), 64),
              (nrows[0], dict(casemin=0, ctrlmax=255, screen=None,
                              numbands=None, band=None), 32768)]
    hits = {}
    names = ('hit_idx', 'hit_abunds', 'n_hits', 'discard', 'skip')
    for n, kw, max_hits in cases:
        codes, lens = batches[n]
        args = (words, 3, 1, codes, lens, KSIZE, kw['casemin'],
                kw['ctrlmax'], kw['screen'], kw['numbands'], kw['band'],
                max_hits)
        label = 'screen {:,} rows, {}, max_hits {}'.format(
            n, ', '.join('{} {}'.format(k, v) for k, v in kw.items()
                         if v is not None), max_hits)
        got = kmer_cuda.screen_reads_cuda(*args)
        want = novel_ops.novel_screen_compact_plain(*args)
        unfused = _unfused_screen(*args)
        for name, g, w, u in zip(names, got, want, unfused):
            err = max(err, _max_diff(g, w, label + ' ' + name),
                      _max_diff(g, u, label + ' ' + name +
                                ' vs the unfused screen'))
        hits[label] = int(got[2])
        if max_hits < 32768 and hits[label] <= max_hits:
            raise AssertionError('{}: {} hits do not overflow'.format(
                label, hits[label]))
        del got, want, unfused
    # times at the novel stage's shape, the screen off (as run_mark1 runs
    # it), and at B.1's batch
    times = {}
    for n in nrows:
        codes, lens = batches[n]
        args = (words, 3, 1, codes, lens, KSIZE, 5, 1, None, None, None,
                32768)
        out, ms = _timed(kmer_cuda.screen_reads_cuda, *args, reps=reps,
                         spin=True)
        _, plain_ms = _timed(novel_ops.novel_screen_compact_plain, *args,
                             reps=3)
        _, k1_ms = _timed(hashing.kmer_hashes_codes, codes, KSIZE,
                          reps=reps, spin=True)
        _, unfused_ms = _timed(_unfused_screen, *args, reps=reps, spin=True)
        nhits = int(out[2])
        windows, kept, sectors = _screen_sectors(words, codes, lens, 5)
        # the codes and lengths read once, the rows' flags, the hits and
        # the capacity's padding written once; each kept window's word
        # sectors as this run's data needs them
        bound = _bound(codes.numel() + 4 * n + 2 * n + 32768 * (4 + 3) +
                       min(sectors * SECTOR, 4 * words[0].numel()),
                       windows * (K1_OPS_PER_WINDOW + SCREEN_OPS_PER_KMER)
                       + sectors * K2_OPS_PER_PROBE)
        times[n] = dict(ms=ms, plain_ms=plain_ms, k1_ms=k1_ms,
                        unfused_ms=unfused_ms, bound=bound, hits=nhits,
                        kept=kept, sectors=sectors)
        del out
    print('[smoke] kt_screen_reads: identical to its plain version and to '
          'the unfused screen on {} cases: {}; three samples in one word '
          'tensor of 4 x {:,}; {}'.format(
              len(cases), '; '.join(
                  '{}: {:,} hits'.format(k, v) for k, v in hits.items()),
              tablesize, '; '.join(
                  '{:,} x {} rows ({:,} kept windows, {:,} word sectors, '
                  '{:,} hits): kt_screen_reads {:.4f} ms (plain {:.3f} ms, '
                  'bound {:.4f} ms by {}); K1 alone {:.4f} ms; unfused '
                  'screen (K1, word gather, torch) {:.4f} ms'.format(
                      n, BENCH_PADLEN, t['kept'], t['sectors'], t['hits'],
                      t['ms'], t['plain_ms'], t['bound'][0], t['bound'][1],
                      t['k1_ms'], t['unfused_ms'])
                  for n, t in times.items())), flush=True)
    t = times[nrows[0]]
    return {'screen reads': dict(
        err=err, ms=t['ms'], plain_ms=t['plain_ms'], bound_ms=t['bound'][0],
        bound_by=t['bound'][1], library_ms=None, times=times,
        shape='{:,} x {} base codes, 3 samples in one word tensor of 4 x '
              '{:,}, capacity 32,768'.format(nrows[0], BENCH_PADLEN,
                                             tablesize))}


def phase_kmer_kernels(device):
    """Phase 5: K1, K2 and K3 against their plain versions on the card, on
    seeded inputs, then timed at the shapes of the helium run.  Returns
    {kernel: dict(err, ms, plain_ms, bound_ms, bound_by, library_ms,
    shape)}."""
    import torch
    from kevlar_tpu_torch.ops import hashing, kmer_cuda, sketch_ops
    rng = np.random.default_rng(SEED + 5)
    out = {}

    # K1: short and long k; L not a multiple of 4, 8 or 16; the 1,024
    # bucket; N bases; padding rows; rows off the 16-byte grid
    err = 0
    for k in (15, 21, 31, 32, 33, 51):
        for L, readlen in ((157, 150), (1021, 1021), (253, 61),
                           (1024, 1024), (k, k)):
            bases = _read_bases(rng, 3002, L, readlen)
            bases[-7:] = 4
            codes = torch.from_numpy(bases).to(device)[1:]
            got = kmer_cuda.kmer_hashes_cuda(codes, k)
            want = hashing.kmer_hashes_plain(codes, k)
            for name, g, w in zip(('h1', 'h2', 'valid'), got, want):
                err = max(err, _max_diff(g, w, 'K1 k={} L={} {}'.format(
                    k, L, name)))
    # the sample counts' launch (32,768 reads of 150 bp in a 160 bucket)
    # and the screen's (4,096 reads)
    times = {}
    for nrows in (32768, DEFAULT_SCREEN_READS):
        codes = torch.from_numpy(_read_bases(rng, nrows, 160, 150)).to(
            device)
        _, ms = _timed(kmer_cuda.kmer_hashes_cuda, codes, KSIZE, reps=20,
                       spin=True)
        _, plain_ms = _timed(hashing.kmer_hashes_plain, codes, KSIZE, reps=3)
        times[nrows] = (ms, plain_ms) + _k1_bound(nrows, 160, KSIZE)
    ms, plain_ms, bound_ms, bound_by = times[32768]
    out['K1'] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None,
                     shape='32,768 x 160 base codes, k=31')
    print('[smoke] K1 kmer_hashes: identical to plain at k=15/21/31/32/33/51 '
          '(L=157/1021/253/1024/k, N bases, padding rows, unaligned rows); '
          '{}'.format('; '.join(
              '{:,} x 160, k=31: kernel {:.4f} ms, plain {:.3f} ms, bound '
              '{:.4f} ms by {}'.format(n, *times[n]) for n in times)),
          flush=True)

    # K2: 1, 3 and 9 sketches a call; 1, 4 and 8 bits, uniform and mixed;
    # odd and edge table sizes; a sketch of three tables
    err = 0
    h1, h2 = _random_hashes(rng, 1_000_000, device)
    uniform = {bits: [_random_sketch(rng, bits, size, device)
                      for size in sizes]
               for bits, sizes in ((1, (1_000_003, 1, (1 << 31) - 1)),
                                   (4, (999_999, 2, 1_000_001)),
                                   (8, (500_001, 65_536, 1)))}
    mixed = [uniform[8][0], uniform[1][0], uniform[4][0]]
    cases = [('{} bits x{}'.format(bits, n), sketches[:n])
             for bits, sketches in uniform.items() for n in (1, 3)]
    cases += [('mixed x3', mixed), ('mixed x9', mixed * 3),
              ('three tables', [mixed[0], _random_sketch(
                  rng, 4, 77_777, device, ntables=3)])]
    for label, samples in cases:
        got = kmer_cuda.gather_counts_cuda(samples, h1, h2)
        want = sketch_ops.gather_counts_multi_plain(samples, h1, h2)
        err = max(err, _max_diff(got, want, 'K2 ' + label))
    del uniform, mixed, cases
    # the screen's launch (three 500 MB sample sketches, 4,096 reads) and
    # a count's masked launch shape, one sketch and three
    samples = [_random_sketch(rng, 8, 124_999_999, device) for _ in range(3)]
    times = {}
    for n in (DEFAULT_SCREEN_READS * 130, 32768 * 130):
        h1, h2 = _random_hashes(rng, n, device)
        for S in (1, 3):
            got, ms = _timed(kmer_cuda.gather_counts_cuda, samples[:S], h1,
                             h2, reps=20, spin=True)
            want, plain_ms = _timed(sketch_ops.gather_counts_multi_plain,
                                    samples[:S], h1, h2, reps=5)
            err = max(err, _max_diff(got, want, 'K2 helium shape'))
            times[(n, S)] = (ms, plain_ms) + _k2_bound(samples[:S], n)
    # the counts' own mask launch: a 1-bit -M 50M mask, 4 x 99,999,999
    # buckets in 50 MB, about the card's L2
    mask = [_random_sketch(rng, 1, 99_999_999, device)]
    h1, h2 = _random_hashes(rng, 32768 * 130, device)
    got, ms = _timed(kmer_cuda.gather_counts_cuda, mask, h1, h2, reps=20,
                     spin=True)
    want, plain_ms = _timed(sketch_ops.gather_counts_multi_plain, mask, h1,
                            h2, reps=5)
    err = max(err, _max_diff(got, want, 'K2 mask shape'))
    mask_times = (ms, plain_ms) + _k2_bound(mask, h1.numel())
    del mask, got, want
    # the card's rate of random byte reads, by one PyTorch gather of as
    # many bytes as the screen's launch probes in one sketch
    flat = samples[0][0].view(-1)
    where = torch.randint(0, flat.numel(), (DEFAULT_SCREEN_READS * 130 * 4,),
                          device=device)
    _, take_ms = _timed(torch.take, flat, where, reps=20, spin=True)
    print('[smoke] random-read yardstick: torch.take of {:,} random bytes '
          'of a 500 MB table {:.4f} ms ({:.1f} G reads/s)'.format(
              where.numel(), take_ms, where.numel() / take_ms / 1e6),
          flush=True)
    del flat, where
    ms, plain_ms, bound_ms, bound_by = times[(DEFAULT_SCREEN_READS * 130, 3)]
    out['K2'] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None,
                     shape='532,480 k-mers, 3 sketches of 4 x 124,999,999 '
                     '8-bit')
    print('[smoke] K2 gather_counts: identical to plain (1/3/9 sketches, '
          '1/4/8 bits and mixed, tablesizes 1, 2, 2^31-1, three tables); '
          '4 x 124,999,999 8-bit: {}'.format('; '.join(
              '{:,} k-mers x {} sketches: kernel {:.4f} ms, plain {:.3f} ms, '
              'bound {:.4f} ms by {}'.format(n, S, *times[(n, S)])
              for n, S in times)) + '; the counts\' 1-bit mask, 4 x '
          '99,999,999: {:,} k-mers: kernel {:.4f} ms, plain {:.3f} ms, bound '
          '{:.4f} ms by {}'.format(32768 * 130, *mask_times), flush=True)
    out['K2 words'] = _word_gather_checks(device, rng, samples)
    del samples
    out.update(_screen_kernel_checks(device, rng))

    # K3: heavy duplicates, negative indices, an odd bucket count, rows of
    # a length that is no multiple of 4
    err = 0
    for C, n, span in ((1001, 131072, 37), (1001, 99_999, 1001),
                       (999_999, 2_000_000, 999_999)):
        idx = rng.integers(-5, span, (4, n)).astype(np.int32)
        acc0 = rng.integers(0, 100, (4, C)).astype(np.int32)
        got = kmer_cuda.scatter_add_cuda(
            torch.from_numpy(acc0).to(device),
            torch.from_numpy(idx).to(device))
        want = sketch_ops.scatter_add_plain(
            torch.from_numpy(acc0).to(device),
            torch.from_numpy(idx).to(device))
        err = max(err, _max_diff(got, want, 'K3 C={}'.format(C)))
        ref = acc0 + np.stack([np.bincount(r[r >= 0], minlength=C)
                               for r in idx])
        err = max(err, _max_diff(got.cpu(), torch.from_numpy(ref.astype(
            np.int32)), 'K3 C={} vs bincount'.format(C)))
    # K3 from hashes (the count path's entry): a band, a mask in both
    # senses, a k-mer repeated 50,000 times, odd and edge tablesizes, three
    # tables, a count of k-mers that is no multiple of 4, views that start
    # off the 16-byte grid
    cerr = 0
    n = 1_000_003
    h1, h2 = _random_hashes(rng, n + 1, device)
    h1[5000:55_000] = h1[5000]
    h2[5000:55_000] = h2[5000]
    valid = torch.from_numpy((rng.random(n + 1) < 0.9).astype(np.uint8)).to(
        device)
    mcnt = torch.from_numpy(rng.integers(0, 3, n + 1).astype(np.uint8)).to(
        device)
    cases = [('all', 4, 999_999, {}),
             ('band 3/8', 4, 999_999, dict(numbands=8, band=3)),
             ('mask <= 0', 4, 1001, dict(mcnt=mcnt, mask_threshold=0)),
             ('mask >= 1', 4, 124_999, dict(mcnt=mcnt, mask_threshold=1,
                                            consume_masked=True)),
             ('band and mask', 4, 2, dict(mcnt=mcnt, mask_threshold=1,
                                          numbands=2, band=1)),
             ('three tables', 3, 77_777, {}), ('tablesize 1', 4, 1, {})]
    for label, T, C, kw in cases:
        for lo in (0, 1):                # lo = 1: unaligned views
            args = [x[lo:lo + n] for x in (h1, h2, valid)]
            if 'mcnt' in kw:
                kw = dict(kw, mcnt=mcnt[lo:lo + n])
            acc0 = torch.from_numpy(rng.integers(0, 100, (T, C)).astype(
                np.int32)).to(device)
            got = kmer_cuda.consume_cuda(acc0.clone(), *args, **kw)
            want = sketch_ops.consume_hashes_plain(acc0.clone(), *args, **kw)
            cerr = max(cerr, _max_diff(got, want, 'K3 consume ' + label))
            # the same launch counting what it kept, into a counter that
            # holds a number already
            nkept = torch.full((2, 1), 7, dtype=torch.int64, device=device)
            got = kmer_cuda.consume_cuda(acc0.clone(), *args, nkept=nkept[0],
                                         **kw)
            sketch_ops.consume_hashes_plain(acc0.clone(), *args,
                                            nkept=nkept[1], **kw)
            cerr = max(cerr, _max_diff(got, want, 'K3 consume, counting, '
                                       + label),
                       _max_diff(nkept[0], nkept[1], 'K3 kept count ' + label))
            # mark mode: 1 at the kept k-mers' buckets of 8-bit tables
            marks0 = (acc0 % 3 == 0).to(torch.uint8)
            got = kmer_cuda.mark_cuda(marks0.clone(), *args, **kw)
            want = sketch_ops.mark_hashes_plain(marks0.clone(), *args, **kw)
            cerr = max(cerr, _max_diff(got, want, 'K3 mark ' + label))
    del h1, h2, valid, mcnt, cases

    # the proband count's launch: 2 GB accumulator, 32,768 reads x 130
    # windows, 15% of them kept by the mask
    C = 124_999_999
    acc = torch.zeros((4, C), dtype=torch.int32, device=device)
    n = 32768 * 130
    h1, h2 = _random_hashes(rng, n, device)
    valid = torch.from_numpy((rng.random(n) < 0.995).astype(np.uint8)).to(
        device)
    mcnt = torch.from_numpy((rng.random(n) >= 0.15).astype(np.uint8)).to(
        device)
    mask_kw = dict(mcnt=mcnt, mask_threshold=0)
    got = kmer_cuda.consume_cuda(acc.clone(), h1, h2, valid, **mask_kw)
    want = sketch_ops.consume_hashes_plain(acc.clone(), h1, h2, valid,
                                           **mask_kw)
    cerr = max(cerr, _max_diff(got, want, 'K3 consume, 2 GB accumulator'))
    nkept = int(got.sum()) // 4
    del got, want
    _, cms = _timed(kmer_cuda.consume_cuda, acc, h1, h2, valid, reps=20,
                    spin=True, **mask_kw)
    _, cplain_ms = _timed(sketch_ops.consume_hashes_plain, acc, h1, h2,
                          valid, reps=5, **mask_kw)
    # its other two modes at the same shape: counting, and marking a
    # presence table of 4 x 124,999,999 bytes
    counter = torch.zeros(1, dtype=torch.int64, device=device)
    _, count_ms = _timed(kmer_cuda.consume_cuda, acc, h1, h2, valid, reps=20,
                         spin=True, nkept=counter, **mask_kw)
    if int(counter) != 21 * nkept:
        raise AssertionError('K3 counted {} kept k-mers in 21 launches of {}'
                             .format(int(counter), nkept))
    marks = torch.zeros((4, C), dtype=torch.uint8, device=device)
    want = sketch_ops.mark_hashes_plain(marks.clone(), h1, h2, valid,
                                        **mask_kw)
    got, mark_ms = _timed(kmer_cuda.mark_cuda, marks, h1, h2, valid, reps=20,
                          spin=True, **mask_kw)
    cerr = max(cerr, _max_diff(got, want, 'K3 mark, 500 MB table'))
    del marks, got, want
    # h1, h2, valid and the mask count read once; a kept k-mer's update in
    # each table reads and writes its sector
    cbound_ms, cbound_by = _bound(n * 10 + nkept * 4 * 2 * SECTOR,
                                  n * 6 + nkept * 4 * K2_OPS_PER_PROBE)
    out['K3 consume'] = dict(
        err=cerr, ms=cms, plain_ms=cplain_ms, bound_ms=cbound_ms,
        bound_by=cbound_by, library_ms=None,
        shape='4,259,840 hashed k-mers (15% kept), 4 x 124,999,999 int32')
    print('[smoke] K3 consume (from hashes): identical to plain (band, mask '
          '<= and >=, 50,000 duplicates, tablesizes 1, 2, 1,001, 999,999, '
          'three tables, unaligned views, 2 GB accumulator; also counting '
          'what it kept, and in mark mode); {}: kernel '
          '{:.4f} ms ({:.1f} G updates/s), plain (index glue + index_add_ '
          'per table) {:.3f} ms, bound {:.4f} ms by {}; counting the kept '
          '{:.4f} ms; marking 4 x 124,999,999 bytes {:.4f} ms'.format(
              out['K3 consume']['shape'], cms, 4 * nkept / cms / 1e6,
              cplain_ms, cbound_ms, cbound_by, count_ms, mark_ms),
          flush=True)

    # K3 from indices at the same shape: the indices the consume computes
    a, b = hashing.to_u32(h1), hashing.to_u32(h2)
    idx = torch.stack([hashing.table_index(a, b, t, C) for t in range(4)])
    idx = torch.where((valid != 0) & (mcnt <= 0), idx, -1).to(torch.int32)
    del a, b, h1, h2, valid, mcnt
    _, ms = _timed(kmer_cuda.scatter_add_cuda, acc, idx, reps=20, spin=True)
    _, plain_ms = _timed(sketch_ops.scatter_add_plain, acc, idx, reps=5)
    # one library call for the same function: index_add_ on the flat
    # accumulator, its kept flat indices prepared outside the timing
    kept = idx >= 0
    if int(kept.sum()) != 4 * nkept:
        raise AssertionError('the two K3 entries were given different work')
    flat = (idx.long() + torch.arange(4, device=device)[:, None] * C)[kept]
    ones = torch.ones_like(flat, dtype=torch.int32)
    _, library_ms = _timed(acc.view(-1).index_add_, 0, flat, ones, reps=5,
                           spin=True)
    del flat, ones, kept
    # every index read once; a kept update reads and writes its sector
    bound_ms, bound_by = _bound(idx.numel() * 4 + 4 * nkept * 2 * SECTOR,
                                4 * nkept)
    out['K3'] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms,
                     shape='4 x 4,259,840 indices (15% kept), 4 x '
                     '124,999,999 int32')
    print('[smoke] K3 scatter_add (from indices): identical to plain and '
          'bincount (duplicates, negative indices); {} kernel {:.4f} ms, '
          'plain {:.3f} ms, one index_add_ {:.4f} ms, bound {:.4f} ms by {}'
          .format(out['K3']['shape'], ms, plain_ms, library_ms, bound_ms,
                  bound_by), flush=True)
    print('[smoke] random read-modify-write yardstick: {:,} updates of a 2 '
          'GB accumulator: index_add_ {:.1f} G/s, kt_scatter_add {:.1f} G/s, '
          'kt_consume {:.1f} G/s'.format(
              4 * nkept, 4 * nkept / library_ms / 1e6,
              4 * nkept / ms / 1e6, 4 * nkept / cms / 1e6), flush=True)
    return out


# integer operations per DP cell in csrc/align.cu's inner loop: the query
# code 1, the substitution score 5, the diagonal 1, E and F 1 each, the
# maxima and direction code 6, H - gapoe, E - gape and F - gape 3, the
# continuation bits 6, packing the code 2, a cell's share of the step's
# shuffles, loads, stores and loop 4
B1_OPS_PER_CELL = 30


def _alac_batches(seen, device):
    """Every chunk the recorded ``align_batch`` calls of an alac run were
    dispatched in: (row indices, encoded batch on ``device``, scoring
    arguments, the call's results)."""
    from kevlar_tpu_torch.ops import align_cuda
    for targets, queries, kw, out in seen:
        tl = np.array([len(s) for s in targets])
        ql = np.array([len(s) for s in queries])
        args = dict(match=kw['match'], mismatch=kw['mismatch'],
                    gapopen=kw['gapopen'], gapextend=kw['gapextend'])
        for idx in align_cuda._chunks(tl, ql, align_cuda.ZDIAG_BUDGET_BYTES):
            batch = _encode([(targets[k], queries[k]) for k in idx], device)
            yield idx, batch, args, out


def phase_slice(device, workdir):
    """Phase 4: the alac slice at bigsim scale through the CLI."""
    import torch
    import kevlar_tpu_torch
    from kevlar_tpu_torch import cli, reference
    from kevlar_tpu_torch.ops import align_cuda

    t0 = time.time()
    refr, reads, truth = make_alac_case(workdir)
    print('[smoke] generated {:,} bp reference, {} loci in {:.1f} s'.format(
        GENOME_LEN, len(truth), time.time() - t0), flush=True)
    t0 = time.time()
    reference.autoindex(refr, 51)
    index_s = time.time() - t0
    print('[smoke] seed index (seed 51) built in {:.1f} s'.format(index_s),
          flush=True)

    seen = []
    batch_fn = align_cuda.align_batch

    def recording(targets, queries, **kw):
        out = batch_fn(targets, queries, **kw)
        seen.append((list(targets), list(queries), kw, out))
        return out

    # the run's seed set, for the seeds phase
    seedsets = []
    lookup_fn = reference.SeedIndex.lookup

    def recording_lookup(index, seeds):
        seedsets.append(set(seeds))
        return lookup_fn(index, seeds)

    vcfpath = os.path.join(workdir, 'calls.vcf')
    logpath = os.path.join(workdir, 'alac.log')
    align_cuda.align_batch = recording
    reference.SeedIndex.lookup = recording_lookup
    align_cuda.launches = 0
    t0 = time.time()
    try:
        cli.main(['-l', logpath, '--tee', 'alac', '-k', str(KSIZE),
                  '--device', device, '-o', vcfpath, reads, refr])
    finally:
        align_cuda.align_batch = batch_fn
        reference.SeedIndex.lookup = lookup_fn
        if kevlar_tpu_torch.logstream not in (None, sys.stderr):
            kevlar_tpu_torch.logstream.close()
        kevlar_tpu_torch.logstream = None
    torch.cuda.synchronize()
    alac_s = time.time() - t0
    launches = align_cuda.launches
    if launches <= 0:
        raise AssertionError('the alac run launched no ksw_extz kernel')
    with open(logpath) as fh:
        walls = [line.strip() for line in fh if 'phase walls' in line]
    if not walls:
        raise AssertionError('no phase walls line in the alac log')
    npairs = sum(len(s[0]) for s in seen)
    print('[smoke] alac: {:.1f} s wall; {}; {} alignment rows ({} pairs x '
          '2 strands) in {} kernel launches'.format(
              alac_s, walls[-1], npairs, npairs // 2, launches), flush=True)

    # every pair again: kernel and plain version, chunk by chunk
    err, ms, dp_ms, tb_ms, plain_ms = 0, 0.0, 0.0, 0.0, 0.0
    cells = moved = 0
    for targets, queries, kw, out in seen:
        tl = np.array([len(s) for s in targets])
        ql = np.array([len(s) for s in queries])
        # the DP's cells; bases in, a direction byte per cell written, and
        # out a score, two exit cells and tlen + qlen ops per pair
        cells += int((tl * ql).sum())
        moved += int((tl * ql).sum() + 2 * (tl + ql).sum() + 12 * len(tl))
    for idx, batch, args, out in _alac_batches(seen, device):
        got, kms, kdp, ktb = _timed_align(batch, reps=3, **args)
        torch.cuda.synchronize()
        t1 = time.time()
        ref = align_cuda.ksw_extz_plain(*batch, **args)
        torch.cuda.synchronize()
        plain_ms += 1e3 * (time.time() - t1)
        ms, dp_ms, tb_ms = ms + kms, dp_ms + kdp, tb_ms + ktb
        err = max(err, _compare(got, ref, 'alac chunk'))
        scores, ops_rev, exit_i, exit_j = (x.cpu().numpy() for x in ref)
        cigars = align_cuda._cigars_from_ops_batch(ops_rev, exit_i, exit_j)
        for k, cigar, score in zip(idx, cigars, scores.tolist()):
            if out[k] != (cigar, score):
                raise AssertionError(
                    'alac row {}: kernel gave {}, plain version {}'.format(
                        k, out[k], (cigar, score)))
    print('[smoke] plain re-alignment of all {} rows: identical; kernel '
          '{:.3f} ms by the host clock (DP kernel {:.3f} ms, traceback '
          'kernel {:.3f} ms; the rest is the wrapper laying out and '
          'allocating the direction buffer), plain {:.1f} ms ({:.0f} rows/s '
          'by the kernel)'.format(
              npairs, ms, dp_ms, tb_ms, plain_ms, npairs / (ms / 1e3)),
          flush=True)

    from kevlar_tpu_torch import seqio
    genome = seqio.parse_seq_dict(kevlar_tpu_torch.open(refr, 'r'))['chr1']
    score = score_calls(genome, read_vcf_calls(vcfpath), truth)
    for name, row in score['per_class'].items():
        print('[smoke] recall {:<18s} {:4d}/{:4d} = {:.4f} (PASS {:.4f})'
              .format(name, row['found'], row['total'],
                      row['found'] / max(1, row['total']),
                      row['found_pass'] / max(1, row['total'])), flush=True)
    print('[smoke] recall overall {:.4f} (PASS {:.4f}); PASS calls '
          'matching no truth variant: {}'.format(
              score['recall'], score['recall_pass'], score['false_pass']),
          flush=True)
    if score['recall_pass'] < MIN_RECALL:
        raise AssertionError('PASS recall {:.4f} below {}'.format(
            score['recall_pass'], MIN_RECALL))
    bound_ms, bound_by = _bound(moved, cells * B1_OPS_PER_CELL)
    print('[smoke] ksw_extz bound: {:,} DP cells x {} operations, {:,} bytes '
          '(bases, a direction byte per cell, ops out): {:.4f} ms by {}'
          .format(cells, B1_OPS_PER_CELL, moved, bound_ms, bound_by),
          flush=True)
    return dict(launches=launches, err=err, ms=ms, dp_ms=dp_ms, tb_ms=tb_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                reads=reads, refr=refr, vcf=vcfpath, rows=seen,
                seeds=seedsets[-1])


def _run_cli(argv, logpath):
    """``kevlar_tpu_torch.cli.main(argv)`` with its log in ``logpath``;
    returns the stage's wall seconds (the stage ends synchronised)."""
    import torch
    import kevlar_tpu_torch
    from kevlar_tpu_torch import cli
    t0 = time.time()
    try:
        cli.main(['-l', logpath] + argv)
    finally:
        if kevlar_tpu_torch.logstream not in (None, sys.stderr):
            kevlar_tpu_torch.logstream.close()
        kevlar_tpu_torch.logstream = None
    torch.cuda.synchronize()
    return time.time() - t0


def _vcf_records(path):
    """A VCF's records, sorted, without the CONTIG attribute (contigs are
    numbered from 1 in every file that is assembled apart)."""
    with open(path) as fh:
        return sorted(';'.join(f for f in line.rstrip('\n').split(';')
                               if not f.startswith('CONTIG='))
                      for line in fh if line[0] != '#')


def phase_call(device, workdir, refr, reads, alac_vcf, shards=2):
    """The ``call`` path, from files, on phase 4's reads: ``split`` the
    partitioned reads into ``shards`` files, then ``assemble``,
    ``localize`` and ``call --device`` each.  B1 must launch (``call``
    aligns all of a file's partitions as one batch), and the shards'
    records together must be the records of phase 4's ``alac`` run (both
    sorted: alac sorts by position, a shard keeps partition order; the
    CONTIG attribute is left out, since contig numbers restart in each
    shard)."""
    from kevlar_tpu_torch.ops import align_cuda
    base = os.path.join(workdir, 'shard')
    walls = {'split': _run_cli(['split', reads, str(shards), base],
                               os.path.join(workdir, 'split.log'))}
    align_cuda.launches = 0
    records = []
    for i in range(shards):
        def path(name):
            return os.path.join(workdir, 'shard{}.{}'.format(i, name))
        for stage, argv in (
                ('assemble', ['assemble', '-o', path('contigs.augfasta'),
                              '{}.{}.augfastx'.format(base, i)]),
                ('localize', ['localize', '-o', path('cutouts.fa'), refr,
                              path('contigs.augfasta')]),
                ('call', ['call', '-k', str(KSIZE), '--refr', refr,
                          '--device', device, '-o', path('calls.vcf'),
                          path('contigs.augfasta'), path('cutouts.fa')])):
            walls[stage] = walls.get(stage, 0.0) + _run_cli(
                argv, path(stage + '.log'))
        records += _vcf_records(path('calls.vcf'))
    launches = align_cuda.launches
    if launches <= 0:
        raise AssertionError('the call run launched no ksw_extz kernel')
    want = _vcf_records(alac_vcf)
    if sorted(records) != want:
        diff = set(records) ^ set(want)
        raise AssertionError(
            'split + call gave {} records, alac {}; {} differ, e.g. {}'
            .format(len(records), len(want), len(diff), sorted(diff)[:2]))
    print('[smoke] call path (all {} loci, {} shards): {}; total {:.1f} s; '
          'B1 {} launches; {} records == those of the alac run (sorted, '
          'CONTIG left out)'.format(
              NLOCI, shards, ', '.join('{} {:.1f} s'.format(k, v)
                                       for k, v in walls.items()),
              sum(walls.values()), launches, len(records)), flush=True)
    return dict(launches=launches, walls=walls)


def _host_times(fn, reps):
    """(last result, [ms of each of ``reps`` calls of ``fn``]) by the host
    clock."""
    times = []
    for _ in range(reps):
        t0 = time.time()
        out = fn()
        times.append(1e3 * (time.time() - t0))
    return out, times


def phase_seeds(device, workdir, refr, seeds, shard=0, reps=3):
    """Seeds phase: the device seed search (B7) against the host search on
    phase 4's seed index and the alac run's seed set (``seeds``), then
    ``localize`` of shard ``shard`` of the call path with
    ``KEVLAR_SEED_BACKEND=device``, whose cutouts must be the call path's
    (host search)."""
    import math
    import torch
    from kevlar_tpu_torch import dna, reference
    from kevlar_tpu_torch.ops import seed_ops

    host = reference.autoindex(refr, 51, device=device)
    if host.backend != 'host':
        raise AssertionError('phase 4 left a {} index'.format(host.backend))
    dev = reference.SeedIndex.from_file(
        reference.index_path(refr, 51), host.refrseqs, backend='device',
        device=device)
    nkeys = len(dev._keys)
    _, flip_ms = _host_times(lambda: seed_ops.ordered_int64(dev._keys), 1)
    torch.cuda.synchronize()
    t0 = time.time()
    keys = dev.device_keys()
    torch.cuda.synchronize()
    copy_ms = 1e3 * (time.time() - t0)

    seedlist = sorted(seeds)
    qbases, _ = dna.encode_batch(seedlist)
    qcodes, _ = dna.seed_codes(qbases, 51)
    qkeys = reference._fold_codes(qcodes[:, 0, :])
    queries = torch.from_numpy(seed_ops.ordered_int64(qkeys)).to(device)
    (start, count), ms = _timed(seed_ops.seed_ranges, keys, queries,
                                reps=reps, spin=True)
    (lo, hi), host_ms = _host_times(
        lambda: (np.searchsorted(host._keys, qkeys, side='left'),
                 np.searchsorted(host._keys, qkeys, side='right')), reps)
    if not (np.array_equal(start.cpu().numpy(), lo) and
            np.array_equal(count.cpu().numpy(), hi - lo)):
        raise AssertionError('device seed ranges differ from np.searchsorted')
    sectors = len(qkeys) * 2 * math.ceil(math.log2(nkeys))
    bound_ms, bound_by = _bound(sectors * SECTOR, 0)
    print('[smoke] seeds: {:,} queries (the alac run\'s seed set) against '
          '{:,} keys; keys to the card {:.1f} ms for {:,} bytes (of which '
          'the host flip to ordered int64 {:.1f} ms); device search (two '
          'torch.searchsorted, queued) {:.4f} ms, {:.1f} G sectors/s; host '
          'np.searchsorted {}; bound {:.4f} ms by {} ({:,} random {}-byte '
          'sectors: queries x 2 x ceil(log2 keys)); ranges identical'.format(
              len(qkeys), nkeys, copy_ms, keys.numel() * 8, flip_ms[0], ms,
              sectors / ms / 1e6, _spread(host_ms), bound_ms, bound_by,
              sectors, SECTOR), flush=True)

    found, walls = {}, {}
    for which, index in (('host', host), ('device', dev)):
        found[which], walls[which] = _host_times(
            lambda: index.lookup(seeds), 1)
    if found['host'] != found['device']:
        raise AssertionError('device lookup: {} seeds matched, host {}'.format(
            len(found['device']), len(found['host'])))
    print('[smoke] seeds: whole lookup (search + host verification) host '
          '{:.1f} ms, device {:.1f} ms; {:,} seeds matched, identical'.format(
              walls['host'][0], walls['device'][0], len(found['host'])),
          flush=True)

    contigs = os.path.join(workdir, 'shard{}.contigs.augfasta'.format(shard))
    out = os.path.join(workdir, 'seeds.cutouts.fa')
    seed_ops.launches = 0
    os.environ['KEVLAR_SEED_BACKEND'] = 'device'
    try:
        localize_s = _run_cli(
            ['localize', '--device', device, '-o', out, refr, contigs],
            os.path.join(workdir, 'seeds.localize.log'))
    finally:
        del os.environ['KEVLAR_SEED_BACKEND']
    launches = seed_ops.launches
    with open(out) as fh, open(os.path.join(
            workdir, 'shard{}.cutouts.fa'.format(shard))) as gh:
        if fh.read() != gh.read():
            raise AssertionError('localize with the device seed search '
                                 'differs from the call path\'s')
    if launches <= 0:
        raise AssertionError('localize with KEVLAR_SEED_BACKEND=device ran no '
                             'device search')
    print('[smoke] seeds: localize of shard {} with KEVLAR_SEED_BACKEND=device '
          '{:.2f} s (index loaded and copied to the card in the run; {} '
          'seed_ranges call); cutouts == the call path\'s'.format(
              shard, localize_s, launches), flush=True)
    reference._index_cache.clear()
    return dict(launches=launches, ms=ms, host_ms=float(np.median(host_ms)),
                bound_ms=bound_ms, bound_by=bound_by)


# float32 operations of _score_bundles per k-mer of a trio bundle: six
# absent-genotype terms (three lgamma, a log, a log1p, ~10 more: ~140
# each), seven normal logpdfs (~5), the 11 scenarios' sums and max (~44)
# and the masked sums (~10)
SIMLIKE_OPS_PER_KMER = 930


def _random_trio_bundles(rng, n, kmax=64):
    """``n`` trio bundles of tests/test_simlike.py's shape at K 0-``kmax``:
    case abundances 0-40, controls 0-6, half SNV mode (copy numbers 0-4),
    half indel mode."""
    from kevlar_tpu_torch.simlike import _AbundanceBundle
    bundles = []
    for K in rng.integers(0, kmax + 1, n):
        case = rng.integers(0, 41, K)
        mom, dad = rng.integers(0, 7, K), rng.integers(0, 7, K)
        refr = (rng.integers(0, 5, K).tolist() if rng.random() < 0.5
                else [None] * K)
        bundles.append(_AbundanceBundle(case, [mom, dad], refr, 0))
    return bundles


def _likescores(text):
    """{(chrom, pos, ref, alt): (FILTER, LIKESCORE)} of a VCF's text."""
    out = {}
    for line in text.split('\n'):
        if line and not line.startswith('#'):
            f = line.split('\t')
            score = re.search(r'LIKESCORE=([^;]+)', f[7]).group(1)
            out[tuple(f[:2] + f[3:5])] = (f[6], float(score))
    return out


def phase_simlike(device, workdir, nbundles=100_000, sample=1000, reps=5):
    """Simlike phase: the workflow's preliminary calls (phase 9) through
    ``cli.main(['simlike', ..., '--device', device])`` against the trio's
    tables on disk, host (default), ``KEVLAR_SIMLIKE_BATCH=1`` (text equal to
    host's) and ``KEVLAR_SIMLIKE_DEVICE=1`` (PASS set equal, LIKESCORE within
    rel 1e-4, abs 1e-2); then ``score_bundles`` (B8) on ``nbundles`` random
    trio bundles, timed, a ``sample`` of them held to the float64 host
    functions (rel 2e-5, abs 2e-3; ranking equal)."""
    import torch
    from kevlar_tpu_torch import simlike
    from kevlar_tpu_torch.ops import kmer_cuda, simlike_ops

    mu, sigma, error = HELIUM_COVERAGE, HELIUM_COVERAGE * 0.3, 0.001

    def path(name):
        return os.path.join(workdir, 'workflow', name)

    argv = ['simlike', '--case', path('case.ct'), '--controls',
            path('control0.ct'), path('control1.ct'), '--refr',
            path('refr.sct'), '--mu', str(mu), '--sigma', str(sigma),
            '--epsilon', str(error), '--case-min', '5', '--ctrl-max', '1',
            '--device', device]
    texts, walls, launches = {}, {}, {}
    for mode, switch in (('host', None), ('batch', 'KEVLAR_SIMLIKE_BATCH'),
                         ('device', 'KEVLAR_SIMLIKE_DEVICE')):
        out = os.path.join(workdir, 'simlike.{}.vcf'.format(mode))
        for name in kmer_cuda.launches:
            kmer_cuda.launches[name] = 0
        simlike_ops.launches = 0
        if switch:
            os.environ[switch] = '1'
        try:
            walls[mode] = _run_cli(
                argv + ['-o', out, path('calls.prelim.vcf')],
                os.path.join(workdir, 'simlike.{}.log'.format(mode)))
        finally:
            if switch:
                del os.environ[switch]
        launches[mode] = dict(kmer_cuda.launches,
                              score_bundles=simlike_ops.launches)
        with open(out) as fh:
            texts[mode] = fh.read()
    if texts['batch'] != texts['host']:
        raise AssertionError('simlike with KEVLAR_SIMLIKE_BATCH=1 wrote '
                             'another VCF than the host run')
    if not (launches['batch']['kmer_hashes'] > 0 and
            launches['batch']['gather_counts'] > 0):
        raise AssertionError('the batched gather launched no K1/K2: '
                             '{}'.format(launches['batch']))
    if launches['device']['score_bundles'] <= 0:
        raise AssertionError('KEVLAR_SIMLIKE_DEVICE=1 ran no score_bundles')
    host, dev = _likescores(texts['host']), _likescores(texts['device'])
    passing = {k for k, (filt, _) in host.items() if filt == 'PASS'}
    if set(dev) != set(host) or passing != {
            k for k, (filt, _) in dev.items() if filt == 'PASS'}:
        raise AssertionError('device scoring: calls or PASS set differ')
    worst = max((abs(dev[k][1] - host[k][1]) /
                 (1e-2 + 1e-4 * abs(host[k][1])) for k in host), default=0)
    if worst > 1:
        raise AssertionError('device scoring: a LIKESCORE is {:.2f}x the '
                             'tolerance away from host'.format(worst))
    print('[smoke] simlike on the workflow\'s {} calls ({} PASS): host {:.2f} '
          's, KEVLAR_SIMLIKE_BATCH=1 {:.2f} s (text identical; K1 {}, K2 {} '
          'launches), KEVLAR_SIMLIKE_DEVICE=1 {:.2f} s (PASS set identical, '
          'LIKESCORE at most {:.3f} of the tolerance away; score_bundles {} '
          'call)'.format(
              len(host), len(passing), walls['host'], walls['batch'],
              launches['batch']['kmer_hashes'],
              launches['batch']['gather_counts'], walls['device'], worst,
              launches['device']['score_bundles']), flush=True)

    rng = np.random.default_rng(SEED + 8)
    bundles = _random_trio_bundles(rng, nbundles)
    t0 = time.time()
    tensors = simlike_ops.bundle_tensors(bundles, device)
    torch.cuda.synchronize()
    pack_s = time.time() - t0
    (lldn, llfp, llih), ms = _timed(simlike_ops._score_bundles, *tensors,
                                    mu, sigma, error, reps=reps, spin=True)
    torch.cuda.synchronize()
    t0 = time.time()
    whole = simlike_ops.score_bundles(bundles, mu, sigma, error, device)
    whole_s = time.time() - t0
    got = np.stack([x.cpu().numpy() for x in (lldn, llfp, llih)], 1)
    if not np.array_equal(got, np.array(whole).T):
        raise AssertionError('score_bundles differs from _score_bundles')
    picks = np.sort(rng.choice(nbundles, sample, replace=False))
    t0 = time.time()
    want = np.array([
        (simlike.likelihood_denovo(b.aslists(), b.refrcopies, mean=mu,
                                   sd=sigma, error=error),
         simlike.likelihood_false(b.aslists(), b.refrcopies, mean=mu,
                                  error=error),
         simlike.likelihood_inherited(b.aslists(), mean=mu, sd=sigma,
                                      error=error))
        for b in (bundles[i] for i in picks)])
    host_ms = 1e3 * (time.time() - t0)
    err = np.abs(got[picks] - want)
    worst = float((err / (2e-3 + 2e-5 * np.abs(want))).max())
    if worst > 1:
        raise AssertionError('score_bundles: {:.2f}x the tolerance away from '
                             'the float64 host functions'.format(worst))

    def ranking(scores):
        return np.argsort(scores[:, 0] - np.maximum(scores[:, 1],
                                                    scores[:, 2]),
                          kind='stable')

    if not np.array_equal(ranking(got[picks]), ranking(want)):
        raise AssertionError('score_bundles ranks the sample otherwise than '
                             'the float64 host functions')
    kmers = sum(len(b.case) for b in bundles)
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + \
        3 * 4 * nbundles
    bound_ms, bound_by = _bound(nbytes, kmers * SIMLIKE_OPS_PER_KMER)
    print('[smoke] score_bundles on {:,} trio bundles ({:,} k-mers, padded '
          'to K = {}): {:.4f} ms on the card (queued), bound {:.4f} ms by {} '
          '({:,} bytes, {} operations a k-mer); whole call with packing and '
          'copies {:.2f} s (packing {:.2f} s); float64 host functions {:.1f} '
          'ms for {:,} of them, max abs error {:.3g} ({:.3f} of the '
          'tolerance), ranking equal'.format(
              nbundles, kmers, tensors[0].shape[1], ms, bound_ms, bound_by,
              nbytes, SIMLIKE_OPS_PER_KMER, whole_s, pack_s, host_ms, sample,
              float(err.max()), worst), flush=True)
    return dict(launches=launches['device']['score_bundles'], ms=ms,
                host_ms=host_ms, host_n=sample, bound_ms=bound_ms,
                bound_by=bound_by, walls=walls)


# mu of ``dist`` on the helium proband: 30x of 150 bp reads at k = 31 cover
# a k-mer 30 * (150 - 31 + 1) / 150 = 24 times, and a window is free of
# errors with probability 0.995^31 = 0.856: 20.55.  The few k-mers that
# the mask lets in by a false positive pull it down a little.
DIST_MU = HELIUM_COVERAGE * (READLEN - KSIZE + 1) / READLEN * \
    (1 - HELIUM_ERROR) ** KSIZE
DIST_MU_BAND = (19.0, 22.0)
DIST_HEAD_READS = 200_000


def _dist_cli(device, workdir, name, memory, mask, fastq):
    """``dist`` through the command line; returns (the JSON line it
    printed, its TSV's text, the wall)."""
    import contextlib
    import io
    tsv = os.path.join(workdir, name + '.tsv')
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        wall = _run_cli(['dist', '-k', str(KSIZE), '-M', memory, '--device',
                         device, '--tsv', tsv, mask, fastq],
                        os.path.join(workdir, name + '.log'))
    with open(tsv) as fh:
        return out.getvalue().strip(), fh.read(), wall


def _head_fastq(fastq, path, nreads):
    """The first ``nreads`` records of a FASTQ file, written to ``path``;
    returns ``path``."""
    with open(fastq, 'rb') as src, open(path, 'wb') as dst:
        for _ in range(4 * nreads):
            dst.write(src.readline())
    return path


def phase_dist(device, workdir, reads, memory='500M', head_memory='40M'):
    """The ``dist`` path on phase 6's helium files: the abundance
    distribution of the proband's k-mers inside the trio's 1-bit reference
    mask, both passes on the card, then ``query_batch`` on the proband's
    table."""
    import torch
    from kevlar_tpu_torch import dist, dna, sketch
    from kevlar_tpu_torch.batch import native_base_batches
    from kevlar_tpu_torch.ops import kmer_cuda
    mask = os.path.join(workdir, 'mask.nt')

    pass_walls = {}

    def timed(name, fn):
        def run(*args):
            t0 = time.time()
            out = fn(*args)
            torch.cuda.synchronize()
            pass_walls[name] = time.time() - t0
            return out
        return run

    passes = dist.count_first_pass, dist.count_second_pass
    dist.count_first_pass = timed('first pass', passes[0])
    dist.count_second_pass = timed('second pass', passes[1])
    for name in kmer_cuda.launches:
        kmer_cuda.launches[name] = 0
    try:
        line, tsv, wall = _dist_cli(device, workdir, 'dist', memory, mask,
                                    reads['proband'])
    finally:
        dist.count_first_pass, dist.count_second_pass = passes
    launches = dict(kmer_cuda.launches)
    for name in COUNT_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError('the dist run launched no {} kernel'
                                 .format(name))
    stats = json.loads(line)
    if not DIST_MU_BAND[0] <= stats['mu'] <= DIST_MU_BAND[1]:
        raise AssertionError('dist: mu {} outside {} (expected {:.2f})'
                             .format(stats['mu'], DIST_MU_BAND, DIST_MU))
    print('[smoke] dist (helium proband, 1-bit 50M mask, -M {}): mu {} '
          'sigma {} (expected mu {:.2f}, band {}; the workflow of phase 9 '
          'is given mu {} sigma {}); {:.1f} s wall, first pass {:.1f} s, '
          'second pass {:.1f} s; {} abundance rows; launches {}'.format(
              memory, stats['mu'], stats['sigma'], DIST_MU, DIST_MU_BAND,
              HELIUM_COVERAGE, HELIUM_COVERAGE * 0.3, wall,
              pass_walls['first pass'], pass_walls['second pass'],
              tsv.count('\n') - 1, launches), flush=True)

    # the card against the CPU (the kernels' plain versions) on the head
    head = _head_fastq(reads['proband'], os.path.join(workdir, 'head.fq'),
                       DIST_HEAD_READS)
    got = _dist_cli(device, workdir, 'head_card', head_memory, mask, head)
    want = _dist_cli('cpu', workdir, 'head_cpu', head_memory, mask, head)
    if got[:2] != want[:2]:
        raise AssertionError('dist on the first {:,} reads: the card '
                             'printed {}, the CPU {}; TSVs {}'.format(
                                 DIST_HEAD_READS, got[0], want[0],
                                 'equal' if got[1] == want[1] else 'differ'))
    print('[smoke] dist on the first {:,} reads (-M {}): --device cuda == '
          '--device cpu, JSON {} and TSV ({} rows); {:.1f} s on the card, '
          '{:.1f} s on the CPU'.format(
              DIST_HEAD_READS, head_memory, got[0], got[1].count('\n') - 1,
              got[2],
              want[2]), flush=True)

    # query_batch: one batch of reads against the proband's table
    table = sketch.load(os.path.join(workdir, 'proband.ct'), device=device)
    bases, lengths = next(native_base_batches(
        reads['proband'], DEFAULT_SCREEN_READS, overlap=KSIZE - 1))
    before = dict(kmer_cuda.launches)
    counts, valid = table.query_batch(bases)
    counts, valid = counts.cpu().numpy(), valid.cpu().numpy()
    for name in ('kmer_hashes', 'gather_counts'):
        if kmer_cuda.launches[name] <= before[name]:
            raise AssertionError('query_batch launched no ' + name)
    h1, h2, ok = dna.kmer_hashes(bases, KSIZE)
    mirror = table._host_counts(h1.ravel(), h2.ravel(), ok.ravel())
    if not np.array_equal(valid.astype(bool), ok) or \
            not np.array_equal(counts.ravel(), mirror):
        raise AssertionError('query_batch differs from the host mirror')
    for row in range(0, len(lengths), 64):
        seq = dna.decode(bases[row, :lengths[row]])
        want_row = table.get_kmer_counts(seq)
        if counts[row, :len(want_row)].tolist() != want_row:
            raise AssertionError('query_batch row {} differs from '
                                 'get_kmer_counts'.format(row))
    print('[smoke] query_batch: {} reads x {} windows against the '
          'proband\'s table == the host mirror\'s counts (and '
          'get_kmer_counts on every 64th read); mean count {:.2f}'.format(
              counts.shape[0], counts.shape[1],
              float(counts[valid != 0].mean())), flush=True)
    return dict(launches=launches, walls=pass_walls, stats=stats)


def _trio_stages(device, workdir, refr, reads, prefix, samples=SAMPLES,
                 mask=None):
    """The slice's commands, as the trio workflow runs them (workflow.py
    steps 1-3): reference mask, reference count, masked sample counts,
    novel screen.  Outputs are named ``prefix`` + file; with ``mask`` the
    sample counts use that mask.  Returns {stage: wall seconds}."""
    def out(name):
        return os.path.join(workdir, prefix + name)

    def log(name):
        return out(name + '.log')

    walls = {}
    base = ['-k', str(KSIZE), '--device', device]
    walls['count mask'] = _run_cli(
        ['count'] + base + ['-c', '1', '-M', '50M', '--max-fpr', '0.01',
                            out('mask.nt'), refr], log('mask'))
    walls['count refr'] = _run_cli(
        ['count'] + base + ['-c', '4', '-M', '50M', '--max-fpr', '1.0',
                            out('refr.sct'), refr], log('refr'))
    mask = mask or out('mask.nt')
    for who in samples:
        fpr = '0.6' if who == 'proband' else '0.2'
        walls['count ' + who] = _run_cli(
            ['count'] + base + ['-M', '500M', '--max-fpr', fpr, '--mask',
                                mask, out(who + '.ct'), reads[who]],
            log(who))
    return walls


def _print_busy(label, prof, wall):
    """The card's busy share of ``wall`` seconds from a torch.profiler
    trace (the sum of the device's own events: kernels, copies and sets;
    a CPU-side op's device time repeats its kernels' and is left out), and
    what took it; returns the busy seconds."""
    from torch.autograd import DeviceType

    def device_us(event):
        return (getattr(event, 'self_device_time_total', 0) or
                getattr(event, 'self_cuda_time_total', 0))

    events = sorted((e for e in prof.key_averages()
                     if getattr(e, 'device_type', None) == DeviceType.CUDA),
                    key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in events)
    print('[smoke] {}: {:.2f} s wall, device busy {} ; top device time: {}'
          .format(label, wall,
                  '{:.3f} s ({:.2%})'.format(busy_us / 1e6,
                                             busy_us / 1e6 / wall)
                  if busy_us else 'not measured (no device time in the '
                  'trace)',
                  '; '.join('{} x{} {:.1f} ms'.format(
                      e.key[:48], e.count, device_us(e) / 1e3)
                      for e in events[:8])), flush=True)
    return busy_us / 1e6


def _producer_split(fastq, device):
    """The host's share of a sample count, with no consume: seconds of the
    C++ reader alone over ``fastq``, then of the count's producer as it
    runs (the reader filling pinned buffers, a non-blocking copy of each
    batch to the card)."""
    import torch
    from kevlar_tpu_torch.batch import CodeStager, native_base_batches
    from kevlar_tpu_torch.count import COUNT_BATCH_READS
    t0 = time.time()
    for _ in native_base_batches(fastq, COUNT_BATCH_READS,
                                 overlap=KSIZE - 1):
        pass
    parse_s = time.time() - t0
    t0 = time.time()
    stager = CodeStager(device)
    for _ in native_base_batches(fastq, COUNT_BATCH_READS, overlap=KSIZE - 1,
                                 alloc=stager.buffer):
        stager.ship()
    torch.cuda.synchronize()
    return parse_s, time.time() - t0


# the kernels of csrc/kmer.cu that a count must launch (K2 for its mask);
# K3's entry from indices is on the path of a device sketch's
# consume_hashes instead
COUNT_PATH_KERNELS = ('kmer_hashes', 'gather_counts', 'consume')
# and count -> novel: the novel stage screens a trio over packed words
NOVEL_PATH_KERNELS = COUNT_PATH_KERNELS + ('screen_reads',)
# the proband reads of phase 6's dense screen: every k-mer a hit, more
# than the screen's capacity of 32,768 in one batch
DENSE_NOVEL_READS = 1000


def _recount_path(device, workdir, reads):
    """The path of K3's entry from indices: the hashes of the proband's
    first 32,768 reads (host arrays, as the filter's recount holds them)
    counted into a device sketch of the samples' size through
    ``Sketch.consume_hashes``.  The tables must equal those of the same
    reads' codes counted through the consume kernel.  Returns the launches
    of ``scatter_add`` over the path, which must be positive."""
    import torch
    from kevlar_tpu_torch import dna, sketch
    from kevlar_tpu_torch.batch import native_base_batches
    from kevlar_tpu_torch.ops import kmer_cuda, sketch_ops
    bases, _ = next(native_base_batches(reads['proband'], 32768,
                                        overlap=KSIZE - 1))
    h1, h2, valid = dna.kmer_hashes(bases, KSIZE)
    tablesize = 124_999_999
    counts = sketch.Sketch(KSIZE, tablesize, 4, device=device)
    kmer_cuda.launches['scatter_add'] = 0
    t0 = time.time()
    counted = counts.consume_hashes(h1, h2, valid)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kmer_cuda.launches['scatter_add']
    if launches <= 0:
        raise AssertionError('the device recount launched no scatter_add '
                             'kernel')
    acc = sketch_ops.Accumulator(
        torch.zeros_like(counts.tables), 8, tablesize)
    sketch_ops.consume_codes(acc, torch.from_numpy(np.ascontiguousarray(
        bases)).to(device), KSIZE)
    if not torch.equal(counts.tables, acc.tables()):
        raise AssertionError('device recount: tables differ from the '
                             'consume kernel\'s')
    print('[smoke] device recount (Sketch.consume_hashes, K3 from indices): '
          '{:,} of {:,} windows counted into 4 x {:,} buckets in {:.2f} s, '
          '{} launch; tables == those of the consume kernel'.format(
              counted, valid.size, tablesize, wall, launches), flush=True)
    return launches


def phase_trio(device, workdir):
    """Phase 6: count and novel on the helium trio through the CLI, with
    the kernels and then with their plain versions on the card."""
    from kevlar_tpu_torch.ops import kmer_cuda, hashing, novel_ops, \
        sketch_ops

    t0 = time.time()
    refr, reads, denovo = make_trio_case(workdir)
    nreads = {}
    for who, path in reads.items():
        nreads[who] = os.path.getsize(path) // (16 + 2 * READLEN)
    print('[smoke] generated the helium trio ({:,} reads per sample, '
          '{:.1f} GB of FASTQ) in {:.1f} s'.format(
              nreads['proband'],
              sum(os.path.getsize(p) for p in reads.values()) / 1e9,
              time.time() - t0), flush=True)

    def novel_stage(prefix, fastq=reads['proband'], limits=('5', '1')):
        """The screen on the kernel run's counts; output ``prefix``ed."""
        path = os.path.join(workdir, prefix + 'novel.augfastq')
        wall = _run_cli(
            ['novel', '-k', str(KSIZE), '--device', device, '--case',
             fastq, '--case-counts',
             os.path.join(workdir, 'proband.ct'), '--control-counts',
             os.path.join(workdir, 'mother.ct'),
             os.path.join(workdir, 'father.ct'), '--case-min', limits[0],
             '--ctrl-max', limits[1], '-o', path],
            os.path.join(workdir, prefix + 'novel.log'))
        return path, wall

    # a dense screen: the proband's first reads with every k-mer a hit
    # (casemin 0, ctrlmax 255), which takes the novel stage past the screen's
    # capacity to the uncapped screen over the same words (the word
    # gather)
    dense_fastq = _head_fastq(reads['proband'],
                              os.path.join(workdir, 'dense.fq'),
                              DENSE_NOVEL_READS)

    # the main path, through the kernels
    for name in kmer_cuda.launches:
        kmer_cuda.launches[name] = 0
    walls = _trio_stages(device, workdir, refr, reads, '')
    novelpath, walls['novel'] = novel_stage('')
    launches = dict(kmer_cuda.launches)
    for name in NOVEL_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError('the helium run launched no {} kernel'
                                 .format(name))
    for name in kmer_cuda.launches:
        kmer_cuda.launches[name] = 0
    densepath, walls['novel dense'] = novel_stage(
        'dense_', dense_fastq, ('0', '255'))
    dense_launches = dict(kmer_cuda.launches)
    for name in ('kmer_hashes', 'screen_reads', 'gather_counts_words'):
        if dense_launches[name] <= 0:
            raise AssertionError('the dense screen launched no {} kernel'
                                 .format(name))

    # the same commands with the plain versions, on the card
    kernels = (kmer_cuda.kmer_hashes_cuda, kmer_cuda.gather_counts_cuda,
               kmer_cuda.consume_cuda, kmer_cuda.screen_reads_cuda,
               kmer_cuda.gather_words_cuda)
    kmer_cuda.kmer_hashes_cuda = hashing.kmer_hashes_plain
    kmer_cuda.gather_counts_cuda = sketch_ops.gather_counts_multi_plain
    kmer_cuda.consume_cuda = sketch_ops.consume_hashes_plain
    kmer_cuda.screen_reads_cuda = novel_ops.novel_screen_compact_plain
    kmer_cuda.gather_words_cuda = sketch_ops.gather_counts_words_plain
    before = dict(kmer_cuda.launches)
    try:
        plain_walls = _trio_stages(
            device, workdir, refr, reads, 'plain_', samples=('proband',),
            mask=os.path.join(workdir, 'mask.nt'))
        plainpath, plain_walls['novel'] = novel_stage('plain_')
        plaindense, plain_walls['novel dense'] = novel_stage(
            'plain_dense_', dense_fastq, ('0', '255'))
    finally:
        (kmer_cuda.kmer_hashes_cuda, kmer_cuda.gather_counts_cuda,
         kmer_cuda.consume_cuda, kmer_cuda.screen_reads_cuda,
         kmer_cuda.gather_words_cuda) = kernels
    if dict(kmer_cuda.launches) != before:
        raise AssertionError('the plain run launched a kernel')
    launches['scatter_add'] = _recount_path(device, workdir, reads)
    for name in ('mask.nt', 'refr.sct', 'proband.ct'):
        with np.load(os.path.join(workdir, name)) as got, \
                np.load(os.path.join(workdir, 'plain_' + name)) as want:
            for member in want.files:
                if not np.array_equal(got[member], want[member]):
                    raise AssertionError('{}: {} differs from the plain '
                                         'run'.format(name, member))
    with open(novelpath) as fh:
        novel_text = fh.read()
    with open(plainpath) as fh:
        if fh.read() != novel_text:
            raise AssertionError('novel output differs from the plain run')
    with open(densepath) as fh:
        dense_text = fh.read()
    with open(plaindense) as fh:
        if fh.read() != dense_text:
            raise AssertionError('the dense novel output differs from the '
                                 'plain run')
    print('[smoke] kernel run == plain run: mask.nt, refr.sct and '
          'proband.ct tables, and the novel text ({:,} bytes); novel '
          'launches kt_screen_reads {}, K1 {}, K2 {} (the counts\' masks); '
          'the dense screen of {:,} reads ({:,} k-mers, {:,} bytes, == '
          'plain): kt_screen_reads {}, word gather {} (past the '
          'capacity)'.format(
              len(novel_text), launches['screen_reads'],
              launches['kmer_hashes'], launches['gather_counts'],
              DENSE_NOVEL_READS, dense_text.count('#\n'), len(dense_text),
              dense_launches['screen_reads'],
              dense_launches['gather_counts_words']), flush=True)

    for stage, wall in walls.items():
        who = 'proband' if stage == 'novel' else stage.split()[-1]
        rate = ' ({:,.0f} reads/s)'.format(nreads[who] / wall) \
            if who in nreads else ''
        plain = plain_walls.get(stage)
        print('[smoke] stage {:<14s} {:7.2f} s{}{}'.format(
            stage, wall, rate, '; plain {:.2f} s'.format(plain)
            if plain is not None else ''), flush=True)

    print('[smoke] host share of count proband ({:.2f} s): reader {:.2f} s, '
          'reader into pinned memory + copies to the card {:.2f} s'.format(
              walls['count proband'], *_producer_split(reads['proband'],
                                                       device)), flush=True)

    # device busy share of a sample count, from a profiled repeat
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _run_cli(['count', '-k', str(KSIZE), '--device', device, '-M',
                         '500M', '--max-fpr', '0.2', '--mask',
                         os.path.join(workdir, 'mask.nt'),
                         os.path.join(workdir, 'prof_mother.ct'),
                         reads['mother']],
                        os.path.join(workdir, 'prof.log'))
    _print_busy('profiled count mother', prof, wall)

    records = read_augfastx_kmers(novelpath)
    inside = set().union(*(d[2] for d in denovo))
    nkmers = sum(len(ks) for _, ks in records)
    outside = [(name, k, a) for name, ks in records for k, a in ks
               if _canon(k) not in inside]
    out_reads = sum(1 for _, ks in records
                    if not any(_canon(k) in inside for k, _ in ks))
    print('[smoke] novel: {} reads, {} k-mers; outside the de novo windows: '
          '{} reads, {} k-mers ({} distinct){}'.format(
              len(records), nkmers, out_reads, len(outside),
              len({_canon(k) for _, k, _ in outside}),
              ''.join('\n[smoke]   outside: {} {} {}'.format(*o)
                      for o in outside[:5])), flush=True)
    found = {_canon(k) for _, ks in records for k, _ in ks}
    missed = []
    for pos, kind, kmers in denovo:
        hit = len(found & kmers)
        print('[smoke] de novo {:<10s} at {:>10,}: {} of its {} k-mers '
              'annotated'.format(kind, pos, hit, len(kmers)), flush=True)
        if not hit:
            missed.append((pos, kind))
    if missed:
        raise AssertionError('de novo loci without a novel read: {}'.format(
            missed))
    return dict(launches=launches, dense_launches=dense_launches,
                walls=walls, plain_walls=plain_walls, refr=refr,
                reads=reads, denovo=denovo)


# bench.py's batch shape and screen (bench.py:29-36; the constants of
# kevlar_tpu_torch.bench.count_novel, whose generators phase 13 runs),
# kept here because --compare-screen loads this file beside an older
# tree's package
BENCH_PADLEN = 160
BENCH_BATCH = 8192
BENCH_TABLESIZE = 2_000_003
BENCH_CASEMIN, BENCH_CTRLMAX = 6, 1
# the helium samples' sketches (-M 500M, 4 tables)
HELIUM_TABLESIZE = 124_999_999
# the program's own kernels, which phase 13 must launch
PROGRAM_KERNELS = ('kmer_hashes', 'consume', 'screen_reads')


def _read_packed_stack(fastq):
    """A FASTQ through the port's reader into ``kevlar_tpu``'s wire format:
    (packed [NB, BATCH, PADLEN/4], badmask [NB, BATCH, PADLEN/8], lengths
    [NB, BATCH] int32 (0 for padding rows), reads)."""
    from kevlar_tpu_torch.batch import native_base_batches, pack_bases
    packed, bad, lens = [], [], []
    nreads = 0
    for bases, lengths in native_base_batches(fastq, BENCH_BATCH):
        if bases.shape[1] != BENCH_PADLEN:
            raise AssertionError('{}: rows of {} bases, not {}'.format(
                fastq, bases.shape[1], BENCH_PADLEN))
        p, b = pack_bases(bases)
        packed.append(p)
        bad.append(b)
        row = np.zeros(BENCH_BATCH, np.int32)
        row[:len(lengths)] = lengths
        lens.append(row)
        nreads += len(lengths)
    return np.stack(packed), np.stack(bad), np.stack(lens), nreads


def _unsynced(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode('error')``: any
    operation in it that waits on the card raises."""
    import torch
    torch.cuda.set_sync_debug_mode('error')
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _valid_windows(packed, bad, ksize):
    """Windows of every row of a packed stack on the card that hold no
    code 4 (what the consume counts), by torch ops outside the program."""
    import torch
    from kevlar_tpu_torch.ops import hashing
    total = torch.zeros((), dtype=torch.int64, device=packed.device)
    for p, b in zip(packed, bad):
        codes = hashing.unpack_bases(p, b, BENCH_PADLEN)
        cum = torch.nn.functional.pad(
            torch.cumsum((codes >= 4).to(torch.int32), 1), (1, 0))
        total += ((cum[:, ksize:] - cum[:, :-ksize]) == 0).sum()
    return int(total)


def _program_bound(stacks, windows, ntables, tablesize):
    """(bound_ms, bound_by) of the count and screen on this run's data:
    every packed stack read once for its count and the case's again for
    its screen; each valid window's update in each table reads and writes
    its sector (the consume); each accumulator read and its tables written
    once, the tables read and the words written once (the pack); each
    valid case window's word in each table read as its sector (the
    screen); the hits' outputs are small beside these."""
    S = len(stacks)
    nwords = -(-S // 4)
    stack_bytes = [sum(x.nbytes for x in s) for s in stacks]
    nbytes = sum(stack_bytes) + stack_bytes[0]
    nbytes += sum(windows) * ntables * 2 * SECTOR
    nbytes += S * ntables * tablesize * (4 + 1)
    if S > 1:
        nbytes += ntables * tablesize * (S + 4 * nwords)
    nbytes += windows[0] * ntables * nwords * SECTOR
    nops = (sum(windows) + windows[0]) * (K1_OPS_PER_WINDOW +
                                          ntables * K2_OPS_PER_PROBE)
    return _bound(nbytes, nops)


def _drive_program(device, stacks, lens, nreads, tablesize, label,
                   plain=False, reps=3):
    """Copy the packed ``stacks`` ((packed, badmask) per sample, the case
    first) and the case's ``lens`` to the card, run
    ``count_and_screen_stack_packed`` once warm and ``reps`` times timed
    (each under the sync debug mode's 'error', ending in one
    synchronise), and with ``plain`` once more with the kernels' plain
    versions, every output and table equal.  Returns the walls, the
    launches of one run, the interesting k-mers and the bound."""
    import torch
    from kevlar_tpu_torch.ops import hashing, kmer_cuda, novel_ops, \
        sketch_ops
    torch.cuda.synchronize()
    t0 = time.time()
    dev = [tuple(torch.from_numpy(x).to(device) for x in s) for s in stacks]
    dlens = torch.from_numpy(lens).to(device)
    torch.cuda.synchronize()
    h2d_ms = 1e3 * (time.time() - t0)
    kw = dict(L=BENCH_PADLEN, ksize=KSIZE, tablesize=tablesize, ntables=4,
              maxcount=255, casemin=BENCH_CASEMIN, ctrlmax=BENCH_CTRLMAX)

    def run():
        return novel_ops.count_and_screen_stack_packed(
            dev[0][0], dev[0][1], tuple(p for p, _ in dev[1:]),
            tuple(b for _, b in dev[1:]), dlens, **kw)

    for name in kmer_cuda.launches:
        kmer_cuda.launches[name] = 0
    out = _unsynced(run)
    torch.cuda.synchronize()
    launches = dict(kmer_cuda.launches)
    for name in PROGRAM_KERNELS:
        if launches[name] <= 0:
            raise AssertionError('{}: the program launched no {} kernel'
                                 .format(label, name))
    walls = []
    for _ in range(reps):
        del out
        torch.cuda.synchronize()
        t0 = time.time()
        out = _unsynced(run)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    interesting = int(out[0][2].sum())
    # one more run under torch.profiler: the card's busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        prof_wall = time.time() - t0
    busy = _print_busy('count_and_screen_stack_packed, {}, profiled run'
                       .format(label), prof, prof_wall) / prof_wall
    del prof
    result = dict(h2d_ms=h2d_ms, walls=walls, ms=1e3 * min(walls),
                  busy=busy,
                  launches=launches, interesting=interesting,
                  reads_per_s=(2 * nreads[0] + sum(nreads[1:])) /
                  min(walls))
    windows = [_valid_windows(p, b, KSIZE) for p, b in dev]
    result['bound_ms'], result['bound_by'] = _program_bound(
        stacks, windows, 4, tablesize)
    if plain:
        kernels = (kmer_cuda.kmer_hashes_cuda, kmer_cuda.consume_cuda,
                   kmer_cuda.screen_reads_cuda)
        kmer_cuda.kmer_hashes_cuda = hashing.kmer_hashes_plain
        kmer_cuda.consume_cuda = sketch_ops.consume_hashes_plain
        kmer_cuda.screen_reads_cuda = novel_ops.novel_screen_compact_plain
        before = dict(kmer_cuda.launches)
        try:
            t0 = time.time()
            want = run()
            torch.cuda.synchronize()
            result['plain_s'] = time.time() - t0
        finally:
            (kmer_cuda.kmer_hashes_cuda, kmer_cuda.consume_cuda,
             kmer_cuda.screen_reads_cuda) = kernels
        if dict(kmer_cuda.launches) != before:
            raise AssertionError('{}: the plain run launched a kernel'
                                 .format(label))
        got_all = list(out[0]) + [out[1]] + list(out[2])
        want_all = list(want[0]) + [want[1]] + list(want[2])
        names = ['hit_idx', 'hit_abunds', 'n_hits', 'discard', 'skip',
                 'case tables'] + ['control {} tables'.format(i)
                                   for i in range(len(out[2]))]
        result['err'] = max(_max_diff(g, w, '{} program, {}'.format(
            label, name)) for g, w, name in zip(got_all, want_all, names))
    del out, dev
    print('[smoke] count_and_screen_stack_packed, {}: {} samples of {} '
          'reads, [NB, {}, {}] stacks; H2D {:.1f} ms; program best of {} '
          '{:.1f} ms ({}), one synchronise, no sync inside (sync debug '
          'mode error); count_novel_reads_per_s {:,.0f}; interesting k-mers '
          '{:,}; bound {:.1f} ms by {}; launches a run: {}{}'.format(
              label, len(stacks), ', '.join('{:,}'.format(n) for n in nreads),
              BENCH_BATCH, BENCH_PADLEN, result['h2d_ms'], reps,
              result['ms'], ', '.join('{:.1f}'.format(1e3 * w)
                                      for w in walls),
              result['reads_per_s'], interesting, result['bound_ms'],
              result['bound_by'], ', '.join(
                  '{} {}'.format(n, launches[n]) for n in PROGRAM_KERNELS),
              '; plain versions {:.1f} s, every output and table equal '
              '(error {})'.format(result['plain_s'], result['err'])
              if plain else ''), flush=True)
    return result


def _program_at_bench_trio(device, plain=False):
    """``count_and_screen_stack_packed`` on bench.py's trio (the generators
    of ``kevlar_tpu_torch.bench.count_novel``), its interesting k-mers held
    to ``host_pipeline``'s on the same reads; returns the program's
    record and the trio."""
    from kevlar_tpu_torch.batch import pack_bases
    from kevlar_tpu_torch.bench import count_novel
    case, mom, dad = count_novel.bench_trio(count_novel.GENOME_LEN)
    lens = np.full((-(-len(case) // count_novel.BATCH), count_novel.BATCH),
                   READLEN, np.int32)
    lens.reshape(-1)[len(case):] = 0
    stacks = [pack_bases(count_novel.stack_all(r)) for r in (case, mom, dad)]
    bench = _drive_program(device, stacks, lens,
                           (len(case), len(mom), len(dad)), BENCH_TABLESIZE,
                           "bench.py's trio", plain=plain)
    _, host_hits = count_novel.host_pipeline(case, [mom, dad])
    if host_hits != bench['interesting']:
        raise AssertionError('bench.py\'s trio: {} interesting k-mers, '
                             'host_pipeline {}'.format(bench['interesting'],
                                                       host_hits))
    return bench, (case, mom, dad)


def phase_count_screen(device, reads, tablesize=HELIUM_TABLESIZE):
    """Phase 13: ``count_and_screen_stack_packed`` on the card at
    bench.py's trio and on phase 6's helium trio."""
    from concurrent.futures import ThreadPoolExecutor
    from kevlar_tpu_torch.bench import count_novel
    smi = _nvidia_smi()

    # (a) bench.py's trio, its interesting k-mers against host_pipeline's
    bench, (case, mom, dad) = _program_at_bench_trio(device)
    # host_pipeline on bench.py's subset, best of 3, as bench.py times it
    sub = max(len(case) // 8, count_novel.BATCH)
    host_s = min(count_novel.host_pipeline(
        case[:sub], [mom[:sub], dad[:sub]])[0] for _ in range(3))
    bench['host_ms'] = 1e3 * host_s
    bench['host_reads'] = 4 * sub
    bench['vs_baseline'] = bench['reads_per_s'] / (4 * sub / host_s)
    print('[smoke] bench.py\'s trio: interesting k-mers == host_pipeline\'s '
          '({:,}); host_pipeline on {:,} reads {:.1f} ms (best of 3), '
          'vs_baseline {:.2f}; {}'.format(
              bench['interesting'], 4 * sub, bench['host_ms'],
              bench['vs_baseline'], smi), flush=True)

    # (b) helium: the trio's FASTQ through the port's reader, packed on
    # the host, three samples at once
    t0 = time.time()
    with ThreadPoolExecutor(len(SAMPLES)) as pool:
        read = list(pool.map(_read_packed_stack,
                             [reads[who] for who in SAMPLES]))
    print('[smoke] helium stacks read and packed in {:.1f} s'.format(
        time.time() - t0), flush=True)
    helium = _drive_program(
        device, [(p, b) for p, b, _, _ in read], read[0][2],
        tuple(n for _, _, _, n in read), tablesize, 'helium', plain=True)
    print('[smoke] {}'.format(smi), flush=True)
    return dict(bench=bench, helium=helium, launches=helium['launches'])


# what the JAX entries print: bench.py's keys, bench_call.py's and
# bench_configs.py's metric names, tools/sim_trio_bench.py's keys
COUNT_NOVEL_KEYS = ['metric', 'value', 'unit', 'vs_baseline']
CALL_METRICS = ['assemble_call_contigs_per_s_host',
                'call_align_contigs_per_s_device',
                'call_align_contigs_per_s_device_batched']
CONFIG_METRICS = [(0, 'count_3_samples_wall_s'),
                  (2, 'novel_filter_partition_wall_s'),
                  (3, 'assemble_localize_wall_s'),
                  (4, 'full_calling_wall_s'),
                  (5, 'sharded_count_novel_wall_s')]
SIM_TRIO_KEYS = ['metric', 'preset', 'stage_wall_s', 'genome_size',
                 'coverage', 'error_rate', 'denovo_found', 'denovo_total',
                 'pass_calls', 'false_positives', 'workflow_wall_s',
                 'seed_index_wall_s', 'total_wall_s', 'peak_rss_mb']
# tools/sim_trio_bench.py's default draw through kevlar_tpu (CPU backend)
# and through the port on the CPU, final VCFs equal: the 314 bp insertion
# is called as a 186 bp one and a 14 bp deletion is called where no
# variant lies, so 10 of 11 de novo variants are found with 2 false
# positives (BENCH_TRIO_TPU.json's 11 of 11 is an older kevlar_tpu's);
# the sha256 is of the final VCF without its ##fileDate line
SIM_TRIO_SCORE = dict(denovo_found=10, denovo_total=11, pass_calls=12,
                      false_positives=2)
SIM_TRIO_VCF_SHA256 = ('78eff3fcb39f5f0d17f540a525167f67'
                       '211f82c74f6c92e6493d18ba3a9e6116')


def _reset_launches():
    from kevlar_tpu_torch.ops import align_cuda, kmer_cuda
    for name in kmer_cuda.launches:
        kmer_cuda.launches[name] = 0
    align_cuda.launches = 0


def _entry_launches(label, required):
    """The kmer kernels' and B1's launches since :func:`_reset_launches`;
    each kernel in ``required`` (B1 as 'ksw_extz') must have launched."""
    from kevlar_tpu_torch.ops import align_cuda, kmer_cuda
    launches = dict(kmer_cuda.launches, ksw_extz=align_cuda.launches)
    for name in required:
        if launches[name] <= 0:
            raise AssertionError('{}: no {} kernel launched'.format(label,
                                                                   name))
    return {name: launches[name] for name in required}


def _run_entry(name, module, argv):
    """``module.main(argv)`` in this process, its standard output captured
    and then printed on the smoke's lines.  Returns what ``main``
    returned, the JSON objects of its output lines and its wall
    seconds."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            ret = module.main(argv)
    finally:
        for line in buf.getvalue().splitlines():
            print('[smoke] {}: {}'.format(name, line), flush=True)
    return ret, [json.loads(line) for line in buf.getvalue().splitlines()], \
        time.time() - t0


def bench_count_novel(device, interesting):
    """Phase 14's ``kevlar_tpu_torch.bench.count_novel`` at bench.py's
    sizes: bench.py's JSON keys, K1, ``kt_consume`` and
    ``kt_screen_reads`` launched, and the interesting k-mers of phase
    13 (a) (``interesting``), the same trio."""
    from kevlar_tpu_torch.bench import count_novel
    _reset_launches()
    ret, lines, wall = _run_entry('count_novel', count_novel,
                                  ['--device', device])
    launches = _entry_launches('count_novel', PROGRAM_KERNELS)
    if list(lines[-1]) != COUNT_NOVEL_KEYS or \
            lines[-1]['metric'] != 'count_novel_reads_per_s':
        raise AssertionError('count_novel printed {}'.format(lines[-1]))
    if ret['interesting'] != interesting:
        raise AssertionError('count_novel: {} interesting k-mers, phase 13 '
                             '{}'.format(ret['interesting'], interesting))
    print('[smoke] count_novel entry: {:,.1f} reads/s, vs_baseline {}; '
          'best run {:.3f} ms = copies {:.3f} ms + program and read-back '
          '{:.3f} ms; interesting k-mers {:,} == phase 13\'s; host_pipeline '
          '{:.1f} ms for {:,} reads; reference architecture {:,.0f} reads/s; '
          'launches {}; {:.1f} s in all'.format(
              lines[-1]['value'], lines[-1]['vs_baseline'],
              1e3 * ret['wall_s'], 1e3 * ret['copy_s'],
              1e3 * ret['program_s'], interesting, 1e3 * ret['host_s'],
              ret['host_reads'], ret['ref_reads_per_s'], launches, wall),
          flush=True)
    return dict(ret, launches=launches, entry_s=wall)


def bench_call(device):
    """Phase 14's ``kevlar_tpu_torch.bench.call`` at bench_call.py's
    sizes: bench_call.py's three metrics, B1 launched, and the 128 rows'
    (cigar, score) pairs from the card equal to the plain version's."""
    from kevlar_tpu_torch.bench import call
    from kevlar_tpu_torch.ops.align_cuda import align_batch
    _reset_launches()
    ret, lines, wall = _run_entry('call', call, ['--device', device])
    launches = _entry_launches('call', ['ksw_extz'])
    if [line['metric'] for line in lines] != CALL_METRICS or any(
            list(line) != ['metric', 'value', 'unit'] for line in lines):
        raise AssertionError('call printed {}'.format(lines))
    t0 = time.time()
    plain = align_batch(ret['targets'], ret['queries'], device='cpu')
    plain_s = time.time() - t0
    bad = [k for k, (got, want) in enumerate(zip(ret['aligned'], plain))
           if got != want]
    if bad or len(plain) != len(ret['aligned']):
        raise AssertionError('call: {} of {} rows differ from the plain '
                             'version, the first {}'.format(
                                 len(bad), len(plain), bad[:1]))
    print('[smoke] call entry: {}; {} rows from the card == the plain '
          'version\'s on the CPU ({:.1f} s); launches {}; {:.1f} s in all'
          .format(', '.join('{} {}'.format(line['metric'], line['value'])
                            for line in lines), len(plain), plain_s,
                  launches, wall), flush=True)
    return dict(ret, lines=lines, launches=launches, entry_s=wall)


def bench_configs(device, workdir):
    """Phase 14's ``kevlar_tpu_torch.bench.configs`` at its defaults:
    bench_configs.py's five configs, every de novo variant a PASS call
    (config 4) and the sharded novel text equal to the unsharded one
    (config 5)."""
    from kevlar_tpu_torch.bench import configs
    _reset_launches()
    art, lines, wall = _run_entry('configs', configs, [
        '--device', device, '--workdir', os.path.join(workdir, 'configs')])
    launches = _entry_launches('configs', PROGRAM_KERNELS + ('ksw_extz',))
    if [(line['config'], line['metric']) for line in lines] != \
            CONFIG_METRICS or lines != art['results']:
        raise AssertionError('configs printed {}'.format(lines))
    calling = lines[3]['detail']
    if calling['denovo_pass'] != calling['denovo_total']:
        raise AssertionError('configs: {} of {} de novo variants PASS'
                             .format(calling['denovo_pass'],
                                     calling['denovo_total']))
    if not lines[4]['detail']['output_identical_to_unsharded']:
        raise AssertionError('configs: the sharded novel text differs')
    print('[smoke] configs entry: {}; de novo PASS {} of {}; sharded == '
          'unsharded; launches {}; {:.1f} s in all'.format(
              ', '.join('config {} {} {} s'.format(c, m, line['value'])
                        for (c, m), line in zip(CONFIG_METRICS, lines)),
              calling['denovo_pass'], calling['denovo_total'], launches,
              wall), flush=True)
    return dict(lines=lines, launches=launches, entry_s=wall)


def bench_sim_trio(device, workdir):
    """Phase 14's ``kevlar_tpu_torch.bench.sim_trio`` at its defaults (1
    Mb, 25x, 11 de novo): tools/sim_trio_bench.py's keys, and the final
    VCF and its score those of ``kevlar_tpu`` on the same draw."""
    import gzip
    import hashlib
    from kevlar_tpu_torch.bench import sim_trio
    _reset_launches()
    simdir = os.path.join(workdir, 'sim_trio')
    rec, lines, wall = _run_entry('sim_trio', sim_trio, [
        '--device', device, '--workdir', simdir])
    launches = _entry_launches('sim_trio', NOVEL_PATH_KERNELS +
                               ('ksw_extz',))
    if list(lines[-1]) != SIM_TRIO_KEYS or lines[-1] != rec or \
            rec['metric'] != 'trio_workflow':
        raise AssertionError('sim_trio printed {}'.format(lines))
    score = {key: rec[key] for key in SIM_TRIO_SCORE}
    if score != SIM_TRIO_SCORE:
        raise AssertionError('sim_trio scored {}, kevlar_tpu {}'.format(
            score, SIM_TRIO_SCORE))
    with gzip.open(os.path.join(simdir, 'out', 'calls.scored.sorted.vcf.gz'),
                   'rt') as fh:
        digest = hashlib.sha256(''.join(
            line for line in fh if not line.startswith('##fileDate'))
            .encode()).hexdigest()
    if digest != SIM_TRIO_VCF_SHA256:
        raise AssertionError('sim_trio: the final VCF differs from '
                             'kevlar_tpu\'s (sha256 {})'.format(digest))
    print('[smoke] sim_trio entry: workflow {} s; de novo {} of {}, {} PASS '
          'calls, {} false positives, the final VCF == kevlar_tpu\'s on the '
          'same draw; launches {}; {:.1f} s in all'.format(
              rec['workflow_wall_s'], rec['denovo_found'],
              rec['denovo_total'], rec['pass_calls'], rec['false_positives'],
              launches, wall), flush=True)
    return dict(rec=rec, launches=launches, entry_s=wall)


def phase_bench_entries(device, workdir, interesting):
    """Phase 14: the four bench entries of ``kevlar_tpu_torch.bench`` in
    this process on the card."""
    t0 = time.time()
    out = dict(count_novel=bench_count_novel(device, interesting),
               call=bench_call(device),
               configs=bench_configs(device, workdir),
               sim_trio=bench_sim_trio(device, workdir))
    print('[smoke] bench entries: {:.1f} s; {}'.format(
        time.time() - t0, _nvidia_smi()), flush=True)
    return out


# ------------------------------------------------- phase 15: bench tools

# what tools/helium_workflow_only.py and tools/control_plane_stress.py
# print
WORKFLOW_ONLY_KEYS = ['metric', 'wall_s', 'peak_rss_mb', 'pass_calls',
                      'stage_wall_s']
CONTROL_PLANE_KEYS = ['suite', 'scale_vs_bigsim', 'cc_bigsim_scale',
                      'cc_human_scale', 'partition_stage_human_scale',
                      'localize_cluster_human_scale']
# control_plane's default scale over the 80 Mb bigsim run (~human)
CONTROL_PLANE_SCALE = 40.0


def bench_verify(device):
    """Phase 15 (a): ``python -m kevlar_tpu_torch.bench.verify_e2e`` on the
    card, each of its nine stages a process of its own: exit 0,
    VERIFY_PASS, and three PASS calls, the de novo truth rows."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, '-m', 'kevlar_tpu_torch.bench.verify_e2e',
         '--device', device], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.time() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        print('[smoke] verify_e2e: {}'.format(line), flush=True)
    if proc.returncode != 0 or not lines or lines[-1] != 'VERIFY_PASS':
        raise AssertionError('verify_e2e: exit {}, last line {!r}:\n{}'
                             .format(proc.returncode, lines[-1:],
                                     proc.stderr[-4000:]))
    truth = [line for line in lines if line.startswith('truth de novo:')]
    calls = [line for line in lines if line.startswith('PASS calls:')]
    if len(truth) != 1 or len(calls) != 1 or \
            truth[0].split(':', 1)[1].strip() != \
            calls[0].split(':', 1)[1].strip() or \
            truth[0].count('chr1') != 3:
        raise AssertionError('verify_e2e: {} against {}'.format(calls,
                                                                 truth))
    workdir = lines[0].split(':', 1)[1].strip()
    if lines[0].startswith('verify workdir:') and os.path.isdir(workdir):
        import shutil
        shutil.rmtree(workdir)
    print('[smoke] verify_e2e entry: VERIFY_PASS, exit 0, 3 PASS calls == '
          'the de novo truth rows; {:.1f} s in all (nine stage processes)'
          .format(wall), flush=True)
    return dict(entry_s=wall)


def workflow_only_main(workdir):
    """``chip_smoke.py --workflow-only DIR``: phase 15 (b) in a process of
    its own: the entry on the card, the kernels of the novel path and B1
    required, then one JSON line with the record, the launches and
    ``run_mark1``'s stage names."""
    from kevlar_tpu_torch import workflow
    from kevlar_tpu_torch.bench import helium_workflow_only
    _reset_launches()
    record = helium_workflow_only.main(
        [workdir, str(HELIUM_COVERAGE), '--device', 'cuda'])
    launches = _entry_launches('helium_workflow_only',
                               NOVEL_PATH_KERNELS + ('ksw_extz',))
    print(json.dumps({'record': record, 'launches': launches,
                      'stages': [stage for stage, _ in
                                 workflow.run_mark1.last_stage_times]}))
    return 0


def bench_workflow_only(workdir, refr, reads, denovo):
    """Phase 15 (b): ``kevlar_tpu_torch.bench.helium_workflow_only`` on
    phase 6's helium trio at 30x, in a directory of links (``genome.fa``
    and its seed index, the three FASTQs) and a process of its own: JAX's
    keys, the stage names of ``run_mark1``, K1, K2, ``kt_consume``,
    ``kt_screen_reads`` and B1 launched, and the PASS calls through phase
    9's de novo gate."""
    from kevlar_tpu_torch import reference
    linkdir = os.path.join(workdir, 'workflow_only')
    os.makedirs(linkdir)
    genome = os.path.join(linkdir, 'genome.fa')
    os.symlink(refr, genome)
    if not os.path.exists(reference.index_path(refr, 51)):
        reference.autoindex(refr, 51)
    os.symlink(reference.index_path(refr, 51),
               reference.index_path(genome, 51))
    for who in SAMPLES:
        os.symlink(reads[who], os.path.join(linkdir, who + '.fq'))
    # a process's ru_maxrss keeps the peak of the process it was forked
    # from across exec, so this one's would carry the smoke's: a shell in
    # between forks the entry's process from its own small one
    t0 = time.time()
    proc = subprocess.run(
        ['sh', '-c', '"$0" "$1" --workflow-only "$2"; exit $?',
         sys.executable, os.path.abspath(__file__), linkdir],
        stdout=subprocess.PIPE, text=True, check=True)
    wall = time.time() - t0
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        print('[smoke] helium_workflow_only: {}'.format(line), flush=True)
    record, child = json.loads(lines[-2]), json.loads(lines[-1])
    if list(record) != WORKFLOW_ONLY_KEYS or record != child['record'] or \
            record['metric'] != 'helium_workflow_only' or \
            list(record['stage_wall_s']) != child['stages']:
        raise AssertionError('helium_workflow_only printed {}, stages {}'
                             .format(record, child['stages']))
    final = os.path.join(linkdir, 'out', 'calls.scored.sorted.vcf.gz')
    _, passing = _denovo_gate(final, denovo)
    if record['pass_calls'] != len(passing):
        raise AssertionError('helium_workflow_only: {} PASS calls, the '
                             'final VCF {}'.format(record['pass_calls'],
                                                   len(passing)))
    print('[smoke] helium_workflow_only entry: workflow {} s, peak RSS {} '
          'MB (its own process); {} PASS calls through phase 9\'s de novo '
          'gate; stages {}; launches {}; {:.1f} s in all; {}'.format(
              record['wall_s'], record['peak_rss_mb'], record['pass_calls'],
              list(record['stage_wall_s']), child['launches'], wall,
              _nvidia_smi()), flush=True)
    return dict(record=record, launches=child['launches'], entry_s=wall)


def bench_control_plane(device, scale):
    """Phase 15 (c): ``kevlar_tpu_torch.bench.control_plane`` at ``scale``
    in this process: JAX's keys, K4 launched, and K4's labels equal to the
    host union-find's (the entry asserts it)."""
    from kevlar_tpu_torch.bench import control_plane
    from kevlar_tpu_torch.ops import cc_cuda
    cc_cuda.launches['cc_labels'] = 0
    ret, lines, wall = _run_entry('control_plane', control_plane, [
        '--device', device, '--scale', str(scale)])
    launches = cc_cuda.launches['cc_labels']
    if launches <= 0:
        raise AssertionError('control_plane: K4 never launched')
    if list(lines[-1]) != CONTROL_PLANE_KEYS or lines[-1] != ret:
        raise AssertionError('control_plane printed {}'.format(lines))
    cc, part, loc = (ret['cc_human_scale'],
                     ret['partition_stage_human_scale'],
                     ret['localize_cluster_human_scale'])
    print('[smoke] control_plane entry at scale {}: {:,} pairs, {:,} reads; '
          'host union-find {} s, K4 first {} s, steady {} s (copies and '
          'labels back included), labels equal; partition stage: {:,} '
          'reads, load {} s, partitions {} s, {:,} found; localize: {:,} '
          'hits, add {} s, cluster {} s, {:,} cutouts; K4 launches {}; '
          '{:.1f} s in all; {}'.format(
              scale, cc['incidences'], cc['reads'], cc['host_union_find_s'],
              cc['device_label_prop_first_s'],
              cc['device_label_prop_steady_s'], part['reads'],
              part['graph_load_s'], part['partitions_s'],
              part['partitions_found'], loc['seed_hits'], loc['add_s'],
              loc['cluster_s'], loc['cutouts'], launches, wall,
              _nvidia_smi()), flush=True)
    return dict(ret, launches=launches, entry_s=wall)


def phase_bench_tools(device, workdir, trio, scale=CONTROL_PLANE_SCALE):
    """Phase 15: the three bench tools of ``kevlar_tpu_torch.bench`` on the
    card, then K4 alone on the control plane's incidence at ``scale``,
    queued behind a spin kernel, beside its plain version and its bound."""
    import torch
    from kevlar_tpu_torch.bench import control_plane
    from kevlar_tpu_torch.ops import cc_cuda, cc_ops
    t0 = time.time()
    out = dict(verify=bench_verify(device),
               workflow_only=bench_workflow_only(
                   workdir, trio['refr'], trio['reads'], trio['denovo']),
               control_plane_1=bench_control_plane(device, 1.0))
    full = bench_control_plane(device, scale)
    reads, kmers, n_reads, n_kmers = control_plane.cc_incidence(scale)
    r = torch.from_numpy(reads).to(device)
    k = torch.from_numpy(kmers).to(device)
    got, ms = _timed(cc_cuda.cc_labels_cuda, r, k, n_reads, n_kmers,
                     reps=20, spin=True)
    want, plain_ms = _timed(cc_ops.connected_components_plain, r, k, n_reads,
                            n_kmers, reps=3)
    err = _max_diff(got, want, 'K4 control plane')
    bound_ms, bound_by = _cc_bound(r.numel(), n_reads, n_kmers)
    shape = '{:,} pairs, {:,} reads, {:,} k-mers (control_plane at scale ' \
        '{})'.format(r.numel(), n_reads, n_kmers, scale)
    print('[smoke] K4 cc_labels: {} kernel {:.4f} ms (one pass, three '
          'launches, queued behind a spin kernel), plain {:.3f} ms, bound '
          '{:.4f} ms by {}; {}'.format(shape, ms, plain_ms, bound_ms,
                                       bound_by, _nvidia_smi()), flush=True)
    out['control_plane'] = full
    out['cc'] = dict(shape=shape, launches=full['launches'], ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     max_abs_err=err)
    print('[smoke] bench tools: {:.1f} s'.format(time.time() - t0),
          flush=True)
    return out


# ------------------------------------------------------ phase 16: bigsim

# tools/bigsim_bench.py's defaults cut to 1/8: a 10 Mb genome, 1,500 and
# 1,000 variants x 10/80; its coverage, error, read length, seed and stage
# arguments as they are
BIGSIM_ARGV = ['--genome-size', '10000000', '--denovo', '188',
               '--inherited', '125', '--repeats', '--class-balanced']
# what tools/bigsim_bench.py writes and prints last
BIGSIM_KEYS = ['suite', 'backend', 'genome_size', 'coverage', 'error_rate',
               'reads_per_sample', 'denovo_simulated', 'denovo_in_truth',
               'sketch_memory', 'repeat_genome', 'repeat_composition',
               'wall_s', 'total_wall_s', 'evaluation',
               'evaluation_reference_protocol', 'reference_30x_scored',
               'reference_30x_operating_point', 'note']
BIGSIM_LINE_KEYS = ['metric', 'value', 'unit', 'fdr', 'total_wall_s']
# the kernels of its path: K1 and kt_consume in every count, the screen in
# novel, B1 in alac (K4 only where partition sees 200,000 pairs)
BIGSIM_KERNELS = ('kmer_hashes', 'consume', 'screen_reads', 'ksw_extz')


def _per_class_recall(evaluation):
    return ', '.join('{} {}/{}'.format(name, c['tp'], c['total'])
                     for name, c in evaluation['per_class'].items())


def phase_bigsim(device):
    """Phase 16: (a) ``kevlar_tpu_torch.bench.bigsim`` in this process at
    :data:`BIGSIM_ARGV` in a temporary directory outside the repository:
    JAX's keys and last line, K1, ``kt_consume``, ``kt_screen_reads`` and
    B1 launched, a recall of at least ``MIN_RECALL`` under both scorers;
    (b) ``kevlar_tpu_torch.bench.miss_forensics`` on (a)'s work
    directory: every miss of the reference protocol given a stage."""
    import contextlib
    import io
    import resource
    from kevlar_tpu_torch.bench import bigsim, miss_forensics
    t0 = time.time()
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    with tempfile.TemporaryDirectory(prefix='kevlar_bigsim_') as tmp:
        workdir = os.path.join(tmp, 'work')
        out = os.path.join(tmp, 'bigsim.json')
        _reset_launches()
        rec, lines, wall = _run_entry('bigsim', bigsim, [
            '--device', device] + BIGSIM_ARGV + [
            '--workdir', workdir, '--out', out])
        launches = _entry_launches('bigsim', BIGSIM_KERNELS)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        with open(out) as fh:
            written = json.load(fh)
        if list(rec) != BIGSIM_KEYS or written != json.loads(
                json.dumps(rec)) or list(lines[-1]) != BIGSIM_LINE_KEYS or \
                lines[-1]['metric'] != 'bigsim_recall' or \
                rec['backend'] != device:
            raise AssertionError('bigsim printed {}, returned keys {}'.format(
                lines, list(rec)))
        ev, ref = rec['evaluation'], rec['evaluation_reference_protocol']
        for label, e in (('evaluation', ev),
                         ('evaluation_reference_protocol', ref)):
            if e['recall'] is None or e['recall'] < MIN_RECALL:
                raise AssertionError('bigsim: {} recall {} < {}'.format(
                    label, e['recall'], MIN_RECALL))
        print('[smoke] bigsim entry ({}): reads a sample {}; walls {} s, '
              '{} s in all ({:.1f} s with set-up); evaluation recall {} '
              'FDR {} ({} TP, {} FP, {} collisions of {}); reference '
              'protocol recall {} FDR {} ({} TP, {} FP, {} missing; {} PASS '
              'calls, {} compacted); per class: evaluation {}; reference '
              'protocol {}; repeats {}; launches {}; peak RSS of the process '
              '{:.0f} MB after the run, {:.0f} MB before it; {}'.format(
                  ' '.join(BIGSIM_ARGV), rec['reads_per_sample'],
                  rec['wall_s'], rec['total_wall_s'], wall, ev['recall'],
                  ev['fdr'], ev['tp'], ev['fp'], ev['collisions'],
                  ev['total_truth'], ref['recall'], ref['fdr'], ref['tp'],
                  ref['fp'], ref['missing'], ref['calls_pass'],
                  ref['calls_compacted'], _per_class_recall(ev),
                  _per_class_recall(ref), rec['repeat_composition'],
                  launches, rss, rss_before, _nvidia_smi()), flush=True)

        buf = io.StringIO()
        t1 = time.time()
        with contextlib.redirect_stdout(buf):
            forensics = miss_forensics.main([workdir])
        fwall = time.time() - t1
        printed = json.loads(buf.getvalue())
        print('[smoke] miss_forensics: {}'.format(json.dumps(printed)),
              flush=True)
        n_miss = forensics['n_miss']
        if printed != json.loads(json.dumps(dict(
                forensics, misses='[{} rows]'.format(n_miss)))) or \
                n_miss != ref['missing'] or \
                sum(forensics['by_stage'].values()) != n_miss or \
                len(forensics['misses']) != n_miss:
            raise AssertionError('miss_forensics: {} misses by stage {}, '
                                 'the reference protocol {}'.format(
                                     n_miss, forensics['by_stage'],
                                     ref['missing']))
        print('[smoke] miss_forensics entry: {} misses of {}, by stage {}; '
              '{:.1f} s'.format(n_miss, forensics['n_truth'],
                                forensics['by_stage'], fwall), flush=True)
    print('[smoke] bigsim: {:.1f} s'.format(time.time() - t0), flush=True)
    return dict(rec=rec, launches=launches, forensics=forensics['by_stage'],
                entry_s=wall)


def _cc_graphs(rng):
    """Seeded incidences (name, read_ids, kmer_ids, n_reads, n_kmers)."""
    graphs = []
    for n_reads, n_kmers, E in ((1000, 3000, 1500), (200_000, 600_000,
                                                     2_000_000)):
        graphs.append(('random {:,} pairs'.format(E),
                       rng.integers(0, n_reads, E),
                       rng.integers(0, n_kmers, E), n_reads, n_kmers))
    # a chain read - k-mer - read - ..., read indices shuffled so that the
    # minimum sits anywhere: diameter 5,000 reads
    n = 5000
    perm = rng.permutation(n)
    graphs.append(('chain of {:,} reads'.format(n),
                   np.concatenate([perm[:-1], perm[1:]]),
                   np.tile(np.arange(n - 1), 2), n, n - 1))
    # isolated reads, k-mers held by one read, duplicate pairs
    reads = rng.integers(0, 5000, 20000) * 2          # odd reads isolated
    kmers = rng.integers(0, 40000, 20000)             # most k-mers single
    dup = rng.integers(0, 20000, 5000)
    graphs.append(('isolated/single/duplicate',
                   np.concatenate([reads, reads[dup]]),
                   np.concatenate([kmers, kmers[dup]]), 10001, 40000))
    graphs.append(('E = 0', np.zeros(0), np.zeros(0), 17, 1))
    graphs.append(('E = 1', np.array([5]), np.array([0]), 9, 1))
    return [(name, r.astype(np.int32), k.astype(np.int32), nr, nk)
            for name, r, k, nr, nk in graphs]


def _cc_bound(E, n_reads, n_kmers):
    """The least K4's function costs, whatever computes it: the pairs (two
    int32 each) read once and a label written per node, and a handful of
    integer operations a pair.  K4 is three launches in a row, which have a
    floor of a few microseconds of their own beside this."""
    return _bound(8 * E + 4 * (n_reads + n_kmers), 8 * E)


def phase_cc_kernel(device, incidence):
    """Phase 7: K4 against its plain version on seeded graphs (each timed,
    queued behind a spin kernel), then both timed on ``incidence`` (phase
    8's read-k-mer pairs)."""
    import torch
    from kevlar_tpu_torch.ops import cc_cuda, cc_ops
    rng = np.random.default_rng(SEED + 7)
    err = 0
    for name, reads, kmers, n_reads, n_kmers in _cc_graphs(rng):
        r = torch.from_numpy(reads).to(device)
        k = torch.from_numpy(kmers).to(device)
        got, ms = _timed(cc_cuda.cc_labels_cuda, r, k, n_reads, n_kmers,
                         reps=5, spin=True)
        torch.cuda.synchronize()
        t0 = time.time()
        want = cc_ops.connected_components_plain(r, k, n_reads, n_kmers)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.time() - t0)
        err = max(err, _max_diff(got, want, 'K4 ' + name))
        print('[smoke] K4 vs plain, {}: identical ({} components); kernel '
              '{:.4f} ms, plain {:.1f} ms, bound {:.5f} ms by {}'.format(
                  name, len(torch.unique(got)), ms, plain_ms,
                  *_cc_bound(len(reads), n_reads, n_kmers)), flush=True)
    r, k, n_reads, n_kmers = incidence
    got, ms = _timed(cc_cuda.cc_labels_cuda, r, k, n_reads, n_kmers,
                     reps=20, spin=True)
    want, plain_ms = _timed(cc_ops.connected_components_plain, r, k, n_reads,
                            n_kmers, reps=3)
    err = max(err, _max_diff(got, want, 'K4 bigsim partition'))
    shape = '{:,} pairs, {:,} reads, {:,} k-mers'.format(r.numel(), n_reads,
                                                         n_kmers)
    bound_ms, bound_by = _cc_bound(r.numel(), n_reads, n_kmers)
    print('[smoke] K4 cc_labels: {} kernel {:.4f} ms (one pass, three '
          'launches, queued behind a spin kernel), plain {:.3f} ms, bound '
          '{:.4f} ms by {} (pairs read once, labels written once)'.format(
              shape, ms, plain_ms, bound_ms, bound_by), flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, shape=shape)


def _locus(readname):
    """Locus of a make_alac_case read name, ``read<locus>_<n>``."""
    return readname.split('_')[0]


def phase_partition(device, workdir, reads):
    """Phase 8: the partition stage at bigsim scale through K4.  Returns
    the launch count, the wall and the incidence (for phase 7's timing)."""
    import torch
    from kevlar_tpu_torch.ops import cc_cuda, cc_ops
    with open(reads, 'rb') as fh:
        data = fh.read()
    unlabelled = os.path.join(workdir, 'novel.augfastq')
    with open(unlabelled, 'wb') as fh:
        fh.write(re.sub(rb' kvcc=\d+\n', b'\n', data))
    del data

    seen = []
    components = cc_ops.connected_components_bipartite

    def recording(read_ids, kmer_ids, n_reads, n_kmers):
        out = components(read_ids, kmer_ids, n_reads, n_kmers)
        seen.append((read_ids, kmer_ids, n_reads, n_kmers, out))
        return out

    outpath = os.path.join(workdir, 'repartitioned.augfastq')
    cc_ops.connected_components_bipartite = recording
    cc_cuda.launches['cc_labels'] = 0
    try:
        wall = _run_cli(['partition', '--device', device, '-o', outpath,
                         unlabelled], os.path.join(workdir, 'partition.log'))
    finally:
        cc_ops.connected_components_bipartite = components
    launches = cc_cuda.launches['cc_labels']
    if launches <= 0 or len(seen) != 1:
        raise AssertionError('the partition run launched K4 {} times over '
                             '{} graphs'.format(launches, len(seen)))
    r, k, n_reads, n_kmers, labels = seen[0]
    if r.numel() < cc_ops.HOST_CC_THRESHOLD:
        raise AssertionError('{} pairs: below the threshold'.format(
            r.numel()))
    plain = cc_ops.connected_components_plain(r, k, n_reads, n_kmers)
    _max_diff(labels, plain, 'K4 on the partition run')

    members = {}
    with open(outpath) as fh:
        for line in fh:
            if line.startswith('@read'):
                name, label = line[1:].split()
                members.setdefault(label, set()).add(_locus(name))
    mixed = {lab: loci for lab, loci in members.items() if len(loci) != 1}
    if mixed:
        raise AssertionError('{} partitions mix loci, e.g. {}'.format(
            len(mixed), sorted(mixed.items())[:3]))
    loci = set().union(*members.values())
    print('[smoke] partition (bigsim reads, kvcc labels stripped): {:.1f} s '
          'wall; {:,} read-k-mer pairs over {:,} reads and {:,} k-mers; K4 '
          '{} launch, one pass; labels == plain; {:,} partitions, each '
          'one locus, covering {} of the loci'.format(
              wall, r.numel(), n_reads, n_kmers, launches,
              len(members), len(loci)), flush=True)
    torch.cuda.synchronize()
    return dict(launches=launches, wall=wall,
                incidence=(r, k, n_reads, n_kmers))


def _count_reads(path):
    import kevlar_tpu_torch
    with kevlar_tpu_torch.open(path, 'r') as fh:
        return sum(1 for line in fh if line.startswith('@'))


def _denovo_gate(final, denovo):
    """Phase 9's gate on the helium trio's final VCF ``final``: each de
    novo SNV of ``denovo`` (phase 6's list) is a PASS call at its
    position, and no PASS call lies more than 10 bp from a de novo locus;
    whether the insertion was called is printed.  Returns (calls, PASS
    calls), each (0-based position, REF, ALT, FILTER)."""
    import kevlar_tpu_torch
    calls = []
    with kevlar_tpu_torch.open(final, 'r') as fh:
        for line in fh:
            if not line.startswith('#'):
                f = line.split('\t')
                if f[1] != '.':
                    calls.append((int(f[1]) - 1, f[3], f[4], f[6]))
    passing = [c for c in calls if c[3] == 'PASS']
    for pos, kind, _ in denovo:
        if kind == 'SNV':
            hit = [c for c in passing if c[0] == pos and len(c[1]) ==
                   len(c[2]) == 1]
            print('[smoke] de novo SNV at {:,}: {}'.format(
                pos, 'PASS call {} > {}'.format(hit[0][1], hit[0][2])
                if hit else 'NOT CALLED'), flush=True)
            if not hit:
                raise AssertionError('de novo SNV at {} is not a PASS '
                                     'call'.format(pos))
        else:
            hit = [c for c in passing if abs(c[0] - pos) <= 10 and
                   len(c[2]) - len(c[1]) == HELIUM_INSERTION]
            print('[smoke] de novo {} at {:,}: {}'.format(
                kind, pos, 'called (PASS, {} bp longer at {:,})'.format(
                    HELIUM_INSERTION, hit[0][0]) if hit else 'not called'),
                flush=True)
    stray = [c for c in passing
             if all(abs(c[0] - pos) > 10 for pos, _, _ in denovo)]
    if stray:
        raise AssertionError('PASS calls away from every de novo locus: '
                             '{}'.format(stray[:5]))
    return calls, passing


def phase_workflow(device, workdir, refr, denovo, reads, memory='500M',
                   maskmemory='50M', profiled=False):
    """Phase 9: run_mark1 on the helium trio of phase 6 (sample sketches
    of ``memory``, mask and reference count of ``maskmemory``).  With
    ``profiled`` the run is traced by torch.profiler and the card's busy
    share of the wall is printed."""
    import contextlib
    import resource
    import torch
    import kevlar_tpu_torch
    from kevlar_tpu_torch import reference, workflow
    from kevlar_tpu_torch.ops import align_cuda, cc_cuda, kmer_cuda

    t0 = time.time()
    reference.autoindex(refr, 51)
    print('[smoke] seed index of the helium genome (seed 51) built in '
          '{:.1f} s (set-up)'.format(time.time() - t0), flush=True)
    outdir = os.path.join(workdir, 'workflow')
    config = {
        'ksize': KSIZE, 'outdir': outdir, 'device': device,
        'reference': {'fasta': refr},
        'case': {'fastx': [reads['proband']], 'label': 'Proband',
                 'memory': memory, 'max_fpr': 0.6},
        'controls': [
            {'fastx': [reads['mother']], 'label': 'Mother',
             'memory': memory, 'max_fpr': 0.2},
            {'fastx': [reads['father']], 'label': 'Father',
             'memory': memory, 'max_fpr': 0.2}],
        'mask': {'memory': maskmemory, 'max_fpr': 0.01},
        'novel': {'case_min': 5, 'ctrl_max': 1},
        'localize': {'seed_size': 51, 'delta': 50},
        'simlike': {'mu': HELIUM_COVERAGE, 'sigma': HELIUM_COVERAGE * 0.3,
                    'epsilon': 0.001},
    }
    for name in kmer_cuda.launches:
        kmer_cuda.launches[name] = 0
    cc_cuda.launches['cc_labels'] = 0
    align_cuda.launches = 0
    logpath = os.path.join(workdir, 'workflow.log')
    kevlar_tpu_torch.logstream = open(logpath, 'w')
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    tracer = contextlib.nullcontext()
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        tracer = profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
    t0 = time.time()
    try:
        with tracer as prof:
            final = workflow.run_mark1(config)
            torch.cuda.synchronize()
    finally:
        kevlar_tpu_torch.logstream.close()
        kevlar_tpu_torch.logstream = None
    wall = time.time() - t0
    if profiled:
        _print_busy('profiled workflow', prof, wall)
    launches = dict(kmer_cuda.launches, ksw_extz=align_cuda.launches,
                    cc_labels=cc_cuda.launches['cc_labels'])
    missing = [name for name in NOVEL_PATH_KERNELS + ('ksw_extz',)
               if launches[name] <= 0]
    if missing:
        raise AssertionError('the workflow launched no {} kernel'.format(
            missing))
    for artifact in ('mask.nt', 'refr.sct', 'case.ct', 'control0.ct',
                     'control1.ct', 'novel.augfastq.gz',
                     'filtered.augfastq.gz', 'partitioned.augfastq.gz',
                     'calls.prelim.vcf', 'callmask.nt',
                     'calls.scored.sorted.vcf.gz'):
        if not os.path.exists(os.path.join(outdir, artifact)):
            raise AssertionError('the workflow wrote no ' + artifact)

    calls, passing = _denovo_gate(final, denovo)
    counts = {name: _count_reads(os.path.join(outdir, name))
              for name in ('novel.augfastq.gz', 'filtered.augfastq.gz',
                           'partitioned.augfastq.gz')}
    # the process's peak so far; it covers the earlier phases too, so the
    # peak before the run says whether the workflow raised it
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print('[smoke] workflow: {:.1f} s wall; reads novel {:,}, filtered {:,}, '
          'partitioned {:,}; {} calls, {} PASS (none away from a de novo '
          'locus); peak RSS of the process {:.0f} MB after the run, {:.0f} '
          'MB before it; launches {}'.format(
              wall, counts['novel.augfastq.gz'],
              counts['filtered.augfastq.gz'],
              counts['partitioned.augfastq.gz'], len(calls), len(passing),
              rss, rss_before, launches), flush=True)
    print('[smoke] workflow stage walls: {}'.format('; '.join(
        '{} {:.2f} s'.format(stage, sec)
        for stage, sec in workflow.run_mark1.last_stage_times)), flush=True)
    return dict(launches=launches, wall=wall)


# ---------------------------------------------------- the sharded slice


SHARDS = 4           # the mesh's shards, every one on the card
SHARD_TOTAL = 124_999_999  # buckets of a 500M 8-bit sample table


def _mesh(device, n_data, n_shard):
    """A (n_data, n_shard) mesh whose every cell is ``device``."""
    from kevlar_tpu_torch.parallel import make_mesh
    return make_mesh(n_data, n_shard, devices=[device] * (n_data * n_shard))


def _sync(mesh):
    import torch
    for dev in {d for row in mesh.devices for d in row}:
        torch.cuda.synchronize(dev)


def _all_to_all_ms(mesh, capacity, reps=10):
    """One ``all_to_all`` of a count batch's bins (4 tables, a [4, S, C]
    int32 send buffer on every device) in both forms, the mesh's devices
    synchronised around each call, by the host clock: the parts the
    routed consume takes (the bins and their [4, S] populations, unstacked)
    and the stacked copy.  Returns {form: (ms of each call, bytes moved)};
    a received part that is a view of its sender's buffer moved none."""
    import torch
    from kevlar_tpu_torch.parallel import collectives
    n_shard = mesh.shape['shard']
    send = [[torch.randint(0, 1 << 20, (4, n_shard, capacity),
                           dtype=torch.int32, device=dev) for dev in row]
            for row in mesh.devices]
    pops = [[torch.full((4, n_shard), capacity, dtype=torch.int32,
                        device=dev) for dev in row] for row in mesh.devices]
    sources = {x.untyped_storage().data_ptr() for grid in (send, pops)
               for row in grid for x in row}

    def parts():
        return collectives.all_to_all_parts(mesh, send, pops)

    def stacked():
        return (collectives.all_to_all(mesh, send),)

    out = {}
    for name, fn in (('parts', parts), ('stacked', stacked)):
        got = fn()
        moved = sum(x.numel() * x.element_size() for grid in got
                    for row in grid for cell in row
                    for x in (cell if isinstance(cell, list) else [cell])
                    if x.untyped_storage().data_ptr() not in sources)
        del got
        times = []
        for _ in range(reps):
            _sync(mesh)
            t0 = time.time()
            fn()
            _sync(mesh)
            times.append(1e3 * (time.time() - t0))
        out[name] = (times, moved)
    return out


def _shard_equal(sharded, tables, label):
    """Raise unless ``sharded``'s shards on this rank are ``tables`` ([T,
    tablesize] 8-bit counters on its device) cut at its shard size."""
    import torch
    ss = sharded.shard_size
    for d, s in sharded.mesh.local_cells():
        held = min(ss, sharded.tablesize - s * ss)
        got = sharded.tables[d][s]
        want = tables[:, s * ss:s * ss + held].to(got.device)
        if not (torch.equal(got[:, :held], want) and
                not got[:, held:].any()):
            raise AssertionError('{}: shard ({}, {}) differs'.format(
                label, d, s))


def _route_bound(n, ntables, nshards, filled):
    """kt_route: h1, h2 and valid read once, the ``filled`` slots of the
    send buffer and the populations written once; ~20 integer operations
    a table and k-mer."""
    return _bound(n * 9 + (filled + ntables * nshards) * 4,
                  n * ntables * 20)


def _route_err(got, want, capacity, label):
    """Max abs difference of ``kt_route``'s (send, pop) and
    ``route_plain``'s: the populations, and every bin's filled prefix slot
    by slot, unsorted (raises unless equal)."""
    import torch
    err = _max_diff(got[1], want[1], label + ' populations')
    filled = want[1].clamp(max=capacity).to(torch.int64)
    slots = torch.arange(capacity, device=filled.device)
    inside = slots[None, None, :] < filled[:, :, None]
    return max(err, _max_diff(got[0][inside], want[0][inside],
                              label + ' filled slots'))


def _capacity(nrows, L, n_dev):
    """The routed consume's capacity for a [nrows, L] batch on ``n_dev``
    shards of one data row."""
    from kevlar_tpu_torch.parallel.sharded import routing_capacity
    return routing_capacity(1, n_dev, KSIZE, (nrows, L))


def _routed_scatter_add_check(device, rng, ss):
    """K3 at the routed count's shape: what the owner of shard 0 receives
    on a (1, 4) mesh, the four devices' 8,192-row shares of a batch routed
    by kt_route and handed over by one ``all_to_all_parts`` (four [4,
    capacity] views of the senders' buffers and their populations), added
    into its 4 x ``ss`` int32 accumulator; against its plain version,
    then timed."""
    import torch
    from kevlar_tpu_torch.ops import kmer_cuda, sketch_ops
    from kevlar_tpu_torch.parallel import collectives
    cap = _capacity(32768, 160, SHARDS)
    routed = []
    for _ in range(SHARDS):
        codes = torch.from_numpy(_read_bases(rng, 32768 // SHARDS, 160,
                                             150)).to(device)
        h1, h2, valid = (x.reshape(-1) for x in
                         kmer_cuda.kmer_hashes_cuda(codes, KSIZE))
        routed.append(kmer_cuda.route_cuda(h1, h2, valid, 4, SHARDS, ss,
                                           SHARD_TOTAL, cap))
    del codes, h1, h2, valid
    mesh = _mesh(device, 1, SHARDS)
    parts, pops = collectives.all_to_all_parts(
        mesh, [[r[0] for r in routed]], [[r[1] for r in routed]])
    parts, pops = parts[0][0], pops[0][0]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    acc = torch.randint(0, 100, (4, ss), dtype=torch.int32, device=device,
                        generator=gen)
    got = kmer_cuda.scatter_add_parts_cuda(acc.clone(), parts, pops)
    want = sketch_ops.scatter_add_parts_plain(acc.clone(), parts, pops)
    err = _max_diff(got, want, 'K3 on the received parts')
    del got, want
    filled = [pop.clamp(max=cap).tolist() for pop in pops]
    nkept = sum(map(sum, filled))
    _, ms = _timed(kmer_cuda.scatter_add_parts_cuda, acc, parts, pops,
                   reps=20, spin=True)
    _, plain_ms = _timed(sketch_ops.scatter_add_parts_plain, acc, parts,
                         pops, reps=5)
    # one library call for the same function: index_add_ on the flat
    # accumulator, the filled prefixes' flat indices prepared outside the
    # timing
    flat = torch.cat([part[t, :n[t]].long() + t * ss
                      for part, n in zip(parts, filled) for t in range(4)])
    ones = torch.ones_like(flat, dtype=torch.int32)
    _, library_ms = _timed(acc.view(-1).index_add_, 0, flat, ones, reps=5,
                           spin=True)
    del flat, ones, acc, routed
    # the filled prefixes and the populations read once; a kept update
    # reads and writes its sector
    bound_ms, bound_by = _bound(nkept * 4 + 4 * SHARDS * 4 +
                                nkept * 2 * SECTOR, nkept)
    shape = ('{:,} received indices in 4 x {} parts of capacity {:,} '
             '(filled prefixes only; the unfilled {:.1%} is not read), 4 x '
             '{:,} int32'.format(nkept, SHARDS, cap,
                                 1 - nkept / (4 * SHARDS * cap), ss))
    print('[smoke] K3 scatter_add on the routed count\'s received parts: '
          'identical to plain; {}: kernel {:.4f} ms ({:.1f} G updates/s), '
          'plain {:.3f} ms, one index_add_ {:.4f} ms, bound {:.4f} ms by {}'
          .format(shape, ms, nkept / ms / 1e6, plain_ms, library_ms,
                  bound_ms, bound_by), flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, shape=shape)


def sharded_kernel_checks(device):
    """kt_route and the range variants of K2 and K3 against their plain
    versions on the card, at the shapes the sharded phase gives them, then
    timed.  Returns {kernel: dict(err, ms, plain_ms, bound_ms, bound_by,
    library_ms, shape)}."""
    import torch
    from kevlar_tpu_torch.ops import kmer_cuda, sketch_ops
    rng = np.random.default_rng(SEED + 8)
    out = {}
    ss = SHARD_TOTAL // SHARDS + 1

    # kt_route: one device's share of a count batch (8,192 of 32,768 reads
    # on a (1, 4) mesh, the main path's launch), a whole batch on one
    # device, one device's share on a (1, 8) mesh, and the whole batch at a
    # small capacity (overflowing bins keep their first k-mers); every
    # bin's filled prefix slot by slot against route_plain, unsorted
    err = 0
    times = {}
    for nrows, nshards in ((32768 // SHARDS, SHARDS), (32768, SHARDS),
                           (32768 // 8, 8)):
        codes = torch.from_numpy(_read_bases(rng, nrows, 160, 150)).to(
            device)
        h1, h2, valid = (x.reshape(-1) for x in
                         kmer_cuda.kmer_hashes_cuda(codes, KSIZE))
        size = -(-SHARD_TOTAL // nshards)
        cap = _capacity(nrows * nshards, 160, nshards)
        args = (h1, h2, valid, 4, nshards, size, SHARD_TOTAL, cap)
        got = kmer_cuda.route_cuda(*args)
        want = sketch_ops.route_plain(*args)
        err = max(err, _route_err(got, want, cap, 'kt_route {:,} k-mers to '
                                  '{} shards'.format(h1.numel(), nshards)))
        if nshards != SHARDS:
            continue
        _, ms = _timed(kmer_cuda.route_cuda, *args, reps=20, spin=True)
        _, plain_ms = _timed(sketch_ops.route_plain, *args, reps=3)
        filled = int(want[1].clamp(max=cap).sum())
        fill_bytes = 4 * SHARDS * (cap + 1) * 4
        times[nrows] = (h1.numel(), cap, ms, plain_ms, filled) + \
            _route_bound(h1.numel(), 4, SHARDS, filled) + \
            _bound(h1.numel() * 9 + fill_bytes, 0)[:1]
        fill = int(got[1].max()) / cap
    small = 4096
    want = sketch_ops.route_plain(h1, h2, valid, 4, 8, size, SHARD_TOTAL,
                                  small)
    if int(want[1].max()) <= small:
        raise AssertionError('kt_route: the small capacity did not overflow')
    err = max(err, _route_err(
        kmer_cuda.route_cuda(h1, h2, valid, 4, 8, size, SHARD_TOTAL, small),
        want, small, 'kt_route overflowing'))
    n, cap, ms, plain_ms, filled, bound_ms, bound_by, _ = \
        times[32768 // SHARDS]
    out['route'] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None,
                        shape='{:,} hashed k-mers x 4 tables to {} shards of '
                        '{:,} buckets, capacity {:,}'.format(n, SHARDS, ss,
                                                            cap))
    print('[smoke] kt_route: identical to plain, slot by slot (populations '
          'and every bin\'s filled prefix, unsorted: 4 and 8 shards, and '
          'overflowing bins at capacity {:,}); {}'.format(small, '; '.join(
              '{:,} k-mers (capacity {:,}): kernel {:.4f} ms ({:.1f} GB/s of '
              '{:,} bytes), plain {:.3f} ms, bound {:.4f} ms by {} ({:.4f} '
              'ms with a sentinel fill of the whole send buffer)'.format(
                  t[0], t[1], t[2],
                  (9 * t[0] + 4 * (t[4] + 4 * SHARDS)) / t[2] / 1e6,
                  9 * t[0] + 4 * (t[4] + 4 * SHARDS), t[3], t[5], t[6],
                  t[7]) for t in times.values())), flush=True)
    print('[smoke] kt_route: the fullest bin of the whole batch holds {:.3f} '
          'of its capacity (1.25x the expected population)'.format(fill),
          flush=True)
    del h1, h2, valid, codes, got, want
    out['K3 routed'] = _routed_scatter_add_check(device, rng, ss)

    # K2 with a range: the screen's launch on one shard of a (1, 4) mesh,
    # three samples (4,096 reads x 130 windows), each a shard of a 500M
    # table; and 1/4/8 bits at an odd span
    err = 0
    h1, h2 = _random_hashes(rng, DEFAULT_SCREEN_READS * 130, device)
    for bits, span in ((1, 1_000_008), (4, 999_992), (8, 1_000_000)):
        samples = [(_random_sketch(rng, bits, span, device)[0], bits,
                    3_999_999, s * span, span) for s in range(3)]
        got = kmer_cuda.gather_counts_cuda(samples, h1, h2)
        want = sketch_ops.gather_counts_multi_plain(samples, h1, h2)
        err = max(err, _max_diff(got, want, 'K2 range {} bits'.format(bits)))
    samples = [(_random_sketch(rng, 8, ss, device)[0], 8, SHARD_TOTAL, ss,
                ss) for _ in range(3)]
    got, ms = _timed(kmer_cuda.gather_counts_cuda, samples, h1, h2, reps=20,
                     spin=True)
    want, plain_ms = _timed(sketch_ops.gather_counts_multi_plain, samples,
                            h1, h2, reps=5)
    err = max(err, _max_diff(got, want, 'K2 range, screen shape'))
    # the probes this data sends into the shard's range read a sector each
    a, b = (x.to(torch.int64) & 0xFFFFFFFF for x in (h1, h2))
    owned = sum(int((((a + t * b) & 0xFFFFFFFF) % SHARD_TOTAL // ss == 1)
                    .sum()) for t in range(4))
    nbytes = h1.numel() * (8 + 3) + 3 * min(owned * SECTOR, 4 * ss)
    bound_ms, bound_by = _bound(nbytes, 3 * 4 * h1.numel() *
                                K2_OPS_PER_PROBE)
    out['K2 range'] = dict(err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None,
                           shape='{:,} k-mers, 3 sketches, shard 1 of 4 '
                           '(4 x {:,} of {:,} buckets)'.format(
                               h1.numel(), ss, SHARD_TOTAL))
    print('[smoke] K2 gather_counts with a bucket range: identical to plain '
          '(1/4/8 bits; 255 outside the range); {}: kernel {:.4f} ms, plain '
          '{:.3f} ms, bound {:.4f} ms by {} ({:,} of {:,} probes in the '
          'range)'.format(out['K2 range']['shape'], ms, plain_ms, bound_ms,
                          bound_by, owned, 4 * h1.numel()), flush=True)
    del samples, got, want, a, b, h1, h2

    # K3 consume with a range: the masked count's launch on shard 1 of a
    # (2, 2) mesh (16,384 reads x 130 windows, 15% kept by the mask) into
    # its 4 x 62,500,000 int32 accumulator (at helium's 500M); and odd
    # ranges of a small table
    err = 0
    h1, h2 = _random_hashes(rng, 100_003, device)
    valid = torch.from_numpy((rng.random(100_003) < 0.9).astype(
        np.uint8)).to(device)
    mcnt = torch.from_numpy(rng.integers(0, 3, 100_003).astype(np.uint8)).to(
        device)
    for lo, span, kw in ((0, 1001, {}), (1000, 1001, {}),
                         (2000, 5000, dict(mcnt=mcnt, mask_threshold=1)),
                         (3, 2998, dict(mcnt=mcnt, mask_threshold=1,
                                        consume_masked=True))):
        acc = torch.from_numpy(rng.integers(0, 9, (4, span)).astype(
            np.int32)).to(device)
        got = kmer_cuda.consume_cuda(acc.clone(), h1, h2, valid, total=3001,
                                     lo=lo, **kw)
        want = sketch_ops.consume_hashes_plain(acc.clone(), h1, h2, valid,
                                               total=3001, lo=lo, **kw)
        err = max(err, _max_diff(got, want, 'K3 consume range [{}, +{})'
                                 .format(lo, span)))
    half = SHARD_TOTAL // 2 + 1
    n = 16384 * 130
    h1, h2 = _random_hashes(rng, n, device)
    valid = torch.from_numpy((rng.random(n) < 0.995).astype(np.uint8)).to(
        device)
    mcnt = torch.from_numpy((rng.random(n) >= 0.15).astype(np.uint8)).to(
        device)
    kw = dict(mcnt=mcnt, mask_threshold=0, total=SHARD_TOTAL, lo=half)
    acc = torch.zeros((4, half), dtype=torch.int32, device=device)
    got = kmer_cuda.consume_cuda(acc.clone(), h1, h2, valid, **kw)
    want = sketch_ops.consume_hashes_plain(acc.clone(), h1, h2, valid, **kw)
    err = max(err, _max_diff(got, want, 'K3 consume range, 1 GB shard'))
    added = int(got.sum())
    del got, want
    _, ms = _timed(kmer_cuda.consume_cuda, acc, h1, h2, valid, reps=20,
                   spin=True, **kw)
    _, plain_ms = _timed(sketch_ops.consume_hashes_plain, acc, h1, h2, valid,
                         reps=3, **kw)
    kept = int(((valid != 0) & (mcnt <= 0)).sum())
    bound_ms, bound_by = _bound(n * 10 + added * 2 * SECTOR,
                                n * 6 + kept * 4 * K2_OPS_PER_PROBE)
    out['K3 consume range'] = dict(
        err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
        shape='{:,} hashed k-mers (15% kept), shard 1 of 2 (4 x {:,} int32 '
        'of {:,} buckets)'.format(n, half, SHARD_TOTAL))
    print('[smoke] K3 consume with a bucket range: identical to plain (odd '
          'ranges, masks); {}: kernel {:.4f} ms ({:,} of {:,} kept updates '
          'in the range), plain {:.3f} ms, bound {:.4f} ms by {}'.format(
              out['K3 consume range']['shape'], ms, added, 4 * kept,
              plain_ms, bound_ms, bound_by), flush=True)
    return out


def phase_sharded_seeds(device, refr, seeds, reps=3):
    """The sharded seed search: phase 4's bigsim keys cut over a (1, 4)
    mesh on the card, the alac run's seed set through
    ``seed_ranges_sharded``; the same ranges as the device backend's
    search.  Returns its launches (seed_ranges calls) and ms."""
    import torch
    from kevlar_tpu_torch import dna, reference
    from kevlar_tpu_torch.ops import seed_ops
    index = reference.SeedIndex.from_file(reference.index_path(refr, 51), {},
                                          backend='device', device=device)
    qbases, _ = dna.encode_batch(sorted(seeds))
    qcodes, _ = dna.seed_codes(qbases, 51)
    queries = torch.from_numpy(seed_ops.ordered_int64(
        reference._fold_codes(qcodes[:, 0, :]))).to(device)
    start, count = seed_ops.seed_ranges(index.device_keys(), queries)
    start, count = start.cpu().numpy(), count.cpu().numpy()
    t0 = time.time()
    runs, n_valid, base = seed_ops.shard_keys(index._keys, SHARDS)
    mesh = _mesh(device, 1, SHARDS)
    shards = [torch.from_numpy(runs[s]).to(device) for s in range(SHARDS)]
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    del runs
    seed_ops.launches = 0
    (got, got_count), times = _host_times(
        lambda: seed_ops.seed_ranges_sharded(mesh, shards, queries, n_valid,
                                             base), reps)
    launches = seed_ops.launches
    hit = count > 0
    if not (np.array_equal(got_count, count) and
            np.array_equal(got[hit], start[hit]) and
            (got[~hit] == np.iinfo(np.int64).max).all()):
        raise AssertionError('sharded seed ranges differ from the device '
                             'search')
    print('[smoke] sharded seeds: {:,} queries against {:,} keys cut over '
          '{} shards on the card ({:.1f} s to cut and copy); '
          'seed_ranges_sharded {} by the host clock (four searches, the '
          'reductions over the shards, the host\'s global starts), {} '
          'seed_ranges launches in {} calls; ranges == the device search\'s '
          '({:,} hits)'.format(len(queries), len(index._keys), SHARDS,
                               setup_s, _spread(times), launches, reps,
                               int(hit.sum())), flush=True)
    return dict(launches=launches, ms=float(np.median(times)))


def phase_sharded_align(device, rows):
    """Data-parallel B1: every pair of the alac run (``rows``: its
    recorded align_batch calls) through ``align_both_strands_batch`` on a
    (2, 1) mesh that names the card twice; the same (score, CIGAR,
    strand) as unsharded.  Returns B1's launches."""
    from kevlar_tpu_torch.ops import align_cuda
    from kevlar_tpu_torch.ops.align import align_both_strands_batch
    pairs = [pair for targets, queries, _, _ in rows
             for pair in zip(targets[::2], queries[::2])]
    want = align_both_strands_batch(pairs, device=device)
    align_cuda.launches = 0
    t0 = time.time()
    got = align_both_strands_batch(pairs, mesh=_mesh(device, 2, 1))
    wall = time.time() - t0
    launches = align_cuda.launches
    if got != want:
        bad = sum(1 for g, w in zip(got, want) if g != w)
        raise AssertionError('mesh-sharded B1: {} of {} pairs differ'.format(
            bad, len(pairs)))
    if launches < 2:
        raise AssertionError('mesh-sharded B1 launched {} times'.format(
            launches))
    print('[smoke] data-parallel B1: {:,} pairs ({:,} rows) over a (2, 1) '
          'mesh on the card in {:.2f} s, {} ksw_extz launches; (score, '
          'CIGAR, strand) == unsharded'.format(len(pairs), 2 * len(pairs),
                                              wall, launches), flush=True)
    return launches


# the kernels the sharded phase's main path must launch
SHARDED_PATH_KERNELS = ('kmer_hashes', 'route', 'scatter_add_parts',
                        'gather_counts_range', 'consume_range')


def phase_sharded(device, workdir, reads, memory='500M'):
    """The sharded slice on the card, every mesh over this one card: the
    proband counted on a (1, 4) mesh (routed), the case's masked count on
    a (2, 2) mesh (replicate), the novel screen over the workflow's three
    tables re-sharded on (1, 4), a forced overflow, ``count`` and ``novel
    --shards 1`` through the CLI, and one batch's ``all_to_all`` timed.
    Tables and text must equal the unsharded runs'.  Returns the launches
    and walls."""
    import gzip
    import torch
    import kevlar_tpu_torch
    from kevlar_tpu_torch import count, novel, sketch
    from kevlar_tpu_torch.batch import DEFAULT_BATCH_SIZE, native_base_batches
    from kevlar_tpu_torch.cli import memory_setting
    from kevlar_tpu_torch.ops import kmer_cuda
    from kevlar_tpu_torch.parallel import ShardedSketch
    t_phase = time.time()
    mem = memory_setting(memory)
    wf = os.path.join(workdir, 'workflow')
    kevlar_tpu_torch.logstream = open(os.path.join(workdir, 'sharded.log'),
                                      'w')
    walls, batches = {}, {}
    try:
        # the unsharded, unmasked proband count it must equal (not the
        # main path: counts are zeroed after it)
        t0 = time.time()
        single = count.load_sample_seqfile([reads['proband']], KSIZE, mem,
                                           maxfpr=0.6, device=device)
        tablesize = single.tablesize
        torch.cuda.synchronize()
        walls['count proband, one device'] = time.time() - t0

        for name in kmer_cuda.launches:
            kmer_cuda.launches[name] = 0
        # 1. routed: (1, 4)
        mesh14 = _mesh(device, 1, SHARDS)
        t0 = time.time()
        routed = count.load_sample_seqfile([reads['proband']], KSIZE, mem,
                                           maxfpr=0.6, mesh=mesh14)
        torch.cuda.synchronize()
        walls['count proband, (1, 4) routed'] = time.time() - t0
        batches['routed count'] = dict(routed.batches)
        _shard_equal(routed, single.tables, 'routed proband count')
        # the distributed phase holds its ranks' shards to these tables
        routed.save(os.path.join(workdir, 'routed14.ct'))
        del routed, single
        # 2. masked, replicate: (2, 2) with the workflow's 1-bit mask
        mesh22 = _mesh(device, 2, 2)
        mask = ShardedSketch.from_sketch(mesh22, sketch.load(
            os.path.join(wf, 'mask.nt'), device=device, cache=False))
        t0 = time.time()
        masked = count.load_sample_seqfile([reads['proband']], KSIZE, mem,
                                           maxfpr=0.6, mask=mask,
                                           mesh=mesh22)
        torch.cuda.synchronize()
        walls['count case, (2, 2) masked'] = time.time() - t0
        batches['masked count'] = dict(masked.batches)
        case = sketch.load(os.path.join(wf, 'case.ct'), device=device,
                           cache=False)
        _shard_equal(masked, case.tables, 'masked case count vs case.ct')
        del masked, mask
        # 3. the screen over the workflow's tables, re-sharded on (1, 4)
        samples = [ShardedSketch.from_sketch(mesh14, sk) for sk in [case] + [
            sketch.load(os.path.join(wf, 'control{}.ct'.format(i)),
                        device=device, cache=False) for i in (0, 1)]]
        del case
        t0 = time.time()
        text = ''.join(novel.novel(
            None, samples[:1], samples[1:], ksize=KSIZE, casemin=5,
            ctrlmax=1, batchstream=novel.native_read_batches(
                [reads['proband']], DEFAULT_BATCH_SIZE), emit='text'))
        torch.cuda.synchronize()
        walls['novel, (1, 4)'] = time.time() - t0
        del samples
        with gzip.open(os.path.join(wf, 'novel.augfastq.gz'), 'rt') as fh:
            if fh.read() != text:
                raise AssertionError('the sharded screen\'s text differs '
                                     'from the workflow\'s novel output')
    finally:
        kevlar_tpu_torch.logstream.close()
        kevlar_tpu_torch.logstream = None
    # 7. the CLI, one shard (all a one-card host allows, as in JAX)
    ct = os.path.join(workdir, 'shards1_proband.ct')
    walls['CLI count --shards 1'] = _run_cli(
        ['count', '--shards', '1', '-k', str(KSIZE), '--device', device,
         '-M', memory, '--max-fpr', '0.6', '--mask',
         os.path.join(workdir, 'mask.nt'), ct, reads['proband']],
        os.path.join(workdir, 'shards1_count.log'))
    out = os.path.join(workdir, 'shards1_novel.augfastq')
    walls['CLI novel --shards 1'] = _run_cli(
        ['novel', '--shards', '1', '-k', str(KSIZE), '--device', device,
         '--case', reads['proband'], '--case-counts', ct,
         '--control-counts', os.path.join(workdir, 'mother.ct'),
         os.path.join(workdir, 'father.ct'), '--case-min', '5',
         '--ctrl-max', '1', '-o', out],
        os.path.join(workdir, 'shards1_novel.log'))
    launches = dict(kmer_cuda.launches)
    missing = [k for k in SHARDED_PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError('the sharded run launched no {} kernel'.format(
            missing))
    with np.load(ct) as got, np.load(os.path.join(workdir,
                                                  'proband.ct')) as want:
        if not np.array_equal(got['tables'], want['tables']):
            raise AssertionError('count --shards 1 differs from the '
                                 'unsharded count')
    with open(out) as fh, open(os.path.join(workdir,
                                            'novel.augfastq')) as gh:
        if fh.read() != gh.read():
            raise AssertionError('novel --shards 1 differs from the '
                                 'unsharded screen')

    # 4. a forced overflow (not the main path): a tiny capacity re-runs
    # the batch down the replicate path, with the same tables
    bases, _ = next(native_base_batches(reads['proband'], 32768,
                                        overlap=KSIZE - 1))
    forced = ShardedSketch(mesh14, KSIZE, tablesize, exact=True)
    forced.consume_batch(bases, a2a_capacity=1024)
    plain = ShardedSketch(mesh14, KSIZE, tablesize, exact=True)
    plain.consume_batch(bases)
    if forced.batches != {'routed': 0, 'replicated': 1, 'overflowed': 1} or \
            plain.batches['routed'] != 1:
        raise AssertionError('overflow: {} / {}'.format(forced.batches,
                                                        plain.batches))
    for s in range(SHARDS):
        if not torch.equal(forced.tables[0][s], plain.tables[0][s]):
            raise AssertionError('overflow: shard {} differs'.format(s))
    del forced, plain
    cap = _capacity(32768, 160, SHARDS)
    a2a = _all_to_all_ms(mesh14, cap)
    print('[smoke] sharded: all_to_all of one count batch\'s bins (4 x {} x '
          '{:,} int32 a device, {:.1f} MB in all) over {}: parts (the '
          'routed consume\'s, with the populations) {}, {:,} bytes moved; '
          'stacked {}, {:,} bytes moved'.format(
              SHARDS, cap, 16 * SHARDS * cap * 4 / 1e6,
              ', '.join(str(d) for d in mesh14.devices[0]),
              _spread(a2a['parts'][0]), a2a['parts'][1],
              _spread(a2a['stacked'][0]), a2a['stacked'][1]), flush=True)
    print('[smoke] sharded: {}; batches {}; the forced overflow (capacity '
          '1,024) re-ran down the replicate path, tables equal; the routed '
          'and masked counts == the unsharded and workflow tables, the '
          'screen == the workflow\'s novel text, count/novel --shards 1 == '
          'phase 6\'s; launches {}; phase wall {:.1f} s'.format(
              ', '.join('{} {:.2f} s'.format(k, v) for k, v in walls.items()),
              batches, {k: launches[k] for k in launches},
              time.time() - t_phase), flush=True)
    return dict(launches=launches, walls=walls, batches=batches)


# ------------------------------------------------ the distributed slice


RANK_TIMEOUT = {'gloo': 420, 'nccl': 240}   # seconds for a phase's ranks
SCREEN_SLICE_READS = 500_000
DISTRIBUTED_PATH_KERNELS = {
    'routed count (1, 4)': ('kmer_hashes', 'route', 'scatter_add_parts'),
    'masked count (2, 2)': ('kmer_hashes', 'gather_counts_range',
                            'consume_range')}


def _free_port():
    """A TCP port on localhost that was free a moment ago."""
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _count_traffic():
    """Wrap this process's ``torch.distributed`` collectives and the
    port's ``all_to_all_parts``; returns a dict that adds up the bytes
    this rank handed to groups of two ranks or more (``bytes``), the calls
    (``calls``), and the exchanges of the routed consume with their host
    seconds, staging and unpacking included (synchronous under gloo)."""
    import torch.distributed as dist
    from kevlar_tpu_torch.parallel import collectives
    traffic = {'bytes': 0, 'calls': 0, 'exchanges': 0, 'exchange_s': 0.0}

    def wrap(name, sent):
        fn = getattr(dist, name)

        def wrapped(*args, **kwargs):
            if dist.get_world_size(kwargs.get('group')) > 1:
                x = sent(args, kwargs)
                traffic['bytes'] += 0 if x is None else \
                    x.numel() * x.element_size()
            traffic['calls'] += 1
            return fn(*args, **kwargs)
        setattr(dist, name, wrapped)
    wrap('all_to_all_single', lambda args, kw: args[1])
    wrap('all_reduce', lambda args, kw: args[0])
    wrap('broadcast', lambda args, kw: args[0] if kw['src'] ==
         dist.get_rank() else None)
    exchange = collectives.all_to_all_parts

    def timed(*args, **kwargs):
        t0 = time.time()
        out = exchange(*args, **kwargs)
        traffic['exchange_s'] += time.time() - t0
        traffic['exchanges'] += 1
        return out
    collectives.all_to_all_parts = timed
    return traffic


def rank_main(argv):
    """One rank of the distributed phase: ``chip_smoke.py --rank RANK
    WORLD PORT BACKEND SPEC``.  Joins the group, builds the (1, 4) and (2,
    2) meshes whose cells the ranks share in rank order (every cell on the
    spec's ``device``), counts the proband routed on (1, 4) and holds its shards
    to the one-process count's file; with ``masked`` in the spec's parts,
    the masked count on (2, 2) (shards == the workflow's ``case.ct``) and
    the screen and a query over the head of the reads on (2, 2), equal to
    the same on a one-process (2, 2) mesh.  Writes walls, batches,
    launches and traffic to the spec's ``out``; any mismatch raises."""
    import datetime
    import torch
    from kevlar_tpu_torch import count, novel, sketch
    from kevlar_tpu_torch.batch import DEFAULT_BATCH_SIZE, native_base_batches
    from kevlar_tpu_torch.cli import memory_setting
    from kevlar_tpu_torch.ops import kmer_cuda
    from kevlar_tpu_torch.parallel import (ShardedSketch, init_distributed,
                                           make_mesh)
    rank, world, port, backend = (int(argv[0]), int(argv[1]), int(argv[2]),
                                  argv[3])
    with open(argv[4]) as fh:
        spec = json.load(fh)
    device = torch.device(spec['device'])
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    devices = init_distributed('localhost:{}'.format(port), world, rank,
                               backend=backend,
                               timeout=datetime.timedelta(seconds=120))
    traffic = _count_traffic()
    cells = [(r, device) for r in range(world) for _ in range(4 // world)]
    mesh14 = make_mesh(1, 4, devices=cells)
    mesh22 = make_mesh(2, 2, devices=cells)
    mem = memory_setting(spec['memory'])
    out = dict(rank=rank, backend=backend, cells=mesh14.local_cells(),
               devices=[[r, str(d)] for r, d in devices], walls={},
               launches={}, traffic={}, batches={})

    def run(name, fn):
        for key in kmer_cuda.launches:
            kmer_cuda.launches[key] = 0
        before = dict(traffic)
        torch.cuda.synchronize()
        t0 = time.time()
        result = fn()
        torch.cuda.synchronize()
        out['walls'][name] = time.time() - t0
        out['launches'][name] = dict(kmer_cuda.launches)
        out['traffic'][name] = {k: traffic[k] - before[k] for k in traffic}
        missing = [k for k in DISTRIBUTED_PATH_KERNELS.get(name, ())
                   if out['launches'][name][k] <= 0]
        if missing:
            raise AssertionError('rank {}: the {} launched no {}'.format(
                rank, name, missing))
        return result

    def load(path):
        return sketch.load(path, device=device, cache=False)

    # a small count first: the walls below are the counts' own
    count.load_sample_seqfile([spec['small']], KSIZE, memory_setting('8M'),
                              maxfpr=1.0, mesh=mesh14)
    routed = run('routed count (1, 4)', lambda: count.load_sample_seqfile(
        [spec['proband']], KSIZE, mem, maxfpr=0.6, mesh=mesh14))
    out['batches']['routed count (1, 4)'] = dict(routed.batches)
    _shard_equal(routed, load(spec['routed']).tables,
                 'rank {} routed count'.format(rank))
    del routed
    if 'masked' in spec['parts']:
        mask = ShardedSketch.from_sketch(mesh22, load(spec['mask']))
        masked = run('masked count (2, 2)', lambda: count.load_sample_seqfile(
            [spec['proband']], KSIZE, mem, maxfpr=0.6, mask=mask,
            mesh=mesh22))
        out['batches']['masked count (2, 2)'] = dict(masked.batches)
        _shard_equal(masked, load(spec['case']).tables,
                     'rank {} masked count vs case.ct'.format(rank))
        del masked, mask
        tables = [load(path) for path in spec['samples']]
        bases, _ = next(native_base_batches(spec['head'],
                                            DEFAULT_SCREEN_READS,
                                            overlap=KSIZE - 1))
        texts, queries = {}, {}
        for label, mesh in (('ranks', mesh22), ('one process', make_mesh(
                2, 2, devices=[device] * 4))):
            samples = [ShardedSketch.from_sketch(mesh, t) for t in tables]
            texts[label] = run('screen, {}'.format(label), lambda: ''.join(
                novel.novel(None, samples[:1], samples[1:], ksize=KSIZE,
                            casemin=5, ctrlmax=1,
                            batchstream=novel.native_read_batches(
                                [spec['head']], DEFAULT_BATCH_SIZE),
                            emit='text')))
            queries[label] = [x.cpu() for x in samples[0].query_batch(bases)]
            del samples
        if texts['ranks'] != texts['one process']:
            raise AssertionError('rank {}: the screen over the ranks\' (2, '
                                 '2) mesh differs from one process\'s'.format(
                                     rank))
        if not all(torch.equal(a, b) for a, b in zip(queries['ranks'],
                                                     queries['one process'])):
            raise AssertionError('rank {}: query_batch over the ranks\' (2, '
                                 '2) mesh differs'.format(rank))
        out['screen_lines'] = texts['ranks'].count('\n')
        out['query_nonzero'] = int(torch.count_nonzero(
            queries['ranks'][0]))
    with open(spec['out'].format(backend, rank), 'w') as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()
    return 0


def _wait_ranks(procs, logs, timeout):
    """Wait for every rank; raise, after stopping the others, if one
    fails or the phase outlasts ``timeout`` seconds."""
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [i for i, p in enumerate(procs) if p.poll()]
            if failed or time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode]
    if bad:
        tails = []
        for i in bad:
            with open(logs[i]) as fh:
                tails.append('rank {} (exit {}):\n{}'.format(
                    i, procs[i].returncode, fh.read()[-3000:]))
        raise AssertionError('the distributed phase failed or timed out:\n'
                             + '\n'.join(tails))


def phase_distributed(workdir, reads, one_process_wall, memory='500M',
                      device='cuda:0'):
    """Phase 12: the sharded sketch over ranks on this one card.  Two rank
    processes over gloo (every crossing through pinned host memory), then
    one NCCL rank (``world_size`` 1: the process-group path, NCCL's
    collectives on the card); see :func:`rank_main`.  Prints the two-rank
    count wall against the one-process (1, 4) count of phase 11 in this
    call, the bytes that crossed ranks a batch and in all, and the
    exchange's time a batch.  Returns the ranks' records."""
    import torch
    t_phase = time.time()
    torch.cuda.empty_cache()
    wf = os.path.join(workdir, 'workflow')
    spec = dict(
        memory=memory, device=device, proband=reads['proband'],
        small=_head_fastq(reads['proband'],
                          os.path.join(workdir, 'ranks_small.fq'), 10_000),
        head=_head_fastq(reads['proband'],
                         os.path.join(workdir, 'ranks_head.fq'),
                         SCREEN_SLICE_READS),
        routed=os.path.join(workdir, 'routed14.ct'),
        mask=os.path.join(wf, 'mask.nt'), case=os.path.join(wf, 'case.ct'),
        samples=[os.path.join(wf, name) for name in
                 ('case.ct', 'control0.ct', 'control1.ct')],
        out=os.path.join(workdir, 'rank_{}_{}.json'))
    records = {}
    for backend, world, parts in (('gloo', 2, ['routed', 'masked']),
                                  ('nccl', 1, ['routed'])):
        spec_path = os.path.join(workdir, 'ranks_{}.json'.format(backend))
        with open(spec_path, 'w') as fh:
            json.dump(dict(spec, parts=parts), fh)
        port = _free_port()
        logs = [os.path.join(workdir, 'rank_{}_{}.log'.format(backend, r))
                for r in range(world)]
        procs = []
        for rank in range(world):
            with open(logs[rank], 'w') as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), '--rank',
                     str(rank), str(world), str(port), backend, spec_path],
                    stdout=log, stderr=subprocess.STDOUT))
        _wait_ranks(procs, logs, RANK_TIMEOUT[backend])
        records[backend] = []
        for rank in range(world):
            with open(spec['out'].format(backend, rank)) as fh:
                records[backend].append(json.load(fh))
    smi = _nvidia_smi()
    for backend, ranks in records.items():
        for name in ranks[0]['walls']:
            walls = [r['walls'][name] for r in ranks]
            moved = [r['traffic'][name] for r in ranks]
            nbatch = sum(ranks[0]['batches'].get(name, {}).get(k, 0)
                         for k in ('routed', 'replicated'))
            line = ('[smoke] distributed ({}; {} rank(s) over {}, every cell '
                    'on {}): {}: wall {:.2f} s ({}); batches {}; bytes a '
                    'rank sent across ranks {} in all'.format(
                        smi, len(ranks), backend, device, name, max(walls),
                        ', '.join('rank {} {:.2f} s'.format(i, w)
                                  for i, w in enumerate(walls)),
                        ranks[0]['batches'].get(name), [
                            '{:,}'.format(m['bytes']) for m in moved]))
            if moved[0]['exchanges']:
                line += ', {} a batch'.format(['{:,.0f}'.format(
                    m['bytes'] / nbatch) for m in moved])
                line += ('; the routed exchange (all_to_all_parts, staging '
                         'included) {} ms a batch'.format(['{:.3f}'.format(
                             1e3 * m['exchange_s'] / m['exchanges'])
                             for m in moved]))
            line += '; collective calls {}; launches {}'.format(
                [m['calls'] for m in moved],
                [{k: v for k, v in r['launches'][name].items() if v}
                 for r in ranks])
            print(line, flush=True)
    gloo = records['gloo']
    print('[smoke] distributed: the routed (1, 4) count over two gloo ranks '
          '{:.2f} s, over one NCCL rank {:.2f} s, against {:.2f} s in one '
          'process (phase 11, this call); every rank\'s shards == the '
          'one-process count\'s, the masked (2, 2) shards == case.ct, the '
          'screen over {:,} reads ({:,} lines of augmented FASTQ) and a '
          'query == one process\'s on both ranks; phase wall {:.1f} '
          's'.format(
              max(r['walls']['routed count (1, 4)'] for r in gloo),
              records['nccl'][0]['walls']['routed count (1, 4)'],
              one_process_wall, SCREEN_SLICE_READS,
              gloo[0]['screen_lines'], time.time() - t_phase), flush=True)
    return records


# ------------------------------------------- against an older checkout


def _spread(times):
    """'median (min-max)' of a list of milliseconds."""
    return '{:.4f} ms ({:.4f}-{:.4f})'.format(
        float(np.median(times)), min(times), max(times))


# Appended to the older tree's align.cu, inside its translation unit, so
# that its two kernels can be launched and timed apart.
_PARENT_ALIGN_SHIM = r'''
extern "C" int kt_parent_dp(const void* targets, const void* tlens, int T,
                            const void* queries, const void* qlens, int Q,
                            int B, const void* zoff, void* z, void* scores,
                            void* gscratch, int smem_bytes, int match,
                            int mismatch, int gapopen, int gapextend,
                            void* stream)
{
    const int b = mismatch < 0 ? mismatch : -mismatch;
    const int shared = gscratch ? 0 : smem_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        ksw_extz_dp, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
    ksw_extz_dp<<<B, kDpThreads, shared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(targets),
        static_cast<const int32_t*>(tlens), T,
        static_cast<const uint8_t*>(queries),
        static_cast<const int32_t*>(qlens), Q,
        static_cast<const int64_t*>(zoff), static_cast<uint8_t*>(z),
        static_cast<int32_t*>(scores), static_cast<int32_t*>(gscratch),
        match, b, gapopen + gapextend, gapextend);
    return (int)cudaGetLastError();
}

extern "C" int kt_parent_traceback(const void* tlens, const void* qlens,
                                   int B, const void* zoff, const void* z,
                                   void* ops_rev, int S, void* exit_i,
                                   void* exit_j, void* stream)
{
    ksw_extz_traceback<<<(B + kTbThreads - 1) / kTbThreads, kTbThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tlens),
        static_cast<const int32_t*>(qlens),
        static_cast<const int64_t*>(zoff), static_cast<const uint8_t*>(z),
        B, S, static_cast<uint8_t*>(ops_rev),
        static_cast<int32_t*>(exit_i), static_cast<int32_t*>(exit_j));
    return (int)cudaGetLastError();
}
'''


def _parent_libs(parent, builddir, align=True):
    """The older tree's ``csrc/align.cu`` and ``csrc/kmer.cu`` built apart
    and bound with the signatures they had: a block per pair with the
    wavefront in shared memory and one direction byte per cell in row-major
    order (its DP and traceback kernels reached through a shim appended to
    the source), ``kt_scatter_add`` over a ``[T, N]`` index tensor, and
    ``kt_route`` into a send buffer its caller fills with the sentinel and
    populations it zeroes (slots in the order of shared-memory atomics).
    Without ``align`` only the kmer library is built (the align one is
    None)."""
    import ctypes
    from kevlar_tpu_torch import native
    csrc = os.path.join(parent, 'kevlar_tpu_torch', 'csrc')
    sources = [('kmer', os.path.join(csrc, 'kmer.cu'))]
    if align:
        shimmed = os.path.join(builddir, 'align_parent.cu')
        with open(os.path.join(csrc, 'align.cu')) as fh, \
                open(shimmed, 'w') as out:
            out.write(fh.read() + _PARENT_ALIGN_SHIM)
        sources.insert(0, ('align', shimmed))
    libs = []
    for name, source in sources:
        lib = os.path.join(builddir, 'libkevlar_{}_parent.so'.format(name))
        subprocess.run(
            [native.nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
             '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-o',
             lib, source], check=True)
        libs.append(ctypes.CDLL(lib))
    align, kmer = libs if align else [None] + libs
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    kmer.kt_scatter_add.restype = ci
    kmer.kt_scatter_add.argtypes = [vp, cl, vp, cl, cl, vp]
    u32 = ctypes.c_uint32
    kmer.kt_route.restype = ci
    kmer.kt_route.argtypes = [vp, vp, vp, cl, cl, u32, cl, u32, ci, ci, cl,
                              vp, vp, vp]
    if align is None:
        return align, kmer
    align.kt_parent_dp.restype = ci
    align.kt_parent_dp.argtypes = [vp, vp, ci, vp, vp, ci, ci, vp, vp, vp,
                                   vp, ci, ci, ci, ci, ci, vp]
    align.kt_parent_traceback.restype = ci
    align.kt_parent_traceback.argtypes = [vp, vp, ci, vp, vp, vp, ci, vp, vp,
                                          vp]
    return align, kmer


def _parent_ksw_extz(lib, targets, tlens, queries, qlens, events=None,
                     match=1, mismatch=2, gapopen=5, gapextend=0):
    """The older tree's ``ksw_extz_cuda``: row-major direction bytes,
    wavefront state in dynamic shared memory (global scratch beyond 227
    KB)."""
    import torch
    dev = targets.device
    B, T = targets.shape
    Q = queries.shape[1]
    S = T + Q
    zlen = tlens.to(torch.int64) * qlens.to(torch.int64)
    zoff = torch.cumsum(zlen, 0) - zlen
    z = torch.empty(max(int(zlen.sum()), 1), dtype=torch.uint8, device=dev)
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    ops_rev = torch.empty((B, S), dtype=torch.uint8, device=dev)
    exit_i = torch.empty(B, dtype=torch.int32, device=dev)
    exit_j = torch.empty(B, dtype=torch.int32, device=dev)
    state_words = 3 * (T + Q) - 1
    smem_bytes = 4 * state_words
    gscratch = None
    if smem_bytes > 232448:
        gscratch = torch.empty(B * state_words, dtype=torch.int32,
                               device=dev)
        smem_bytes = 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    if events is not None:
        events[0].record()
    err = lib.kt_parent_dp(
        targets.data_ptr(), tlens.data_ptr(), T, queries.data_ptr(),
        qlens.data_ptr(), Q, B, zoff.data_ptr(), z.data_ptr(),
        scores.data_ptr(), None if gscratch is None else gscratch.data_ptr(),
        smem_bytes, match, mismatch, gapopen, gapextend, stream)
    if events is not None:
        events[1].record()
    err = err or lib.kt_parent_traceback(
        tlens.data_ptr(), qlens.data_ptr(), B, zoff.data_ptr(), z.data_ptr(),
        ops_rev.data_ptr(), S, exit_i.data_ptr(), exit_j.data_ptr(), stream)
    if events is not None:
        events[2].record()
    if err:
        raise RuntimeError('parent ksw_extz: CUDA error {}'.format(err))
    return scores, ops_rev, exit_i, exit_j


def compare_align(old, device, workdir, reps=5):
    """B1 of the older tree and of this one on every alignment row of the
    bigsim alac run (phase 4's input, through the CLI), in turns (old, new,
    new, old): results must be identical; prints the median and range of
    ``2 x reps`` runs of the whole wrapper call, the DP kernel and the
    traceback kernel."""
    import functools
    from kevlar_tpu_torch.ops import align_cuda
    run = phase_slice(device, workdir)
    batches = [(batch, args)
               for _, batch, args, _ in _alac_batches(run['rows'], device)]
    old_fn = functools.partial(_parent_ksw_extz, old)
    for batch, args in batches:
        _compare(align_cuda.ksw_extz_cuda(*batch, **args),
                 old_fn(*batch, **args), 'B1 new vs old')
    times = [_align_times(fn, batches, reps)
             for fn in (old_fn, align_cuda.ksw_extz_cuda,
                        align_cuda.ksw_extz_cuda, old_fn)]
    nrows = sum(b[0].shape[0] for b, _ in batches)
    for k, part in enumerate(('wrapper call (host clock, synchronised)',
                              'DP kernel', 'traceback kernel')):
        print('[compare] B1 {:,} alac rows in {} chunks, {}: old {}; new {}; '
              'bound {:.4f} ms by {}'.format(
                  nrows, len(batches), part,
                  _spread([t[k] for t in times[0] + times[3]]),
                  _spread([t[k] for t in times[1] + times[2]]),
                  run['bound_ms'], run['bound_by']), flush=True)


def _parent_consume_step(old, acc, h1, h2, valid, mcnt, mask_threshold):
    """The older tree's consume after K1 and K2: its torch glue (two
    widenings to int64, the predicates, four bucket indices, a stack, a
    where and a cast to the int32 index tensor), then its
    ``kt_scatter_add``."""
    import torch
    from kevlar_tpu_torch.ops import hashing
    keep = valid != 0
    a = hashing.to_u32(h1)
    b = hashing.to_u32(h2)
    keep = keep & (mcnt <= mask_threshold)
    tablesize = acc.shape[1]
    idx = torch.stack([hashing.table_index(a, b, t, tablesize)
                       for t in range(acc.shape[0])])
    idx = torch.where(keep, idx, -1).to(torch.int32)
    err = old.kt_scatter_add(acc.data_ptr(), tablesize, idx.data_ptr(),
                             idx.shape[0], idx.shape[1],
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError('parent kt_scatter_add: CUDA error {}'.format(err))
    return acc


def compare_consume(old, device, reps=30):
    """The consume step (K1's and K2's outputs to the updated 2 GB
    accumulator) of the older tree and of this one at the proband count's
    shape, and the two trees' ``kt_scatter_add`` over the same indices, in
    turns (old, new, new, old): results must be identical; prints the
    median and range of ``2 x reps`` runs."""
    import torch
    from kevlar_tpu_torch.ops import hashing, kmer_cuda
    rng = np.random.default_rng(SEED + 13)
    C = 124_999_999
    n = 32768 * 130
    h1, h2 = _random_hashes(rng, n, device)
    valid = torch.from_numpy((rng.random(n) < 0.995).astype(np.uint8)).to(
        device)
    mcnt = torch.from_numpy((rng.random(n) >= 0.15).astype(np.uint8)).to(
        device)
    acc = torch.zeros((4, C), dtype=torch.int32, device=device)

    def old_step():
        return _parent_consume_step(old, acc, h1, h2, valid, mcnt, 0)

    def new_step():
        return kmer_cuda.consume_cuda(acc, h1, h2, valid, mcnt=mcnt,
                                      mask_threshold=0)

    want = old_step().clone()
    acc.zero_()
    _max_diff(new_step(), want, 'consume step new vs old')
    nkept = int(want.sum()) // 4
    del want
    times = [_launch_times(fn, reps)
             for fn in (old_step, new_step, new_step, old_step)]
    print('[compare] consume step, {:,} hashed k-mers ({:,} kept) into 4 x '
          '{:,} int32: old (torch glue + kt_scatter_add) {}; new (kt_consume) '
          '{}; bound {:.4f} ms'.format(
              n, nkept, C, _spread(times[0] + times[3]),
              _spread(times[1] + times[2]),
              _bound(n * 10 + nkept * 4 * 2 * SECTOR, 0)[0]), flush=True)

    a, b = hashing.to_u32(h1), hashing.to_u32(h2)
    idx = torch.stack([hashing.table_index(a, b, t, C) for t in range(4)])
    idx = torch.where((valid != 0) & (mcnt <= 0), idx, -1).to(torch.int32)
    del a, b
    stream = torch.cuda.current_stream().cuda_stream

    def old_scatter():
        if old.kt_scatter_add(acc.data_ptr(), C, idx.data_ptr(), 4, n,
                              stream):
            raise RuntimeError('parent kt_scatter_add failed')

    def new_scatter():
        return kmer_cuda.scatter_add_cuda(acc, idx)

    flat = (idx.long() + torch.arange(4, device=device)[:, None] * C)[
        idx >= 0]
    ones = torch.ones_like(flat, dtype=torch.int32)

    def library():
        return acc.view(-1).index_add_(0, flat, ones)

    times = [_launch_times(fn, reps)
             for fn in (old_scatter, new_scatter, library, library,
                        new_scatter, old_scatter)]
    print('[compare] kt_scatter_add, 4 x {:,} indices ({:,} kept): old {}; '
          'new {}; one index_add_ {}; bound {:.4f} ms'.format(
              n, nkept, _spread(times[0] + times[5]),
              _spread(times[1] + times[4]), _spread(times[2] + times[3]),
              _bound(idx.numel() * 4 + 4 * nkept * 2 * SECTOR, 0)[0]),
          flush=True)


def _route_sorted(send, pop, sentinel):
    """``send`` with every slot past its bin's population set to
    ``sentinel``, each bin sorted: the older ``kt_route``'s slot order is
    its own."""
    import torch
    slots = torch.arange(send.shape[2], device=send.device)
    outside = slots[None, None, :] >= pop.to(torch.int64)[:, :, None]
    return torch.where(outside, sentinel, send).sort(dim=2).values


def compare_routed(old, device, reps=30):
    """The routed consume's two kernels of the older tree and of this one
    at the sharded phase's shapes (a (1, 4) mesh over a 500M table), in
    turns (old, new, new, old) by CUDA events behind the spin kernel:
    ``kt_route`` on one device's share of a count batch and on a whole
    batch (the older call: the sentinel fill, the zeroed populations and
    its kernel; also its kernel with the zeroing alone); and the owner of
    shard 0's add, the older ``kt_scatter_add`` over the stacked,
    sentinel-filled bins against this tree's over the parts where they
    lie, each also with its all_to_all.  Results must agree: the same
    populations and bins (sorted), the same accumulator."""
    import torch
    from kevlar_tpu_torch.ops import kmer_cuda
    from kevlar_tpu_torch.parallel import collectives
    rng = np.random.default_rng(SEED + 17)
    ss = SHARD_TOTAL // SHARDS + 1
    stream = torch.cuda.current_stream().cuda_stream
    magic, shard_magic = (kmer_cuda.mod_magic(x) for x in (SHARD_TOTAL, ss))
    sends = []
    for nrows in [32768 // SHARDS] * SHARDS + [32768]:
        codes = torch.from_numpy(_read_bases(rng, nrows, 160, 150)).to(
            device)
        h1, h2, valid = (x.reshape(-1) for x in
                         kmer_cuda.kmer_hashes_cuda(codes, KSIZE))
        n = h1.numel()
        cap = _capacity(nrows * SHARDS, 160, SHARDS)
        send = torch.empty((4, SHARDS, cap), dtype=torch.int32,
                           device=device)
        pop = torch.empty((4, SHARDS), dtype=torch.int32, device=device)

        def old_kernel():
            pop.zero_()
            if old.kt_route(h1.data_ptr(), h2.data_ptr(), valid.data_ptr(),
                            n, SHARD_TOTAL, magic, ss, shard_magic, 4,
                            SHARDS, cap, send.data_ptr(), pop.data_ptr(),
                            stream):
                raise RuntimeError('parent kt_route failed')

        def old_call():
            send.fill_(ss)
            old_kernel()

        def new_call():
            return kmer_cuda.route_cuda(h1, h2, valid, 4, SHARDS, ss,
                                        SHARD_TOTAL, cap)

        old_call()
        got = new_call()
        _max_diff(got[1], pop, 'kt_route new vs old populations')
        _max_diff(_route_sorted(got[0], got[1], ss), send.sort(dim=2).values,
                  'kt_route new vs old bins (sorted)')
        if nrows < 32768:
            sends.append((send.clone(), got))
            if len(sends) > 1:      # the other devices' shares: not timed
                continue
        times = [_launch_times(fn, reps) for fn in (
            old_call, old_kernel, new_call, new_call, old_kernel, old_call)]
        print('[compare] kt_route, {:,} k-mers x 4 tables to {} shards, '
              'capacity {:,}: old (fill + kernel) {}; old kernel alone {}; '
              'new {}'.format(n, SHARDS, cap, _spread(times[0] + times[5]),
                              _spread(times[1] + times[4]),
                              _spread(times[2] + times[3])), flush=True)
        del codes, h1, h2, valid, send, pop, got

    mesh = _mesh(device, 1, SHARDS)
    old_send = [[x[0] for x in sends]]
    new_send = [[x[1][0] for x in sends]]
    new_pop = [[x[1][1] for x in sends]]
    recv = collectives.all_to_all(mesh, old_send)[0][0].reshape(4, -1)
    parts, pops = (x[0][0] for x in collectives.all_to_all_parts(
        mesh, new_send, new_pop))
    acc = torch.zeros((4, ss), dtype=torch.int32, device=device)
    want = acc.clone()
    if old.kt_scatter_add(want.data_ptr(), ss, recv.data_ptr(), 4,
                          recv.shape[1], stream):
        raise RuntimeError('parent kt_scatter_add failed')
    _max_diff(kmer_cuda.scatter_add_parts_cuda(acc.clone(), parts, pops),
              want, 'kt_scatter_add new (parts) vs old (stacked)')
    del want

    def old_scatter():
        if old.kt_scatter_add(acc.data_ptr(), ss, recv.data_ptr(), 4,
                              recv.shape[1], stream):
            raise RuntimeError('parent kt_scatter_add failed')

    def new_scatter():
        kmer_cuda.scatter_add_parts_cuda(acc, parts, pops)

    def old_path():
        stacked = collectives.all_to_all(mesh, old_send)[0][0]
        if old.kt_scatter_add(acc.data_ptr(), ss, stacked.data_ptr(), 4,
                              stacked.shape[1] * stacked.shape[2], stream):
            raise RuntimeError('parent kt_scatter_add failed')

    def new_path():
        kmer_cuda.scatter_add_parts_cuda(
            acc, collectives.all_to_all_parts(mesh, new_send)[0][0],
            collectives.all_to_all_parts(mesh, new_pop)[0][0])

    times = [_launch_times(fn, reps) for fn in (
        old_scatter, old_path, new_scatter, new_path, new_path, new_scatter,
        old_path, old_scatter)]
    nkept = sum(int(p.clamp(max=recv.shape[1] // SHARDS).sum())
                for p in pops)
    print('[compare] kt_scatter_add on the owner\'s received bins ({:,} '
          'updates of 4 x {:,} slots into 4 x {:,} int32): old kernel '
          '(stacked bins, sentinels read) {}; new kernel (parts, filled '
          'prefixes) {}; with the all_to_all: old (stack + kernel) {}, new '
          '(parts + kernel) {}'.format(
              nkept, recv.shape[1], ss, _spread(times[0] + times[7]),
              _spread(times[2] + times[5]), _spread(times[1] + times[6]),
              _spread(times[3] + times[4])), flush=True)


_ROUTED_COUNT = r"""
import hashlib, sys, time
import torch
from kevlar_tpu_torch import count
from kevlar_tpu_torch.cli import memory_setting
from kevlar_tpu_torch.parallel import make_mesh
small, fastq, ksize = sys.argv[1], sys.argv[2], int(sys.argv[3])
mesh = make_mesh(1, 4, devices=['cuda:0'] * 4)
count.load_sample_seqfile([small], ksize, memory_setting('8M'), maxfpr=1.0,
                          mesh=mesh)
torch.cuda.synchronize()
t0 = time.time()
sketch = count.load_sample_seqfile([fastq], ksize, memory_setting('500M'),
                                   maxfpr=0.6, mesh=mesh)
torch.cuda.synchronize()
wall = time.time() - t0
print(wall, sketch.batches['routed'],
      hashlib.sha256(sketch._host().tobytes()).hexdigest())
"""


def _routed_count(tree, small, fastq):
    """The helium proband counted on a (1, 4) mesh over this card (the
    routed consume) by the checkout ``tree``, in a process of its own after
    a small warm-up count: (wall in seconds, routed batches, a digest of
    the tables)."""
    proc = subprocess.run(
        [sys.executable, '-c', _ROUTED_COUNT, small, fastq, str(KSIZE)],
        cwd=tree, check=True, capture_output=True, text=True)
    wall, routed, digest = proc.stdout.split()[-3:]
    return float(wall), int(routed), digest


def _cli_count(tree, argv, logpath):
    """``python -m kevlar_tpu_torch -l logpath count argv`` in a process
    of its own, from the checkout ``tree``; returns (the stage's own
    "Total time" in seconds, the process's wall)."""
    t0 = time.time()
    subprocess.run([sys.executable, '-m', 'kevlar_tpu_torch', '-l', logpath,
                    'count'] + argv, cwd=tree, check=True)
    wall = time.time() - t0
    with open(logpath) as fh:
        total = re.findall(r'Total time: ([0-9.]+) seconds', fh.read())
    return float(total[-1]), wall


def compare_counts(parent, device, workdir):
    """The helium proband's masked count through the CLI of the older tree
    and of this one, each run a process of its own, in the order parent,
    change, change, parent; then its routed count on a (1, 4) mesh over
    the card in the same order; then the producer's share in both."""
    here = os.path.dirname(os.path.abspath(__file__))
    refr, reads, _ = make_trio_case(workdir)
    base = ['-k', str(KSIZE), '--device', device]
    mask = os.path.join(workdir, 'mask.nt')
    _cli_count(here, base + ['-c', '1', '-M', '50M', '--max-fpr', '0.01',
                             mask, refr], os.path.join(workdir, 'mask.log'))
    # a small count first, so that each tree has built its libraries
    small = os.path.join(workdir, 'small.fq')
    with open(reads['proband'], 'rb') as fh, open(small, 'wb') as out:
        out.write(fh.read(40000 * (16 + 2 * READLEN)))
    tables = []
    for turn, tree in enumerate((parent, here, here, parent)):
        name = 'parent' if tree == parent else 'change'
        if turn < 2:
            _cli_count(tree, base + ['-M', '8M', '--max-fpr', '1.0',
                                     os.path.join(workdir, 'small.ct'),
                                     small],
                       os.path.join(workdir, 'small.log'))
        out = os.path.join(workdir, 'proband{}.ct'.format(turn))
        total, wall = _cli_count(
            tree, base + ['-M', '500M', '--max-fpr', '0.6', '--mask', mask,
                          out, reads['proband']],
            os.path.join(workdir, 'count{}.log'.format(turn)))
        with np.load(out) as members:
            tables.append(members['tables'])
        os.remove(out)
        print('[compare] count proband, {}: {:.2f} s (stage), {:.2f} s '
              '(process)'.format(name, total, wall), flush=True)
    if not all(np.array_equal(tables[0], t) for t in tables[1:]):
        raise AssertionError('the trees\' proband tables differ')
    print('[compare] the four runs\' tables are identical', flush=True)

    digests = set()
    for tree in (parent, here, here, parent):
        wall, routed, digest = _routed_count(tree, small, reads['proband'])
        digests.add(digest)
        print('[compare] routed count proband on (1, 4), {}: {:.2f} s, {} '
              'batches routed'.format('parent' if tree == parent else
                                      'change', wall, routed), flush=True)
    if len(digests) != 1:
        raise AssertionError('the trees\' routed proband tables differ')
    print('[compare] the four routed runs\' tables are identical',
          flush=True)

    print('[compare] producer alone over the proband: reader {:.2f} s; '
          'reader into pinned memory + copies {:.2f} s'.format(
              *_producer_split(reads['proband'], device)), flush=True)


_SCREEN_RUN = r"""
import hashlib, importlib.util, inspect, json, re, subprocess, sys, time
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from kevlar_tpu_torch.ops import novel_ops
smoke, stacks, workdir, novel_argv = sys.argv[1:5]
spec = importlib.util.spec_from_file_location('smoke_here', smoke)
here = importlib.util.module_from_spec(spec)
spec.loader.exec_module(here)
with np.load(stacks) as z:
    dev = [torch.from_numpy(z[n]).cuda() for n in
           ('cp', 'cb', 'mp', 'mb', 'fp', 'fb', 'lens')]


def run():
    return novel_ops.count_and_screen_stack_packed(
        dev[0], dev[1], (dev[2], dev[4]), (dev[3], dev[5]), dev[6],
        L=here.BENCH_PADLEN, ksize=here.KSIZE,
        tablesize=here.HELIUM_TABLESIZE, ntables=4, maxcount=255,
        casemin=here.BENCH_CASEMIN, ctrlmax=here.BENCH_CTRLMAX)


out = run()
torch.cuda.synchronize()
digest = hashlib.sha256(b''.join(
    x.cpu().numpy().tobytes() for x in out[0])).hexdigest()
walls = []
for _ in range(3):
    del out
    torch.cuda.synchronize()
    t0 = time.time()
    out = run()
    torch.cuda.synchronize()
    walls.append(time.time() - t0)
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    t0 = time.time()
    run()
    torch.cuda.synchronize()
    wall = time.time() - t0
busy = here._print_busy('program', prof, wall) / wall
del out, dev, prof
# the screen alone at phase 5's shapes: one launch here, K1 and two
# kernels in a tree whose screen takes K1's hashes
from kevlar_tpu_torch.ops import hashing, sketch_ops
words = sketch_ops.pack_sample_tables(here._screen_tables(
    'cuda', here.HELIUM_TABLESIZE, here.SEED + 12))
takes_hashes = 'h1' in inspect.signature(
    novel_ops.novel_screen_compact).parameters
rng = np.random.default_rng(here.SEED + 5)
screen_ms = {}
for n in (here.DEFAULT_SCREEN_READS, here.BENCH_BATCH):
    codes, lens = here._screen_batch(rng, n, 'cuda')
    if takes_hashes:
        def screen():
            return novel_ops.novel_screen_compact(
                words, 3, 1, *hashing.kmer_hashes_codes(codes, here.KSIZE),
                codes, lens, here.KSIZE, 5, 1)
    else:
        def screen():
            return novel_ops.novel_screen_compact(
                words, 3, 1, codes, lens, here.KSIZE, 5, 1)
    screen_ms[n] = here._timed(screen, reps=20, spin=True)[1]
del words
log = workdir + '/novel.log'
t0 = time.time()
subprocess.run([sys.executable, '-m', 'kevlar_tpu_torch', '-l', log,
                'novel'] + novel_argv.split(), check=True)
process = time.time() - t0
with open(log) as fh:
    stage = float(re.findall(r'Total time: ([0-9.]+) seconds', fh.read())[-1])
with open(novel_argv.split()[-1], 'rb') as fh:
    text = hashlib.sha256(fh.read()).hexdigest()
print(json.dumps(dict(walls=walls, busy=busy, digest=digest, novel=stage,
                      novel_process=process, novel_text=text,
                      screen_ms=screen_ms)))
"""


def compare_screen(parent):
    """``--compare-screen DIR``: the fused count and screen (phase 13's
    helium stacks), the screen alone (phase 5's helium-sized tables at
    4,096 and 8,192 rows, behind a spin kernel, K1 included where the
    tree's screen takes K1's hashes) and the ``novel`` stage (through the
    CLI, on the helium trio's counts) in the checkout unpacked in ``DIR``
    and in this one, each tree a process of its own, in the order parent,
    change, change, parent: the program's best-of-3 wall and a profiled
    run's busy share (both measured by this tree's code), the screen's
    times, the novel stage's wall, and the outputs' digests, which must
    agree."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    parent = os.path.abspath(parent)
    here = os.path.dirname(os.path.abspath(__file__))
    print(_nvidia_smi(), flush=True)
    build_all()
    with tempfile.TemporaryDirectory() as workdir:
        refr, reads, _ = make_trio_case(workdir)
        _trio_stages('cuda', workdir, refr, reads, '')
        torch.cuda.empty_cache()
        with ThreadPoolExecutor(len(SAMPLES)) as pool:
            read = list(pool.map(_read_packed_stack,
                                 [reads[who] for who in SAMPLES]))
        stacks = os.path.join(workdir, 'stacks.npz')
        np.savez(stacks, cp=read[0][0], cb=read[0][1], mp=read[1][0],
                 mb=read[1][1], fp=read[2][0], fb=read[2][1],
                 lens=read[0][2])
        del read
        novel_out = os.path.join(workdir, 'novel.augfastq')
        novel_argv = ' '.join([
            '-k', str(KSIZE), '--device', 'cuda', '--case',
            reads['proband'], '--case-counts',
            os.path.join(workdir, 'proband.ct'), '--control-counts',
            os.path.join(workdir, 'mother.ct'),
            os.path.join(workdir, 'father.ct'), '--case-min', '5',
            '--ctrl-max', '1', '-o', novel_out])
        digests, texts = set(), set()
        for tree in (parent, here, here, parent):
            proc = subprocess.run(
                [sys.executable, '-c', _SCREEN_RUN,
                 os.path.join(here, 'chip_smoke.py'), stacks, workdir,
                 novel_argv], cwd=tree, check=True, capture_output=True,
                text=True)
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            digests.add(rec['digest'])
            texts.add(rec['novel_text'])
            print('[compare] {}: program best of 3 {:.1f} ms ({}), busy '
                  '{:.2%}; novel stage {:.2f} s ({:.2f} s the process); the '
                  'screen alone {}'.format(
                      'parent' if tree == parent else 'change',
                      1e3 * min(rec['walls']), ', '.join(
                          '{:.1f}'.format(1e3 * w) for w in rec['walls']),
                      rec['busy'], rec['novel'], rec['novel_process'],
                      ', '.join('{:,} rows {:.4f} ms'.format(int(n), ms)
                                for n, ms in rec['screen_ms'].items())),
                  flush=True)
        if len(digests) != 1 or len(texts) != 1:
            raise AssertionError('the trees\' outputs differ')
        print('[compare] the four runs\' program outputs and novel texts are '
              'identical; {}'.format(_nvidia_smi()), flush=True)
    return 0


def profile_workflow():
    """``--profile-workflow``: the helium trio through run_mark1 under
    torch.profiler, for the card's busy share of the trio wall."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    print(_nvidia_smi(), flush=True)
    build_all()
    with tempfile.TemporaryDirectory() as workdir:
        refr, reads, denovo = make_trio_case(workdir)
        phase_workflow('cuda', workdir, refr, denovo, reads, profiled=True)
    return 0


def compare_parent(parent):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    parent = os.path.abspath(parent)
    print(_nvidia_smi(), flush=True)
    build_all()
    here = os.path.dirname(os.path.abspath(__file__))
    source = os.path.join('kevlar_tpu_torch', 'csrc', 'align.cu')
    with open(os.path.join(parent, source), 'rb') as fh, \
            open(os.path.join(here, source), 'rb') as gh:
        same_b1 = fh.read() == gh.read()
    with tempfile.TemporaryDirectory() as workdir:
        old_align, old_kmer = _parent_libs(parent, workdir,
                                           align=not same_b1)
        compare_consume(old_kmer, 'cuda')
        compare_routed(old_kmer, 'cuda')
        if same_b1:
            print('[compare] B1: csrc/align.cu is the same in both trees, '
                  'not compared', flush=True)
        else:
            compare_align(old_align, 'cuda', workdir)
    with tempfile.TemporaryDirectory() as workdir:
        compare_counts(parent, 'cuda', workdir)
    return 0


def count_screen_probe():
    """``--count-screen``: the word gather's and the screen kernels'
    checks at phase 5's shapes and the fused program at bench.py's trio
    (with the plain run) and on random reads of the helium stacks' shape
    (611 batches a sample), each under the sync debug mode, and phase
    14's ``count_novel`` entry; a short card check of phases 13 and 14's
    count and screen without the rest of the smoke."""
    from kevlar_tpu_torch.batch import pack_bases
    from kevlar_tpu_torch.ops import kmer_cuda
    print(_nvidia_smi(), flush=True)
    kmer_cuda.build(force=True)
    rng = np.random.default_rng(SEED + 13)
    samples = [_random_sketch(rng, 8, HELIUM_TABLESIZE, 'cuda')
               for _ in range(3)]
    _word_gather_checks('cuda', rng, samples)
    del samples
    _screen_kernel_checks('cuda', rng)
    bench, _ = _program_at_bench_trio('cuda', plain=True)
    bench_count_novel('cuda', bench['interesting'])
    nb = 611
    stacks = [pack_bases(rng.integers(0, 4, (nb, BENCH_BATCH, BENCH_PADLEN),
                                      dtype=np.uint8)) for _ in range(3)]
    _drive_program('cuda', stacks,
                   np.full((nb, BENCH_BATCH), BENCH_PADLEN, np.int32),
                   (nb * BENCH_BATCH,) * 3, HELIUM_TABLESIZE,
                   'random reads of the helium stacks\' shape')
    return 0


def bench_tools_probe():
    """``--bench-tools``: the builds, the helium trio of phase 6 (its
    generator only) and phase 15, without the rest of the smoke."""
    print(_nvidia_smi(), flush=True)
    builds = build_all()
    print('[smoke] built in {}'.format(builds), flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.time()
        refr, reads, denovo = make_trio_case(workdir)
        print('[smoke] generated the helium trio in {:.1f} s'.format(
            time.time() - t0), flush=True)
        phase_bench_tools('cuda', workdir, dict(refr=refr, reads=reads,
                                                denovo=denovo))
    return 0


def bigsim_probe():
    """``--bigsim``: the card, the builds and phase 16, without the rest
    of the smoke."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    print(_nvidia_smi(), flush=True)
    builds = build_all()
    print('[smoke] built in {}'.format(builds), flush=True)
    phase_bigsim('cuda')
    return 0


def build_all():
    """Phase 2: compile every library from the checkout's sources, all at
    once (one compiler process each); returns {library: seconds}."""
    from concurrent.futures import ThreadPoolExecutor
    from kevlar_tpu_torch import native
    from kevlar_tpu_torch.ops import align_cuda, cc_cuda, kmer_cuda

    def timed_build(fn):
        t0 = time.time()
        fn(force=True)
        return time.time() - t0

    builds = {'csrc/align.cu (nvcc)': align_cuda.build,
              'csrc/kmer.cu (nvcc)': kmer_cuda.build,
              'csrc/cc.cu (nvcc)': cc_cuda.build,
              'asm.cpp (g++)': native.build,
              'fastx.cpp (g++ -lz)': native.build_fastx}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed_build, fn)
                   for name, fn in builds.items()}
        return {name: f.result() for name, f in futures.items()}


def main():
    import torch
    if sys.argv[1:2] == ['--rank']:
        return rank_main(sys.argv[2:])
    if sys.argv[1:2] == ['--compare-parent']:
        return compare_parent(sys.argv[2])
    if sys.argv[1:2] == ['--profile-workflow']:
        return profile_workflow()
    if sys.argv[1:2] == ['--count-screen']:
        return count_screen_probe()
    if sys.argv[1:2] == ['--compare-screen']:
        return compare_screen(sys.argv[2])
    if sys.argv[1:2] == ['--workflow-only']:
        return workflow_only_main(sys.argv[2])
    if sys.argv[1:2] == ['--bench-tools']:
        return bench_tools_probe()
    if sys.argv[1:2] == ['--bigsim']:
        return bigsim_probe()
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    device = 'cuda'
    t_all = time.time()
    smi = _nvidia_smi()
    print(smi, flush=True)

    t0 = time.time()
    builds = build_all()
    print('[smoke] built in parallel in {:.1f} s: {}'.format(
        time.time() - t0, ', '.join('{} {:.1f} s'.format(name, sec)
                                    for name, sec in builds.items())),
        flush=True)

    err = phase_kernel(device)
    with tempfile.TemporaryDirectory() as workdir:
        run = phase_slice(device, workdir)
        phase_call(device, workdir, run['refr'], run['reads'], run['vcf'])
        seedset = run.pop('seeds')
        seeds = phase_seeds(device, workdir, run['refr'], seedset)
        phase_sharded_seeds(device, run['refr'], seedset)
        phase_sharded_align(device, run.pop('rows'))
        part = phase_partition(device, workdir, run['reads'])
        cc = phase_cc_kernel(device, part.pop('incidence'))
    kmer = phase_kmer_kernels(device)
    kmer.update(sharded_kernel_checks(device))
    with tempfile.TemporaryDirectory() as workdir:
        trio = phase_trio(device, workdir)
        screen = phase_count_screen(device, trio['reads'])
        phase_bench_entries(device, workdir, screen['bench']['interesting'])
        flow = phase_workflow(device, workdir, trio['refr'],
                              trio['denovo'], trio['reads'])
        shard = phase_sharded(device, workdir, trio['reads'])
        phase_distributed(workdir, trio['reads'],
                          shard['walls']['count proband, (1, 4) routed'])
        sim = phase_simlike(device, workdir)
        phase_dist(device, workdir, trio['reads'])
        tools = phase_bench_tools(device, workdir, trio)
    phase_bigsim(device)
    print('[smoke] total wall {:.1f} s'.format(time.time() - t_all),
          flush=True)

    kernels = [{
        'name': 'ksw_extz (wavefront DP + traceback)', 'route': 'cuda',
        'source': 'kevlar_tpu_torch/csrc/align.cu',
        'replaces': 'kevlar_tpu/ops/align_pallas.py:204',
        'launches': run['launches'], 'max_abs_err': max(err, run['err']),
        'ms': run['ms'], 'dp_ms': run['dp_ms'],
        'traceback_ms': run['tb_ms'], 'plain_ms': run['plain_ms'],
        'bound_ms': run['bound_ms'], 'bound_by': run['bound_by'],
        'library_ms': None}]
    for key, name, counter, replaces, path in (
            ('K1', 'kmer_hashes (rolling k-mer hashing of base codes)',
             'kmer_hashes', 'kevlar_tpu/ops/hashing.py:82', trio),
            ('K2', 'gather_counts (Count-Min min over tables, all samples)',
             'gather_counts', 'kevlar_tpu/ops/sketch_ops.py:60', trio),
            ('K2 words', 'gather_counts_words (Count-Min min over tables, '
             'four samples a uint32 word; the novel stage\'s uncapped '
             'screen past the capacity, phase 6\'s dense screen)',
             'gather_counts_words', 'kevlar_tpu/ops/sketch_ops.py:105',
             dict(launches=trio['dense_launches'])),
            ('screen reads', 'screen_reads (kt_screen_reads: the reads '
             'hashed, the word gather, the screen\'s predicates and each '
             'hit at its rank below a fixed capacity, one launch a batch; '
             'run_mark1\'s novel stage)', 'screen_reads',
             'kevlar_tpu/ops/novel_ops.py:111', flow),
            ('K3 consume', 'consume (Count-Min scatter-add from hashes: '
             'predicates, bucket indices, atomic adds)', 'consume',
             'tools/scatter_probe.py:76', trio),
            ('K3', 'scatter_add (per-table int32 bincount from indices; '
             'the trio\'s device recount)', 'scatter_add',
             'tools/scatter_probe.py:76', trio),
            ('K3 routed', 'scatter_add (the owners\' add of the routed '
             'sharded consume, on its received bins where they lie)',
             'scatter_add_parts',
             'tools/scatter_probe.py:76', shard),
            ('route', 'route (kt_route: bins the bucket indices of hashed '
             'k-mers by owner shard)', 'route',
             'kevlar_tpu/parallel/sharded.py:99', shard),
            ('K2 range', 'gather_counts with a bucket range (a shard\'s '
             'counts, 255 outside it)', 'gather_counts_range',
             'kevlar_tpu/parallel/sharded.py:161', shard),
            ('K3 consume range', 'consume with a bucket range (a shard\'s '
             'adds of the replicate and masked sharded consume)',
             'consume_range', 'tools/scatter_probe.py:76', shard)):
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'kevlar_tpu_torch/csrc/kmer.cu', 'replaces': replaces,
            'launches': path['launches'][counter],
            'max_abs_err': kmer[key]['err'], 'ms': kmer[key]['ms'],
            'plain_ms': kmer[key]['plain_ms'],
            'bound_ms': kmer[key]['bound_ms'],
            'bound_by': kmer[key]['bound_by'],
            'library_ms': kmer[key]['library_ms']})
    kernels.append({
        'name': 'cc_labels (read-graph components, one-pass union-find)',
        'route': 'cuda', 'source': 'kevlar_tpu_torch/csrc/cc.cu',
        'replaces': 'kevlar_tpu/ops/cc_ops.py:16',
        'launches': part['launches'],
        'max_abs_err': max(cc['err'], tools['cc']['max_abs_err']),
        'ms': cc['ms'], 'plain_ms': cc['plain_ms'],
        'bound_ms': cc['bound_ms'], 'bound_by': cc['bound_by'],
        'library_ms': None, 'shape': cc['shape'],
        'control_plane': tools['cc']})
    programs = [{
        'name': 'seed_ranges (B7: two torch.searchsorted over the sorted '
                'keys as order-preserving int64)',
        'route': 'torch', 'source': 'kevlar_tpu_torch/ops/seed_ops.py',
        'replaces': 'kevlar_tpu/ops/seed_ops.py:77',
        'launches': seeds['launches'], 'ms': seeds['ms'],
        'host_ms': seeds['host_ms'], 'bound_ms': seeds['bound_ms'],
        'bound_by': seeds['bound_by']}, {
        'name': 'score_bundles (B8: float32 trio likelihoods, 11-scenario '
                'max)',
        'route': 'torch', 'source': 'kevlar_tpu_torch/ops/simlike_ops.py',
        'replaces': 'kevlar_tpu/ops/simlike_ops.py:54',
        'launches': sim['launches'], 'ms': sim['ms'],
        'host_ms': sim['host_ms'], 'host_bundles': sim['host_n'],
        'bound_ms': sim['bound_ms'], 'bound_by': sim['bound_by']}, {
        'name': 'count_and_screen_stack_packed (B.1: every sample counted '
                'with K1 + kt_consume, the tables packed four to a word, '
                'each case batch screened and compacted to a fixed capacity '
                'by kt_screen_reads; helium trio, and bench.py\'s trio)',
        'route': 'torch', 'source': 'kevlar_tpu_torch/ops/novel_ops.py',
        'replaces': 'kevlar_tpu/ops/novel_ops.py:171',
        'launches': screen['launches'],
        'ms': screen['helium']['ms'],
        'bench_trio_ms': screen['bench']['ms'],
        'h2d_ms': screen['helium']['h2d_ms'],
        'bench_trio_h2d_ms': screen['bench']['h2d_ms'],
        'count_novel_reads_per_s': screen['helium']['reads_per_s'],
        'bench_trio_count_novel_reads_per_s': screen['bench']['reads_per_s'],
        'host_ms': screen['bench']['host_ms'],
        'host_reads': screen['bench']['host_reads'],
        'vs_baseline': screen['bench']['vs_baseline'],
        'max_abs_err': screen['helium']['err'],
        'bound_ms': screen['helium']['bound_ms'],
        'bound_by': screen['helium']['bound_by'],
        'bench_trio_bound_ms': screen['bench']['bound_ms'],
        'device_busy': screen['helium']['busy'],
        'bench_trio_device_busy': screen['bench']['busy']}]
    print(json.dumps({'programs': programs}))
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
