"""End-to-end trio workflow: the mark-I pipeline without Snakemake.

Port of ``kevlar_tpu.workflow``.  The reference orchestrates the simplex
workflow as a Snakemake DAG of CLI invocations communicating through files
(kevlar/workflows/mark-I/Snakefile: create_mask -> count_reference ->
count case/controls (masked) -> novel -> filter -> partition -> split ->
assemble xN -> localize -> call xN -> varfilter -> simlike).  Here the same
pipeline runs as one in-process function on one torch device.  Stage outputs
are still written to the working directory as checkpoints (sketches,
augfastx, VCF).

Config (JSON) mirrors the reference's mark-I config.json vocabulary, plus
``device`` (the torch device of every stage's kernels, default ``cuda``)::

    {
      "ksize": 31,
      "outdir": "out",
      "device": "cuda",
      "reference": {"fasta": "refr.fa"},
      "contaminants": {"fasta": null},
      "case": {"fastx": ["proband.fq"], "label": "Case", "memory": "8M",
               "max_fpr": 0.6},
      "controls": [
        {"fastx": ["mother.fq"], "label": "Mother", "memory": "8M",
         "max_fpr": 0.05},
        {"fastx": ["father.fq"], "label": "Father", "memory": "8M",
         "max_fpr": 0.05}
      ],
      "mask": {"memory": "4M", "max_fpr": 0.01},
      "novel": {"case_min": 6, "ctrl_max": 1},
      "localize": {"seed_size": 51, "delta": 50},
      "varfilter": null,
      "simlike": {"mu": 30.0, "sigma": 8.0, "epsilon": 0.001},
      "profile": null
    }

``profile`` names a directory: the run is traced with ``torch.profiler``,
one ``workflow::<stage>`` span per stage around the stages' own spans
(:mod:`kevlar_tpu_torch.support`), and the chrome trace is written
there.  ``shards`` hash-shards every sample sketch over that many shards of
a mesh (:mod:`kevlar_tpu_torch.parallel`: every card of ``device``, or the
CPU standing in for each) and runs the counts, the novel screen and
simlike's queries over it, as in ``kevlar_tpu``.

    python -m kevlar_tpu_torch.workflow config.json
"""

import contextlib
import json
import os
import resource

import kevlar_tpu_torch
from kevlar_tpu_torch import support
from kevlar_tpu_torch.cli import memory_setting
from kevlar_tpu_torch.support import Timer


def _malloc_trim():
    """Return freed glibc arenas to the OS at stage boundaries: each
    stage's large transfer and save buffers are freed promptly, but glibc
    keeps the arenas resident."""
    try:
        import ctypes
        ctypes.CDLL('libc.so.6').malloc_trim(0)
    except Exception:
        pass


def _mem(value, default):
    if value is None:
        return default
    return memory_setting(value)


def run_mark1(config, logstream=None):
    """Run the full trio workflow; returns the final VCF path.
    ``logstream`` is accepted for ``kevlar_tpu``'s signature and unused, as
    there: diagnostics go to ``kevlar_tpu_torch.plog``."""
    from kevlar_tpu_torch import count as count_mod
    from kevlar_tpu_torch import novel as novel_mod
    from kevlar_tpu_torch import filter as filter_mod
    from kevlar_tpu_torch import partition as partition_mod
    from kevlar_tpu_torch import alac as alac_mod
    from kevlar_tpu_torch import varfilter as varfilter_mod
    from kevlar_tpu_torch import simlike as simlike_mod
    from kevlar_tpu_torch import seqio, sketch as sketch_mod, vcf as vcf_mod
    from kevlar_tpu_torch.batch import DEFAULT_BATCH_SIZE

    ksize = config.get('ksize', 31)
    outdir = config.get('outdir', '.')
    device = config.get('device', 'cuda')
    os.makedirs(outdir, exist_ok=True)

    def path(name):
        return os.path.join(outdir, name)

    timer = Timer()
    timer.start()
    refrfile = config['reference']['fasta']
    stage_marks = []
    # with the 'profile' config key (a trace directory) every stage is a
    # named range in the chrome trace, so device time attributes to
    # pipeline stages
    profile_dir = config.get('profile')
    profiler = None
    if profile_dir:
        import torch
        profiler = support.start_profile(
            profile_dir, torch.device(device).type == 'cuda')
        kevlar_tpu_torch.plog('[workflow] profiler trace ->', profile_dir)
    current = [contextlib.nullcontext()]

    def stage(msg):
        stage_marks.append((msg, timer.probe()))
        current[0].__exit__(None, None, None)
        current[0] = support.span('workflow::' + msg)
        current[0].__enter__()
        _malloc_trim()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        kevlar_tpu_torch.plog('[workflow] ({:.1f}s, rss {:.0f} MB) {}'.format(
            timer.probe(), rss, msg))

    # -- step 0: reference mask (1-bit) + reference counts (4-bit) --------
    stage('creating reference mask')
    maskmem = _mem(config.get('mask', {}).get('memory'), 4e6)
    maskfiles = [refrfile]
    contam = config.get('contaminants') or {}
    if contam.get('fasta'):
        maskfiles.append(contam['fasta'])
    mask = count_mod.load_sample_seqfile(
        maskfiles, ksize, maskmem,
        maxfpr=config.get('mask', {}).get('max_fpr', 0.01),
        count=False, outfile=path('mask.nt'), device=device,
        save_async=True)

    stage('counting reference genome k-mers')
    refr_counts = count_mod.load_sample_seqfile(
        [refrfile], ksize, maskmem, maxfpr=1.0, count=True, smallcount=True,
        outfile=path('refr.sct'), device=device, save_async=True)

    # -- step 1: per-sample masked counting -------------------------------
    # config key 'shards': hash-shard every sample sketch across that many
    # mesh devices and run counting + the novel screen over the mesh
    # (supersedes the reference's banding workflow)
    mesh = None
    sample_mask = mask
    if config.get('shards'):
        from kevlar_tpu_torch.parallel import ShardedSketch, make_mesh
        mesh = make_mesh(n_shard=int(config['shards']), device=device)
        stage('sharding sketches over mesh {}'.format(dict(mesh.shape)))
        sample_mask = ShardedSketch.from_sketch(mesh, mask)
    case_cfg = config['case']
    ctrl_cfgs = config.get('controls', [])
    stage('counting case sample')
    case_counts = count_mod.load_sample_seqfile(
        case_cfg['fastx'], ksize, _mem(case_cfg.get('memory'), 1e6),
        maxfpr=case_cfg.get('max_fpr', 0.6), mask=sample_mask,
        outfile=path('case.ct'), device=device, save_async=True, mesh=mesh)
    ctrl_counts = []
    for i, ctrl in enumerate(ctrl_cfgs):
        stage('counting control sample {}'.format(i))
        ctrl_counts.append(count_mod.load_sample_seqfile(
            ctrl['fastx'], ksize, _mem(ctrl.get('memory'), 1e6),
            maxfpr=ctrl.get('max_fpr', 0.05), mask=sample_mask,
            outfile=path('control{}.ct'.format(i)), device=device,
            save_async=True, mesh=mesh))

    # -- step 2: novel k-mer screen ---------------------------------------
    stage('novel k-mer screen')
    novel_cfg = config.get('novel', {})
    casemin = novel_cfg.get('case_min', 6)
    ctrlmax = novel_cfg.get('ctrl_max', 1)
    batchstream = novel_mod.native_read_batches(case_cfg['fastx'],
                                                DEFAULT_BATCH_SIZE)
    novelfile = path('novel.augfastq.gz')
    with kevlar_tpu_torch.open(novelfile, 'w') as fh:
        for textblock in novel_mod.novel(None, [case_counts], ctrl_counts,
                                         ksize=ksize, casemin=casemin,
                                         ctrlmax=ctrlmax,
                                         batchstream=batchstream,
                                         emit='text'):
            if textblock:
                fh.write(textblock)

    # -- step 3: filter (recount against the reference mask) --------------
    stage('filtering novel reads')
    filteredfile = path('filtered.augfastq.gz')
    with kevlar_tpu_torch.open(filteredfile, 'w') as fh:
        for record in filter_mod.filter(novelfile, mask=mask,
                                        casemin=casemin, ctrlmax=ctrlmax):
            kevlar_tpu_torch.print_augmented_fastx(record, fh)

    # -- step 4: partition -------------------------------------------------
    stage('partitioning reads')
    reader = kevlar_tpu_torch.parse_augmented_fastx(
        kevlar_tpu_torch.open(filteredfile, 'r'))
    partfile = path('partitioned.augfastq.gz')
    pstream = partition_mod.partition(reader, minabund=2, maxabund=200,
                                      device=device)
    with kevlar_tpu_torch.open(partfile, 'w') as fh:
        for partid, reads in pstream:
            for read in reads:
                kevlar_tpu_torch.print_augmented_fastx(read, fh)

    # -- step 5: assemble + localize + call (fused) ------------------------
    stage('assemble/localize/align/call')
    loc = config.get('localize', {})
    reader = kevlar_tpu_torch.parse_augmented_fastx(
        kevlar_tpu_torch.open(partfile, 'r'))
    pstream = seqio.parse_partitioned_reads(reader)
    prelimfile = path('calls.prelim.vcf')
    calls = alac_mod.alac(
        pstream, refrfile, ksize=ksize, threads=config.get('threads', 1),
        seedsize=loc.get('seed_size', 51), delta=loc.get('delta', 50),
        maskfile=path('callmask.nt'), device=device)
    with kevlar_tpu_torch.open(prelimfile, 'w') as fh:
        writer = vcf_mod.VCFWriter(fh, source='kevlar_tpu::workflow',
                                   refr=refrfile)
        writer.write_header()
        for call in calls:
            writer.write(call)

    # -- step 6: optional varfilter ----------------------------------------
    vcf_for_scoring = prelimfile
    if config.get('varfilter'):
        stage('applying user region filter')
        filtvcf = path('calls.filtered.vcf')
        reader = vcf_mod.vcfstream([prelimfile])
        beds = kevlar_tpu_torch.parse_bed(
            kevlar_tpu_torch.open(config['varfilter'], 'r'))
        with kevlar_tpu_torch.open(filtvcf, 'w') as fh:
            writer = vcf_mod.VCFWriter(fh, source='kevlar_tpu::workflow')
            writer.write_header()
            for call in varfilter_mod.varfilter(reader, beds):
                writer.write(call)
        vcf_for_scoring = filtvcf

    # -- step 7: likelihood scoring ----------------------------------------
    stage('scoring calls (simlike)')
    sim = config.get('simlike', {})
    labels = [case_cfg.get('label', 'Case')] + \
        [c.get('label', 'Control{}'.format(i))
         for i, c in enumerate(ctrl_cfgs)]
    # score from the on-disk checkpoints as host-backend mmaps (still in
    # the page cache): the live device sketches would answer the point
    # queries by pulling full-table host mirrors off the card.  Sharded
    # sketches stay on the mesh: simlike batches their queries.
    if mesh is None:
        for sk in [case_counts, refr_counts] + ctrl_counts:
            sketch_mod.join_save(sk)
        sl_case = sketch_mod.load(path('case.ct'), backend='host',
                                  cache=False)
        sl_ctrls = [sketch_mod.load(path('control{}.ct'.format(i)),
                                    backend='host', cache=False)
                    for i in range(len(ctrl_counts))]
        sl_refr = sketch_mod.load(path('refr.sct'), backend='host',
                                  cache=False)
    else:
        sl_case, sl_ctrls, sl_refr = case_counts, ctrl_counts, refr_counts
    finalfile = path('calls.scored.sorted.vcf.gz')
    reader = vcf_mod.vcfstream([vcf_for_scoring])
    with kevlar_tpu_torch.open(finalfile, 'w') as fh:
        writer = vcf_mod.VCFWriter(fh, source='kevlar_tpu::workflow')
        for label in labels:
            writer.register_sample(label)
        writer.write_header()
        for call in simlike_mod.simlike(
                reader, sl_case, sl_ctrls, sl_refr,
                mu=sim.get('mu', 30.0), sigma=sim.get('sigma', 8.0),
                epsilon=sim.get('epsilon', 0.001), casemin=casemin,
                ctrlmax=ctrlmax, samplelabels=labels):
            writer.write(call)

    # join the async checkpoint writers before declaring the run complete
    for sk in [mask, refr_counts, case_counts] + ctrl_counts:
        sketch_mod.join_save(sk)

    total = timer.stop()
    kevlar_tpu_torch.plog('[workflow] complete in {:.1f}s; final calls in'
                          .format(total), finalfile)
    stage_marks.append(('done', timer.probe()))
    current[0].__exit__(None, None, None)
    if profiler is not None:
        support.stop_profile(
            profiler, os.path.join(profile_dir, 'workflow.trace.json'))
    # per-stage wall deltas, exposed for benchmarking
    run_mark1.last_stage_times = [
        (label, round(stage_marks[i + 1][1] - t, 2))
        for i, (label, t) in enumerate(stage_marks[:-1])]
    return finalfile


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description='Run the full kevlar-tpu trio workflow from a JSON '
        'config (the mark-I pipeline) with kevlar_tpu_torch.')
    parser.add_argument('config', help='JSON workflow configuration')
    args = parser.parse_args(argv)
    with open(args.config) as fh:
        config = json.load(fh)
    run_mark1(config)


if __name__ == '__main__':
    main()
