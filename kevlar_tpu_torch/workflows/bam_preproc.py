"""BAM preprocessing driver: BAM -> FASTQ -> QC -> error correction.

The reference ships this as a Snakemake workflow
(reference kevlar/workflows/bam-preproc/Snakefile) shelling out to
samtools, fastp, and lighter.  Those tools are external there and remain
external here; this driver orchestrates them in-process, with clear errors
when a tool is missing.  Output: error-corrected FASTQ ready for
``kevlar_tpu_torch count``.

Usage::

    python -m kevlar_tpu_torch.workflows.bam_preproc sample.bam out_prefix \
        --genome-size 3200000000 [--threads 8]
"""

import argparse
import os
import shutil
import subprocess
import sys

import kevlar_tpu_torch


class MissingToolError(RuntimeError):
    pass


def _require(tool):
    path = shutil.which(tool)
    if path is None:
        raise MissingToolError(
            '"{}" not found on PATH; install it or supply pre-converted '
            'FASTQ input to `kevlar_tpu_torch count` directly'.format(tool))
    return path


def bam_to_fastq(bamfile, outprefix, threads=1):
    _require('samtools')
    r1 = outprefix + '.R1.fq.gz'
    r2 = outprefix + '.R2.fq.gz'
    kevlar_tpu_torch.plog('[bam-preproc] BAM -> FASTQ')
    sort_cmd = ['samtools', 'sort', '-n', '-@', str(threads), bamfile,
                '-o', outprefix + '.namesorted.bam']
    subprocess.check_call(sort_cmd)
    fq_cmd = ['samtools', 'fastq', '-@', str(threads),
              '-1', r1, '-2', r2, '-0', '/dev/null', '-s', '/dev/null',
              '-n', outprefix + '.namesorted.bam']
    subprocess.check_call(fq_cmd)
    os.unlink(outprefix + '.namesorted.bam')
    return r1, r2


def quality_control(r1, r2, outprefix, threads=1):
    _require('fastp')
    o1 = outprefix + '.qc.R1.fq.gz'
    o2 = outprefix + '.qc.R2.fq.gz'
    kevlar_tpu_torch.plog('[bam-preproc] fastp QC')
    cmd = ['fastp', '-i', r1, '-I', r2, '-o', o1, '-O', o2,
           '--thread', str(threads),
           '--json', outprefix + '.fastp.json',
           '--html', outprefix + '.fastp.html']
    subprocess.check_call(cmd)
    return o1, o2


def error_correction(r1, r2, outprefix, genome_size, threads=1, kmer=23):
    _require('lighter')
    outdir = outprefix + '.corrected'
    os.makedirs(outdir, exist_ok=True)
    kevlar_tpu_torch.plog('[bam-preproc] lighter error correction')
    cmd = ['lighter', '-r', r1, '-r', r2, '-K', str(kmer), str(genome_size),
           '-od', outdir, '-t', str(threads)]
    subprocess.check_call(cmd)
    outs = sorted(
        os.path.join(outdir, f) for f in os.listdir(outdir)
        if f.endswith(('.fq', '.fq.gz', '.fastq', '.fastq.gz')))
    return outs


def run(bamfile, outprefix, genome_size, threads=1, skip_qc=False,
        skip_correction=False):
    r1, r2 = bam_to_fastq(bamfile, outprefix, threads)
    if not skip_qc:
        r1, r2 = quality_control(r1, r2, outprefix, threads)
    if skip_correction:
        return [r1, r2]
    return error_correction(r1, r2, outprefix, genome_size, threads)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='BAM -> corrected FASTQ preprocessing '
                    '(samtools + fastp + lighter)')
    parser.add_argument('bam', help='input BAM file')
    parser.add_argument('outprefix', help='prefix for output files')
    parser.add_argument('--genome-size', type=float, required=True,
                        help='approximate genome size for error correction')
    parser.add_argument('-t', '--threads', type=int, default=1)
    parser.add_argument('--skip-qc', action='store_true')
    parser.add_argument('--skip-correction', action='store_true')
    args = parser.parse_args(argv)
    try:
        outs = run(args.bam, args.outprefix, int(args.genome_size),
                   args.threads, args.skip_qc, args.skip_correction)
    except MissingToolError as err:
        print('[bam-preproc] ERROR:', err, file=sys.stderr)
        sys.exit(1)
    print('\n'.join(outs))


if __name__ == '__main__':
    main()
