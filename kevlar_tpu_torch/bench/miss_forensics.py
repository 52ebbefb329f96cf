"""Per-miss forensics for a bigsim run: each false negative classified by
the pipeline stage that lost it; the port's counterpart of
``tools/miss_forensics.py``.  Host only: it reads the files that
``kevlar_tpu_torch.bench.bigsim`` leaves in its work directory.

Every de novo truth variant carries ALT and REFR windows (gentrio writes
them), so the variant's *signature k-mers* (canonical k-mers in the ALT
window and not in the REFR window) can be traced through each checkpoint
of a run:

  novel.augfastq       annotated interesting k-mers after the case/ctrl
                       abundance screen
  filtered.augfastq    after the exact-recount filter
  partitioned.augfastq after partitioning (+ which kvcc partition)
  calls.vcf            raw alac calls near the variant (+ FILTER)
  scored.vcf           simlike-scored calls (+ FILTER, LIKESCORE)

Each miss is assigned the FIRST stage where its signal disappears:

  no-signature   the ALT window has no k-mer the REFR window lacks
  novel-screen   no signature k-mer survives the abundance screen
  filter         signature present at novel, gone after recount
  partition      present after filter, dropped/diluted by partitioning
  asm-call       partition holds the signature but alac emitted no call
                 within the match window (assembly break, localization
                 or alignment failure)
  call-filter    alac called it but filtered (PassengerVariant etc.)
  likelihood     PASS call exists in calls.vcf but simlike/varfilter
                 killed it (FILTER != PASS or LIKESCORE <= 0)
  position       a PASS scored call exists but landed outside the
                 +/-delta match window (coordinate error)
  shadowed       its matching call was consumed by another truth variant
                 (CALLCLASS compaction / first-match-wins collision)

Usage:  python -m kevlar_tpu_torch.bench.miss_forensics WORKDIR
        [--delta 10] [--k 31] [--out PATH]

Writes its JSON only where ``--out`` says.
"""

import argparse
import json
import os
import sys

from kevlar_tpu_torch.bench.bigsim import (classify,
                                           evaluate_reference_protocol,
                                           read_pass_calls)

COMP = str.maketrans('ACGT', 'TGCA')


def revcomp(s):
    return s.translate(COMP)[::-1]


def canon(kmer):
    rc = revcomp(kmer)
    return kmer if kmer <= rc else rc


def kmers(seq, k):
    return {canon(seq[i:i + k]) for i in range(len(seq) - k + 1)
            if 'N' not in seq[i:i + k]}


def load_truth_vcf(path, k):
    """De novo rows of a gentrio truth VCF with signature k-mers."""
    rows = []
    with open(path) as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.rstrip('\n').split('\t')
            info = dict(kv.split('=', 1) for kv in f[7].split(';')
                        if '=' in kv)
            gt = info['GT'].split(',')
            if not (gt[0] in ('0/1', '1/0', '1/1')
                    and all(p == '0/0' for p in gt[1:])):
                continue
            ref, alt = f[3], f[4]
            if len(ref) == 1 == len(alt):
                vartype, size = 'SNV', 0
            elif len(alt) > len(ref):
                vartype, size = 'INDEL', len(alt) - len(ref)
            else:
                vartype, size = 'INDEL', len(ref) - len(alt)
            sig = kmers(info['ALTWINDOW'], k) - kmers(info['REFRWINDOW'], k)
            rows.append(dict(pos=int(f[1]) - 1, type=vartype, size=size,
                             ref_len=len(ref), alt_len=len(alt),
                             cls=classify(vartype, size), sig=sig))
    return rows


def annotated_kmers(augfastq, with_partition=False):
    """Set of canonical interesting k-mers annotated in an augfastx file;
    with_partition also returns {kmer: set(kvcc labels)}."""
    ks = set()
    parts = {}
    kvcc = None
    with open(augfastq) as fh:
        for line in fh:
            if line.startswith(' '):
                kmer = canon(line.split(None, 1)[0])
                ks.add(kmer)
                if with_partition and kvcc is not None:
                    parts.setdefault(kmer, set()).add(kvcc)
            elif line.startswith('@') or line.startswith('>'):
                kvcc = None
                if 'kvcc=' in line:
                    kvcc = int(line.split('kvcc=')[1].split()[0])
    return (ks, parts) if with_partition else ks


def read_all_calls(vcfpath):
    """ALL rows (any FILTER) as dicts."""
    calls = []
    with open(vcfpath) as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.rstrip('\n').split('\t')
            if f[1] == '.':
                calls.append(dict(pos=None, filt=f[6], info=f[7]))
                continue
            info = dict(kv.split('=', 1) for kv in f[7].split(';')
                        if '=' in kv)
            calls.append(dict(
                pos=int(f[1]) - 1, ref=f[3], alt=f[4], filt=f[6],
                like=float(info['LIKESCORE']) if 'LIKESCORE' in info
                else None,
                callclass=info.get('CALLCLASS')))
    return calls


def near(call_pos, var, delta):
    """Call-near-variant predicate, generous: the alac call for an indel
    can sit anywhere within the event span."""
    if call_pos is None:
        return False
    lo = var['pos'] - delta
    hi = var['pos'] + max(1, var['size']) + delta
    return lo <= call_pos <= hi


def main(argv=None):
    """Classify every miss of the run in WORKDIR; returns the whole
    record, its rows included."""
    ap = argparse.ArgumentParser(
        description='classify each false negative of a bigsim run by the '
        'stage that lost it')
    ap.add_argument('workdir')
    ap.add_argument('--delta', type=int, default=10)
    ap.add_argument('--k', type=int, default=31)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    wd = args.workdir

    truth = load_truth_vcf(os.path.join(wd, 'truth.vcf'), args.k)
    print('# truth: %d de novo variants' % len(truth), file=sys.stderr)

    # which are missed, under the reference protocol scorer
    trt = [(v['pos'], v['type'], v['size']) for v in truth]
    calls = read_pass_calls(os.path.join(wd, 'scored.vcf'))
    ev = evaluate_reference_protocol(trt, calls, delta=args.delta)

    # the matched set (the scorer does not return it): its loop again,
    # with the same semantics
    def hits(pos):
        return [i for i, (p, _, _) in enumerate(trt)
                if pos - args.delta <= p < pos + args.delta]
    by_class, compacted = {}, []
    for call in calls:
        if call[2] is None:
            compacted.append(call)
        else:
            by_class.setdefault(call[2], []).append(call)
    for calllist in by_class.values():
        match = next((c for c in calllist if hits(c[0])), None)
        compacted.append(match if match is not None else calllist[0])
    compacted.sort(key=lambda c: -c[1])
    compacted = [c for c in compacted if c[1] > 0.0]
    found = set()
    for pos, like, callclass, span in compacted:
        for i in hits(pos):
            found.add(i)
    misses = [i for i in range(len(truth)) if i not in found]
    assert len(found) == ev['tp'], (len(found), ev['tp'])
    print('# misses: %d (recall %.4f)' % (len(misses), ev['recall']),
          file=sys.stderr)

    print('# loading stage k-mer sets...', file=sys.stderr)
    novel_k = annotated_kmers(os.path.join(wd, 'novel.augfastq'))
    filt_k = annotated_kmers(os.path.join(wd, 'filtered.augfastq'))
    part_k, part_of = annotated_kmers(
        os.path.join(wd, 'partitioned.augfastq'), with_partition=True)
    print('# kmers: novel=%d filtered=%d partitioned=%d' %
          (len(novel_k), len(filt_k), len(part_k)), file=sys.stderr)
    raw_calls = read_all_calls(os.path.join(wd, 'calls.vcf'))
    scored = read_all_calls(os.path.join(wd, 'scored.vcf'))

    rows = []
    for i in misses:
        v = truth[i]
        sig = v['sig']
        n_nov = len(sig & novel_k)
        n_fil = len(sig & filt_k)
        n_par = len(sig & part_k)
        parts = sorted(set().union(*(part_of.get(km, set())
                                     for km in sig & part_k)) or set())
        near_raw = [c for c in raw_calls if near(c['pos'], v, 100)]
        near_sc = [c for c in scored if near(c['pos'], v, 100)]
        pass_raw = [c for c in near_raw if c['filt'] == 'PASS']
        pass_sc = [c for c in near_sc if c['filt'] == 'PASS'
                   and (c['like'] or 0) > 0]
        # matched-window scored PASS calls (the strict criterion)
        win_sc = [c for c in pass_sc
                  if hits(c['pos']) and i in hits(c['pos'])]

        if not sig:
            stage = 'no-signature'      # SNV whose windows share all kmers
        elif n_nov == 0:
            stage = 'novel-screen'
        elif n_fil == 0:
            stage = 'filter'
        elif n_par == 0:
            stage = 'partition'
        elif not near_raw:
            stage = 'asm-call'
        elif not pass_raw:
            stage = 'call-filter'
        elif not pass_sc:
            stage = 'likelihood'
        elif not win_sc:
            stage = 'position'
        else:
            stage = 'shadowed'
        rows.append(dict(
            pos=v['pos'], cls=v['cls'], size=v['size'],
            indel=('INS' if v['alt_len'] > v['ref_len'] else
                   'DEL' if v['ref_len'] > v['alt_len'] else 'SNV'),
            sig_total=len(sig), sig_novel=n_nov, sig_filtered=n_fil,
            sig_partitioned=n_par, partitions=parts[:6],
            calls_near=[(c['pos'], c['filt'], c['like'])
                        for c in near_sc][:6],
            stage=stage))

    by_stage = {}
    by_cls_stage = {}
    for r in rows:
        by_stage[r['stage']] = by_stage.get(r['stage'], 0) + 1
        key = '%s|%s' % (r['cls'], r['stage'])
        by_cls_stage[key] = by_cls_stage.get(key, 0) + 1
    out = dict(workdir=wd, delta=args.delta, k=args.k,
               n_truth=len(truth), n_miss=len(misses),
               by_stage=dict(sorted(by_stage.items(),
                                    key=lambda kv: -kv[1])),
               by_class_stage=dict(sorted(by_cls_stage.items())),
               misses=rows)
    print(json.dumps(dict(out, misses='[%d rows]' % len(rows)), indent=1))
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(out, fh, indent=1)
        print('# wrote', args.out, file=sys.stderr)
    return out


if __name__ == '__main__':
    main()
