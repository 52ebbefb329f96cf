"""Variant records, filters, and VCF 4.2 reading/writing.

The INFO/FORMAT/FILTER vocabulary and header descriptions are an exchange
contract shared with the reference implementation (kevlar/vcf.py:25-36,
262-424) and must stay byte-identical; the record model, merge procedure,
and reader/writer logic here are original. Positions are 0-based
internally and shifted +1 on write.
"""

from collections import defaultdict
from datetime import date
from enum import Enum

import numpy as np


class VariantAnnotationError(ValueError):
    pass


class KevlarMixedDataTypeError(ValueError):
    pass


class VariantFilter(Enum):
    PerfectMatch = 1
    InscrutableCigar = 2
    PassengerVariant = 3
    PartitionScore = 4
    LikelihoodFail = 5
    NumerousMismatches = 6
    UserFilter = 7
    ControlAbundance = 8
    CaseAbundance = 9
    Homopolymer = 10
    AmbiguousCall = 11


class FormattedList(list):
    """List that renders to VCF text: floats at 3 decimals, one homogeneous
    element type enforced, empty renders as '.'."""

    def __str__(self):
        kinds = {type(v) for v in self}
        if not kinds:
            return '.'
        if len(kinds) > 1:
            raise KevlarMixedDataTypeError(
                'mixed data type: ' +
                ','.join(sorted(str(k) for k in kinds)))
        kind = kinds.pop()
        if kind in (float, np.float64, np.float32):
            return ','.join('{:.3f}'.format(v) for v in self)
        return ','.join(str(v) for v in self)


class Variant:
    """A variant call or no-call: alleles + INFO annotations + per-sample
    FORMAT data + filter set."""

    def __init__(self, seqid, pos, refr, alt, **kwargs):
        self._seqid = seqid
        self._pos = pos
        self._refr = refr
        self._alt = alt
        self._filters = set()
        self.info = defaultdict(FormattedList)
        self._sample_data = defaultdict(dict)
        for key, value in kwargs.items():
            self.annotate(key, value)

    # -- annotation surface -------------------------------------------------

    def annotate(self, key, value, replace=True):
        if replace:
            self.info[key] = FormattedList([value])
        else:
            self.info[key].append(value)

    def attribute(self, key, pair=False, string=False):
        if key not in self.info:
            return None
        values = self.info[key]
        if pair:
            return '{:s}={:s}'.format(key, str(values))
        if string:
            return str(values)
        return values[0] if len(values) == 1 else values

    def format(self, sample, key, value_to_store=None):
        if value_to_store is None:
            if sample not in self._sample_data:
                return None
            return self._sample_data[sample].get(key)
        self._sample_data[sample][key] = value_to_store

    def filter(self, filtertype):
        if isinstance(filtertype, VariantFilter):
            self._filters.add(filtertype)

    def unfilter(self, filtertype):
        """Rescind a previously applied filter (likelihood-gated
        heuristic overrides; see simlike caseabundgate)."""
        self._filters.discard(filtertype)

    @property
    def filters(self):
        return frozenset(self._filters)

    # -- views --------------------------------------------------------------

    @property
    def seqid(self):
        return self._seqid

    @property
    def position(self):
        return self._pos

    @property
    def region(self):
        return self._seqid, self._pos, self._pos + len(self._refr)

    @property
    def cigar(self):
        return self.attribute('CIGAR')

    @property
    def window(self):
        """Contig interval spanning all k-mers overlapping the alt allele."""
        return self.attribute('ALTWINDOW')

    @property
    def refrwindow(self):
        return self.attribute('REFRWINDOW')

    @property
    def windowlength(self):
        window = self.window
        return len(window) if window is not None else 0

    @property
    def genotypes(self):
        gt = self.attribute('GT')
        return tuple(gt.split(',')) if gt else None

    @property
    def filterstr(self):
        if self._filters:
            return ';'.join(sorted(vf.name for vf in self._filters))
        return 'PASS' if self._refr != '.' else '.'

    def __str__(self):
        if len(self._refr) == 1 == len(self._alt):
            return '{:s}:{:d}:{:s}->{:s}'.format(
                self._seqid, self._pos, self._refr, self._alt)
        shift = self._pos + 1
        if len(self._refr) > len(self._alt):
            return '{:s}:{:d}:{:d}D'.format(
                self._seqid, shift, len(self._refr) - len(self._alt))
        return '{:s}:{:d}:I->{:s}'.format(self._seqid, shift, self._alt[1:])

    @property
    def vcf(self):
        """One VCF body row (through the INFO column). CONTIG sorts last so
        the long sequence doesn't bury the scalar annotations."""
        info = '.'
        if self.info:
            ordered = sorted(self.info, key=lambda k: (k == 'CONTIG', k))
            info = ';'.join(self.attribute(k, pair=True) for k in ordered)
        pos = self._pos if self._pos == '.' else self._pos + 1
        return '{:s}\t{}\t.\t{:s}\t{:s}\t.\t{:s}\t{:s}'.format(
            self._seqid, pos, self._refr, self._alt, self.filterstr, info)

    # -- MNV merging ----------------------------------------------------------

    def test_merge(self, other):
        """Absorb an immediately adjacent compatible SNV/MNV into this one
        (in place); returns self on success, None otherwise."""
        span = len(self._refr)
        mergeable = (
            self._seqid != '.' and
            self._seqid == other._seqid and
            len(self._alt) == span and
            len(other._alt) == len(other._refr) and
            self._pos + span == other._pos and
            None not in (self.window, other.window,
                         self.refrwindow, other.refrwindow) and
            self.window[span:] == other.window[:-1] and
            self.refrwindow[span:] == other.refrwindow[:-1]
        )
        if not mergeable:
            return None
        self.annotate('ALTWINDOW', self.window + other.window[-span])
        self.annotate('REFRWINDOW', self.refrwindow + other.refrwindow[-span])
        self._refr += other._refr
        self._alt += other._alt
        return self


class VCFWriter:
    filter_desc = {
        VariantFilter.PerfectMatch:
            'No mismatches between contig with putatively novel content and '
            'reference target',
        VariantFilter.InscrutableCigar:
            'Alignment path/structure cannot be interpreted as a variant',
        VariantFilter.PassengerVariant:
            'A mismatch between contig and reference that is not spanned by '
            'any novel k-mers',
        VariantFilter.PartitionScore:
            'Expectation is 1 variant call per partition, so all call(s) with '
            'suboptimal likelihood scores are filtered',
        VariantFilter.LikelihoodFail:
            'Variant calls with a likelihood score < 0.0 are unlikely to be'
            'real',
        VariantFilter.NumerousMismatches:
            'No attempt at variant calling was made due to a suspicious '
            'number of mismatches between the contig and the reference genome',
        VariantFilter.UserFilter:
            'The user has explicitly filtered this variant out due to overlap '
            'with problematic/undesired loci or variants.',
        VariantFilter.ControlAbundance:
            'Too many variant-spanning k-mers have high abundance in one or '
            'more control samples.',
        VariantFilter.CaseAbundance:
            'Too many consecutive variant-spanning k-mers have low abundance '
            'in the case/proband sample.',
        VariantFilter.Homopolymer:
            'Indels associate with homopolymers are most often spurious and '
            'very difficult to verify with confidence.',
        VariantFilter.AmbiguousCall:
            'Derived from a contig with too many distinct, equally optimal '
            'variant calls.',
    }

    info_metadata = {
        'ALTWINDOW': (
            'String', '1', 'window containing all k-mers that span the '
            'variant alternate allele'),
        'CIGAR': ('String', '1', 'alignment path'),
        'IKMERS': (
            'Integer', '1', 'number of "interesting" (novel) k-mers spanning '
            'the variant alternate allele'),
        'KSW2': ('Float', '1', 'alignment score'),
        'REFRWINDOW': (
            'String', '1', 'window containing all k-mers that span the '
            'variant reference allele'),
        'REFRCOPYNUM': (
            'Integer', '.', 'number of times each reference allele k-mer '
            'occurs in the reference genome'),
        'CONTIG': (
            'String', '1', 'contig assembled from reads containing novel '
            'k-mers, aligned to reference to call variants'),
        'LIKESCORE': (
            'Float', '1', 'likelihood score of the variant, computed as '
            '`LLDN - max(LLIH, LLFP)`'),
        'LLDN': (
            'Float', '1', 'log likelihood that the variant is a de novo '
            'variant'),
        'LLIH': (
            'Float', '1', 'log likelihood that the variant is an inherited '
            'variant'),
        'LLFP': ('Float', '1', 'log likelihood that the variant is a false '
                 'call'),
        'DROPPED': (
            'Integer', '1', 'number of k-mers dropped from ALTWINDOW for '
            'likelihood calculations because it is present elsewhere in the '
            'genome (not novel)'),
    }

    format_metadata = {
        'ALTABUND': ('Integer', '.', 'abundance of alternate allele k-mers'),
    }

    def __init__(self, outstream, source='kevlar', refr=None):
        self._out = outstream
        self._sample_labels = []
        self._source = source
        self._refr = refr

    def register_sample(self, label):
        self._sample_labels.append(label)

    def register_samples_from_reader(self, reader):
        for label in reader._sample_labels:
            self.register_sample(label)

    def describe_format(self, label, datatype, datanumber, desc):
        self.format_metadata[label] = (datatype, datanumber, desc)

    def write_header(self, skipdate=False):
        out = self._out
        print('##fileformat=VCFv4.2', file=out)
        if not skipdate:
            print('##fileDate=' + date.today().isoformat(), file=out)
        if self._source:
            print('##source=' + self._source, file=out)
        if self._refr:
            print('##reference=' + self._refr, file=out)
        for filt in VariantFilter:
            print('##FILTER=<ID={},Description="{}">'.format(
                filt.name, self.filter_desc[filt]), file=out)
        for label, (dtype, num, desc) in self.info_metadata.items():
            print('##INFO=<ID={},Number={},Type={},Description="{}">'.format(
                label, num, dtype, desc), file=out)
        for label, (dtype, num, desc) in self.format_metadata.items():
            print('##FORMAT=<ID={},Number={},Type={},Description="{}">'
                  .format(label, num, dtype, desc), file=out)
        columns = ['CHROM', 'POS', 'ID', 'REF', 'ALT', 'QUAL', 'FILTER',
                   'INFO']
        if self._sample_labels:
            columns += ['FORMAT'] + self._sample_labels
        print('#' + '\t'.join(columns), file=out)

    def _sample_columns(self, variant):
        """(FORMAT string, per-sample value columns); every sample must
        carry the same FORMAT fields."""
        formatstr = None
        columns = []
        for sample in self._sample_labels:
            present = [(field, variant.format(sample, field))
                       for field in sorted(self.format_metadata)]
            present = [(f, v) for f, v in present if v]
            fstr = ':'.join(f for f, _ in present)
            if formatstr is None:
                formatstr = fstr
            elif formatstr != fstr:
                raise VariantAnnotationError(
                    'samples not annotated with the same FORMAT fields '
                    '({:s} vs {:s})'.format(formatstr, fstr))
            columns.append(':'.join(v for _, v in present))
        return formatstr, columns

    def write(self, variant):
        row = variant.vcf
        if self._sample_labels:
            formatstr, columns = self._sample_columns(variant)
            row = '\t'.join([row, formatstr] + columns)
        print(row, file=self._out)


class VCFReader:
    def __init__(self, instream):
        self._in = instream
        self._sample_labels = []
        self.suppress_filter_warnings = False

    def _parse_filters(self, variant, filterstr):
        import kevlar_tpu_torch
        if filterstr in ('.', 'PASS'):
            return
        for label in filterstr.split(';'):
            if hasattr(VariantFilter, label):
                variant.filter(VariantFilter[label])
            elif not self.suppress_filter_warnings:
                kevlar_tpu_torch.plog(
                    '[kevlar::vcf]',
                    'filter "{}" not recognized; attempting to write this '
                    'variant to VCF will probably turn out poorly'.format(
                        filterstr))

    def _parse_samples(self, variant, fmtcol, samplecols, line):
        keys = fmtcol.split(':')
        if self._sample_labels and \
                len(samplecols) != len(self._sample_labels):
            raise VariantAnnotationError('sample number mismatch: ' + line)
        for label, data in zip(self._sample_labels, samplecols):
            if data in ('.', './.'):
                continue
            values = data.split(':')
            if len(keys) != len(values):
                raise VariantAnnotationError('format data mismatch: ' + line)
            for key, value in zip(keys, values):
                variant.format(label, key, value)

    def _parse_row(self, line):
        fields = line.strip().split('\t')
        pos = '.' if fields[1] == '.' else int(fields[1]) - 1
        variant = Variant(fields[0], pos, fields[3], fields[4])
        for kvp in fields[7].split(';'):
            if '=' in kvp:
                key, values = kvp.split('=')
                for value in values.split(','):
                    variant.annotate(key, value)
            else:
                variant.annotate(kvp, True)
        self._parse_filters(variant, fields[6])
        if len(fields) > 9:
            self._parse_samples(variant, fields[8], fields[9:], line)
        return variant

    def __iter__(self):
        import kevlar_tpu_torch
        for line in self._in:
            if line.startswith('#CHROM\t'):
                columns = line.strip().split('\t')
                assert len(columns) >= 8
                if len(columns) > 8:
                    self._sample_labels = columns[9:]
                break
            if not line.startswith('#'):
                kevlar_tpu_torch.plog(
                    '[kevlar::vcf]',
                    'WARNING: VCF file has no samples annotated, certain '
                    'sanity checks disabled')
                yield self._parse_row(line)
                break
        for line in self._in:
            if not line.startswith('#'):
                yield self._parse_row(line)


def vcfstream(filelist):
    import kevlar_tpu_torch
    for infile in filelist:
        yield from VCFReader(kevlar_tpu_torch.open(infile, 'r'))
