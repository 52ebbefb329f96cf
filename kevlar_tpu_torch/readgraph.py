"""Read graph: reads as nodes, shared interesting k-mers as connectivity.

Port of ``kevlar_tpu.readgraph``.  Replaces the reference's networkx.Graph
subclass (kevlar/readgraph.py) with a plain dict-based graph whose
connected components come from :mod:`kevlar_tpu_torch.ops.cc_ops` over the
read<->k-mer bipartite incidence, on the graph's ``device`` at or above
the host union-find's threshold — no pairwise edge materialisation in
relaxed mode.

Semantics preserved: per-k-mer read sets with min/max abundance filtering
(CLI defaults 2/200); relaxed mode connects any two reads sharing a k-mer;
strict mode only connects reads whose overlap (anchored by the shared
k-mer) is a perfect match, verified by
:class:`kevlar_tpu_torch.readpair.ReadPair`; components are ordered by
(size, sorted names) descending; PCR duplicates are removed per-partition
by canonical sequence.
"""

from collections import defaultdict

import numpy as np

import kevlar_tpu_torch
from kevlar_tpu_torch.ops import cc_ops


class ReadGraph:

    def __init__(self, device='cuda'):
        self.device = device     # where large components propagate
        self.nodes = {}          # name -> record
        self.ikmers = defaultdict(set)   # canonical kmer seq -> set of names
        self.readnames = set()
        self.edges = {}          # name -> {name: attrs} (strict mode only)
        self._strict = False
        self._populated = False

    # -- container protocol (parity with networkx usage) -----------------
    def __iter__(self):
        return iter(self.nodes)

    def __contains__(self, name):
        return name in self.nodes

    def __getitem__(self, name):
        return self.edges.get(name, {})

    def number_of_nodes(self):
        return len(self.nodes)

    def number_of_edges(self):
        """Strict mode counts the materialised validated edges; relaxed
        mode derives the shared-k-mer pair count from the bipartite
        incidence on demand (the components never need the pairs, so they
        are not stored — but the count is the reference's observable graph
        surface and matches it exactly)."""
        if self._strict or not self._populated:
            return sum(len(v) for v in self.edges.values()) // 2
        from itertools import combinations
        pairs = set()
        for readset in self.ikmers.values():
            for pair in combinations(sorted(readset), 2):
                pairs.add(pair)
        return len(pairs)

    def add_node(self, name, record=None):
        self.nodes[name] = record

    def add_edge(self, n1, n2, **attrs):
        self.edges.setdefault(n1, {})[n2] = attrs
        self.edges.setdefault(n2, {})[n1] = attrs

    def get_record(self, recordname):
        return self.nodes[recordname]

    # -- construction -----------------------------------------------------
    def load(self, readstream, minabund=None, maxabund=None, dedup=False):
        """Load reads + interesting k-mers, with optional abundance filter
        on the number of reads sharing each k-mer and optional PCR-duplicate
        removal by canonical read sequence."""
        temp_ikmers = defaultdict(set)
        unique_reads = set()
        for record in readstream:
            if dedup:
                minread = kevlar_tpu_torch.revcommin(record.sequence)
                if minread in unique_reads:
                    continue
                unique_reads.add(minread)
            self.add_node(record.name, record=record)
            self.readnames.add(record.name)
            for kmer in record.annotations:
                kmerseq = kevlar_tpu_torch.revcommin(record.ikmerseq(kmer))
                temp_ikmers[kmerseq].add(record.name)

        if minabund is None and maxabund is None:
            self.ikmers = temp_ikmers
        else:
            for kmer, readset in temp_ikmers.items():
                abund = len(readset)
                minfail = minabund and abund < minabund
                maxfail = maxabund and abund > maxabund
                if not minfail and not maxfail:
                    self.ikmers[kmer] = readset

    def check_edge(self, pair, minkmer):
        tailname, headname = pair.tail.name, pair.head.name
        if tailname in self.edges and headname in self.edges[tailname]:
            attrs = self.edges[tailname][headname]
            assert attrs['offset'] == pair.offset
            if attrs['tail'] == tailname:
                assert attrs['overlap'] == pair.overlap
            attrs['ikmers'].add(minkmer)
        else:
            self.add_edge(tailname, headname, offset=pair.offset,
                          overlap=pair.overlap, ikmers=set([minkmer]),
                          orient=pair.sameorient, tail=tailname)

    def populate_edges(self, strict=False):
        """Strict mode materialises validated pairwise edges; relaxed mode
        needs none (components come straight from the bipartite incidence)."""
        self._strict = strict
        self._populated = True
        if not strict:
            return
        from itertools import combinations
        from kevlar_tpu_torch.readpair import ReadPair
        for kmer, readset in self.ikmers.items():
            for read1, read2 in combinations(sorted(readset), 2):
                if read1 in self.edges and read2 in self.edges[read1]:
                    continue
                pair = ReadPair(self.get_record(read1),
                                self.get_record(read2), kmer)
                if pair.incompatible:
                    continue
                self.check_edge(pair, kmer)

    # -- components -------------------------------------------------------
    def _component_sets(self):
        names = sorted(self.nodes)
        index = {name: i for i, name in enumerate(names)}
        read_ids, hyper_ids = [], []
        if self._strict:
            eid = 0
            seen = set()
            for n1, nbrs in self.edges.items():
                for n2 in nbrs:
                    key = (min(n1, n2), max(n1, n2))
                    if key in seen:
                        continue
                    seen.add(key)
                    read_ids += [index[n1], index[n2]]
                    hyper_ids += [eid, eid]
                    eid += 1
            n_hyper = eid
        else:
            for eid, (kmer, readset) in enumerate(sorted(self.ikmers.items())):
                for name in readset:
                    read_ids.append(index[name])
                    hyper_ids.append(eid)
            n_hyper = len(self.ikmers)

        if not read_ids:
            return [{name} for name in names]
        labels = np.asarray(cc_ops.connected_components(
            np.array(read_ids, dtype=np.int32),
            np.array(hyper_ids, dtype=np.int32),
            len(names), max(n_hyper, 1), device=self.device))
        comps = defaultdict(set)
        for i, name in enumerate(names):
            comps[int(labels[i])].add(name)
        return list(comps.values())

    def connected_components(self):
        return self._component_sets()

    def full_cc(self, cc):
        sg = ReadGraph(self.device)
        for name in cc:
            sg.add_node(name, self.nodes[name])
            sg.readnames.add(name)
        sg.ikmers = self.ikmers
        return sg

    def partitions(self, dedup=True, minabund=None, maxabund=None,
                   abundfilt=False):
        """Yield partitions (connected components), largest first."""
        comps = sorted(self._component_sets(), reverse=True,
                       key=lambda c: (len(c), sorted(c)))
        for cc in comps:
            if len(cc) == 1 and next(iter(cc)) in self.readnames:
                continue  # skip unconnected input reads
            if dedup:
                partition = ReadGraph(self.device)
                readstream = [self.get_record(n) for n in sorted(cc)]
                partition.load(readstream, minabund, maxabund, dedup=True)
                assert partition.number_of_nodes() > 0
                if abundfilt and minabund \
                        and partition.number_of_nodes() < minabund:
                    continue
                yield partition
            else:
                yield cc


def to_gml(graph, outfilename, logstream=None):
    """Write the read graph to GML (simple hand-rolled serialiser)."""
    with open(outfilename, 'w') as fh:
        fh.write('graph [\n')
        index = {}
        for i, name in enumerate(sorted(graph.nodes)):
            index[name] = i
            fh.write('  node [ id {} label "{}" ]\n'.format(i, name))
        seen = set()
        for n1, nbrs in graph.edges.items():
            for n2 in nbrs:
                key = (min(n1, n2), max(n1, n2))
                if key in seen:
                    continue
                seen.add(key)
                fh.write('  edge [ source {} target {} ]\n'.format(
                    index[n1], index[n2]))
        fh.write(']\n')
