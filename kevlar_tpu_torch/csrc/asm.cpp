// Native assembler for partitioned read sets: spectral error correction +
// an exact-overlap string graph with fermi-lite-class cleaning.
//
// The kevlar-tpu equivalent of the reference's fermi-lite bridge
// (reference kevlar/assembly.pyx -> fml_assemble).  fermi-lite runs
// BFC error correction, an FMD-index overlap graph, and unitig cleaning
// (tip trimming mag.c:403, bubble popping bubble.c:256/358).  This is an
// independent implementation of the same pipeline semantics on a
// hash-anchored string graph (partitions are <= 10000 reads, typically
// dozens, so an FM-index is unnecessary):
//
//  0. spectral correction: count the partition's canonical k-mers;
//     substitution errors show up as maximal runs of weak (count < 2)
//     k-mer windows flanked by solid ones, and are repaired by the unique
//     base substitution that turns the whole run solid (conservative:
//     anchored runs only, never introduces a k-mer that is not already
//     solid in the partition) — the BFC analog;
//  1. exact suffix-prefix overlaps >= min_ovl between corrected reads,
//     found through a packed 32-mer anchor index (both strands); contained
//     and duplicate reads are dropped (as the reference's FMD construction
//     does);
//  2. transitive reduction (composite overlaps removed), then unambiguous
//     chain merging into unitigs carrying per-base depth and a supporting
//     read count (nsr);
//  3. graph cleaning with the reference pipeline's thresholds and pass
//     order: progressive tip removal (len < 2.5x mean read length and
//     nsr below a coverage-scaled floor), weak-edge removal (overlap
//     < 0.7x the strongest at that end), open-bubble popping (a short
//     dead-end whose overhang aligns to a sibling branch is dropped),
//     and simple-bubble popping (parallel paths between the same
//     endpoints collapse onto the deeper path only when the weaker side
//     is shallow and lopsided — heterozygous bubbles with balanced depth
//     are preserved as separate contigs).
//
// C ABI:
//   int kt_assemble(const char** reads, int nreads, int min_overlap,
//                   char* out, int out_cap);
//     returns #contigs; contigs are nul-separated in `out`.
//   int kt_correct(const char** reads, int nreads, int k, int minabund,
//                  char* out, int out_cap);
//     spectral correction alone (nul-separated corrected reads).

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <array>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

int base_index(char c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return -1;
    }
}

const char BASES[5] = "ACGT";

std::string revcom(const std::string &s) {
    std::string r(s.rbegin(), s.rend());
    for (auto &c : r) {
        switch (c) {
            case 'A': c = 'T'; break;
            case 'C': c = 'G'; break;
            case 'G': c = 'C'; break;
            case 'T': c = 'A'; break;
            default: break;
        }
    }
    return r;
}

// ---------------------------------------------------------------------------
// Spectral (k-mer spectrum) error correction — the BFC analog.
// ---------------------------------------------------------------------------

// 2-bit encodings of the forward and reverse-complement k-mer ending at
// position p are maintained incrementally by the callers below.
struct KmerSpectrum {
    int k;
    uint64_t mask;
    std::unordered_map<uint64_t, uint32_t> counts;

    explicit KmerSpectrum(int k_)
        : k(k_), mask(k_ >= 32 ? ~0ULL : ((1ULL << (2 * k_)) - 1)) {}

    static uint64_t canon(uint64_t fwd, uint64_t rev) {
        return fwd < rev ? fwd : rev;
    }

    void add_read(const std::string &s) {
        uint64_t fwd = 0, rev = 0;
        int run = 0;  // consecutive valid bases ending here
        for (size_t i = 0; i < s.size(); ++i) {
            int b = base_index(s[i]);
            if (b < 0) { run = 0; fwd = rev = 0; continue; }
            fwd = ((fwd << 2) | (uint64_t)b) & mask;
            rev = (rev >> 2) | ((uint64_t)(3 - b) << (2 * (k - 1)));
            if (++run >= k) counts[canon(fwd, rev)]++;
        }
    }

    uint32_t get(uint64_t fwd, uint64_t rev) const {
        auto it = counts.find(canon(fwd, rev));
        return it == counts.end() ? 0 : it->second;
    }

    // count of the k-mer s[i..i+k) with positions p/p2 substituted by
    // bases nb/nb2; returns 0 if any base in the window is invalid
    uint32_t window_count(const std::string &s, int i, int p, int nb,
                          int p2 = -1, int nb2 = 0) const {
        uint64_t fwd = 0, rev = 0;
        for (int j = 0; j < k; ++j) {
            int b = (i + j == p) ? nb
                  : (i + j == p2) ? nb2 : base_index(s[i + j]);
            if (b < 0) return 0;
            fwd = ((fwd << 2) | (uint64_t)b) & mask;
            rev = (rev >> 2) | ((uint64_t)(3 - b) << (2 * (k - 1)));
        }
        return get(fwd, rev);
    }
};

// Correct isolated substitution errors in `s` against the spectrum.
// A substitution at read position p invalidates exactly the windows
// [p-k+1, p]; so a maximal run of weak windows [i..j] anchored by solid
// neighbours (or a read edge) is attributed to a single error at some
// p in [j, i+k-1], and repaired iff exactly locating a base that makes
// every window in the run solid.  Conservative by construction: novel
// (variant) k-mers are shared across the partition's reads, hence solid,
// hence never touched.
bool spectral_correct_read(std::string &s, const KmerSpectrum &spec,
                           uint32_t minabund, bool lenient = false,
                           std::vector<int> *fixed_at = nullptr,
                           const KmerSpectrum *confirm = nullptr) {
    // clustered-correction guard (lenient mode): at most one repair per
    // MIN_FIX_SPACING window of a read, across every pass — clusters of
    // "repairs" are the signature of a depth-1 tail being steered onto
    // repeated small-k words, not of real sequencing errors
    const int MIN_FIX_SPACING = 10;
    auto spacing_ok = [&](int p) {
        if (!fixed_at) return true;
        int nearby = 0;
        for (int q : *fixed_at)
            if (std::abs(p - q) < MIN_FIX_SPACING) ++nearby;
        return nearby < 2;
    };
    auto record_fix = [&](int p) {
        if (fixed_at) fixed_at->push_back(p);
    };
    // long-k confirmation (lenient mode): a repair must recreate at least
    // one long-k word shared with another read — a small-k word made
    // "solid" by steering onto a repeat elsewhere in the locus cannot
    // fake that
    auto confirm_ok = [&](int p, int nb, int p2 = -1, int nb2 = 0) {
        if (!confirm) return true;
        int ck = confirm->k;
        int lo = std::max(0, p - ck + 1);
        int hi = std::min(p, (int)s.size() - ck);
        for (int w = lo; w <= hi; ++w)
            if (confirm->window_count(s, w, p, nb, p2, nb2) >= 2)
                return true;
        return false;
    };
    int k = spec.k;
    int P = (int)s.size() - k + 1;
    if (P < 2) return false;
    // solidity per window: -1 invalid (contains N), 0 weak, 1 solid,
    // 2 weak-but-unsalvageable (in lenient mode: no single substitution
    // anywhere in the window reaches the threshold — i.e. the window sits
    // in genuinely low-depth sequence, so its weakness says nothing about
    // errors and it is excluded from both anchoring and repair checks)
    std::vector<int8_t> solid(P, -1);
    {
        uint64_t fwd = 0, rev = 0;
        int run = 0;
        for (size_t i = 0; i < s.size(); ++i) {
            int b = base_index(s[i]);
            if (b < 0) { run = 0; fwd = rev = 0; continue; }
            fwd = ((fwd << 2) | (uint64_t)b) & spec.mask;
            rev = (rev >> 2) | ((uint64_t)(3 - b) << (2 * (k - 1)));
            if (++run >= k) {
                int w = (int)i - k + 1;
                solid[w] = spec.get(fwd, rev) >= minabund ? 1 : 0;
            }
        }
    }
    if (lenient) {
        for (int w = 0; w < P; ++w) {
            if (solid[w] != 0) continue;
            bool salv = false;
            for (int p = w; p < w + k && !salv; ++p)
                for (int nb = 0; nb < 4 && !salv; ++nb) {
                    if (nb == base_index(s[p])) continue;
                    if (spec.window_count(s, w, p, nb) >= minabund)
                        salv = true;
                }
            if (!salv) solid[w] = 2;
        }
    }
    // try single substitutions at p in [plo, phi]: every run window in
    // [wlo, whi] must turn solid (unsalvageable windows are exempt);
    // apply iff exactly one (p, base) works
    auto fix_span = [&](int wlo, int whi, int plo, int phi) {
        // evidence gate: enough testable windows must back the repair —
        // a run that is mostly unsalvageable (depth-1 sequence) offers too
        // few checks for a small-k spectrum to repair safely (tandem
        // repeats would let a wrong base look solid)
        int testable = 0;
        for (int w = wlo; w <= whi; ++w)
            if (solid[w] == 0) ++testable;
        if (testable < std::min(whi - wlo + 1, 2)) return false;
        // among substitutions that solidify every testable window, take
        // the uniquely best-supported one (summed window depth); a tie
        // means the evidence cannot decide and nothing is repaired
        int best_p = -1, best_b = -1;
        long best_score = -1, second_score = -1;
        for (int p = plo; p <= phi; ++p) {
            int orig = base_index(s[p]);
            for (int nb = 0; nb < 4; ++nb) {
                if (nb == orig) continue;
                bool all_solid = true;
                long score = 0;
                for (int w = wlo; w <= whi; ++w) {
                    if (solid[w] == 2) continue;
                    uint32_t c = spec.window_count(s, w, p, nb);
                    if (c < minabund) {
                        all_solid = false;
                        break;
                    }
                    score += c;
                }
                if (all_solid) {
                    if (score > best_score) {
                        second_score = best_score;
                        best_score = score;
                        best_p = p;
                        best_b = nb;
                    } else if (score > second_score) {
                        second_score = score;
                    }
                }
            }
        }
        if (best_p >= 0 && best_score > second_score &&
            spacing_ok(best_p) && confirm_ok(best_p, best_b)) {
            s[best_p] = BASES[best_b];
            record_fix(best_p);
            return true;
        }
        return false;
    };

    bool changed = false;
    int i = 0;
    while (i < P) {
        if (solid[i] != 0) { ++i; continue; }
        // run = maximal weak stretch; unsalvageable windows inside it are
        // carried along but the run is delimited by its extremal true-weak
        // windows
        int t = i, j = i;
        while (t + 1 < P && (solid[t + 1] == 0 || solid[t + 1] == 2)) {
            ++t;
            if (solid[t] == 0) j = t;
        }
        // anchored? (interior runs need solid on both sides; edge runs
        // one; unsalvageable low-depth windows are looked past)
        int li = i - 1;
        while (li >= 0 && solid[li] == 2) --li;
        int rj = j + 1;
        while (rj < P && solid[rj] == 2) ++rj;
        bool left_ok = (li < 0) || solid[li] == 1;
        bool right_ok = (rj >= P) || solid[rj] == 1;
        if (j - i < k && left_ok && right_ok) {
            // one substitution can explain the whole run: error at some
            // p in [j, i+k-1] (the windows a substitution at p invalidates
            // are exactly [p-k+1, p])
            changed |= fix_span(i, j, j, std::min(i + k - 1,
                                                  (int)s.size() - 1));
        } else if (j - i >= k) {
            // multiple errors: repair the run's ends independently — the
            // leftmost error lies at some p in [i, i+k-1] and must fix the
            // affected run prefix [i, p]; symmetrically the rightmost error
            // is at p = j fixing [j-k+1, j].  Errors closer than k stay
            // (their shared windows can't all turn solid) — later passes
            // retry against the refreshed spectrum.
            bool did = false;
            // interior anchors pin BOTH error positions exactly: the
            // leftmost error is at i+k-1 (window i-1 solid, i weak) and the
            // rightmost at j (window j+1 solid, j weak) — a 9-combination
            // double-substitution search settles errors closer than k
            int run_testable = 0;
            for (int w = i; w <= j; ++w)
                if (solid[w] == 0) ++run_testable;
            if (left_ok && right_ok && i > 0 && j < P - 1 &&
                j - i <= 2 * (k - 1) &&
                run_testable >= std::min(j - i + 1, 2)) {
                int p1 = i + k - 1, p2 = j;
                int o1 = base_index(s[p1]), o2 = base_index(s[p2]);
                int b1 = -1, b2 = -1, ncand = 0;
                for (int n1 = 0; n1 < 4 && ncand < 2; ++n1) {
                    if (n1 == o1) continue;
                    for (int n2 = 0; n2 < 4 && ncand < 2; ++n2) {
                        if (n2 == o2) continue;
                        bool all_solid = true;
                        for (int w = i; w <= j; ++w) {
                            if (solid[w] == 2) continue;
                            if (spec.window_count(s, w, p1, n1, p2, n2)
                                    < minabund) {
                                all_solid = false;
                                break;
                            }
                        }
                        if (all_solid) {
                            ++ncand;
                            if (b1 < 0) { b1 = n1; b2 = n2; }
                        }
                    }
                }
                if (ncand == 1 && spacing_ok(p1) && spacing_ok(p2) &&
                    confirm_ok(p1, b1, p2, b2) &&
                    confirm_ok(p2, b2, p1, b1)) {
                    s[p1] = BASES[b1];
                    s[p2] = BASES[b2];
                    record_fix(p1);
                    record_fix(p2);
                    did = changed = true;
                }
            }
            if (!did && left_ok) {
                for (int p = i + k - 1; p >= i && !did; --p)
                    did = fix_span(i, std::min(j, p), p, p);
            }
            if (!did && right_ok && j - k + 1 >= 0)
                changed |= fix_span(std::max(i, j - k + 1), j, j, j);
            changed |= did;
        }
        i = t + 1;
    }
    return changed;
}

// correct all reads in place against their joint spectrum, iterating until
// convergence (each pass's fixes reinforce true k-mers for the next);
// returns #reads changed in total
int spectral_correct(std::vector<std::string> &reads, int k,
                     uint32_t minabund, bool lenient = false) {
    int total = 0;
    std::vector<std::vector<int>> fixed_at(lenient ? reads.size() : 0);
    for (int pass = 0; pass < 4; ++pass) {
        KmerSpectrum spec(k);
        for (const auto &s : reads) spec.add_read(s);
        KmerSpectrum conf(25);
        if (lenient)
            for (const auto &s : reads) conf.add_read(s);
        int n = 0;
        for (size_t r = 0; r < reads.size(); ++r)
            if (spectral_correct_read(reads[r], spec, minabund, lenient,
                                      lenient ? &fixed_at[r] : nullptr,
                                      lenient ? &conf : nullptr))
                ++n;
        total += n;
        if (n == 0) break;
    }
    return total;
}

// ---------------------------------------------------------------------------
// Small local aligner (for bubble comparisons only): Smith-Waterman with the
// reference cleaner's scoring (match 5, mismatch -4, gap open 5, extend 2).
// Sequences here are overhangs/bubble interiors, <= a few hundred bases.
// ---------------------------------------------------------------------------

int sw_score(const std::string &a, const std::string &b) {
    const int MATCH = 5, MISMATCH = -4, GAPO = 5, GAPE = 2;
    int n = (int)a.size(), m = (int)b.size();
    if (n == 0 || m == 0) return 0;
    std::vector<int> H(m + 1, 0), E(m + 1, 0);
    int best = 0;
    for (int i = 1; i <= n; ++i) {
        int diag = 0, F = 0;
        for (int j = 1; j <= m; ++j) {
            int h = diag + (a[i - 1] == b[j - 1] ? MATCH : MISMATCH);
            E[j] = std::max(E[j] - GAPE, H[j] - GAPO - GAPE);
            F = std::max(F - GAPE, H[j - 1] - GAPO - GAPE);
            diag = H[j];
            h = std::max(std::max(h, E[j]), std::max(F, 0));
            H[j] = h;
            if (h > best) best = h;
        }
    }
    return best;
}

// difference estimate between two near-equal sequences from the SW score,
// as the cleaning passes define it: (minlen*match - score) / (match - mis)
double sw_ndiff(const std::string &a, const std::string &b) {
    int minlen = (int)std::min(a.size(), b.size());
    return (minlen * 5. - sw_score(a, b)) / (5. + 4.);
}

// ---------------------------------------------------------------------------
// Exact-overlap string graph.
// ---------------------------------------------------------------------------

// Cleaning thresholds, derived from the partition the way the reference
// pipeline derives them (misc.c:275-295: min_elen = 2.5x mean read length,
// the supporting-read floor scales with k-mer coverage, clamped to [4, 8]).
struct CleanParams {
    int min_ovl;    // minimum exact overlap (reference min_asm_ovlp = 33)
    int min_elen;   // tips shorter than this AND weaker than...
    int min_ensr;   // ...this many supporting reads are removed
    int min_insr;   // internal-vertex floor (min_ensr - 1)
};

struct SgEdge {
    int v;         // neighbour node id
    uint8_t vend;  // which of the neighbour's ends the overlap enters
    int ovl;       // exact overlap length
};

// A unitig: stored sequence + per-base read depth + #supporting reads.
// End 0 is the stored prefix, end 1 the stored suffix.  An edge at
// (u, e) -> (v, f) with overlap L means: the last L bases of u oriented
// with e on the right equal the first L bases of v oriented with f on
// the left.  Edges are stored symmetrically on both nodes.
struct SgNode {
    std::string seq;
    std::vector<uint16_t> cov;
    int nsr = 0;
    bool alive = true;
    std::vector<SgEdge> nei[2];

    int len() const { return (int)seq.size(); }
    int degree(int end) const { return (int)nei[end].size(); }
    bool is_open() const { return nei[0].empty() || nei[1].empty(); }
    std::string oriented(int right_end) const {
        return right_end == 1 ? seq : revcom(seq);
    }
    double avg_cov(int from, int to) const {  // [from, to) clamped
        from = std::max(from, 0);
        to = std::min(to, (int)cov.size());
        if (from >= to) return cov.empty() ? 0.0 : (double)cov[
            std::min(std::max(from, 0), (int)cov.size() - 1)];
        double s = 0;
        for (int i = from; i < to; ++i) s += cov[i];
        return s / (to - from);
    }
};

class StringGraph {
  public:
    std::vector<SgNode> nodes;
    CleanParams prm;

    explicit StringGraph(const CleanParams &p) : prm(p) {}

    // ---- construction -----------------------------------------------------

    void build(const std::vector<std::string> &reads) {
        add_reads(reads);
        find_overlaps();
        if (getenv("KT_ASM_DEBUG2")) dump("pre-reduce");
        reduce_transitive();
        if (getenv("KT_ASM_DEBUG2")) dump("post-reduce");
    }

    void dump(const char *tag) const {
        fprintf(stderr, "[kt_asm] ---- %s ----\n", tag);
        for (int u = 0; u < (int)nodes.size(); ++u) {
            if (!nodes[u].alive) continue;
            fprintf(stderr, "[kt_asm] node %d len=%d nsr=%d %.16s L:", u,
                    nodes[u].len(), nodes[u].nsr, nodes[u].seq.c_str());
            for (auto &e : nodes[u].nei[0])
                fprintf(stderr, " (%d.%d,%d)", e.v, e.vend, e.ovl);
            fprintf(stderr, " R:");
            for (auto &e : nodes[u].nei[1])
                fprintf(stderr, " (%d.%d,%d)", e.v, e.vend, e.ovl);
            fprintf(stderr, "\n");
        }
    }

    // ---- the cleaning schedule (pass order mirrors the reference's
    // mag_g_clean with MAG_F_NO_SIMPL | MAG_F_POPOPEN, mag.c:559-583) ------

    void clean() {
        merge_chains();
        for (int j = 2; j <= prm.min_ensr; ++j)
            rm_tips(prm.min_elen, j);
        merge_chains();
        rm_weak_edges();
        merge_chains();
        for (int j = 2; j <= prm.min_ensr; ++j)
            rm_tips(prm.min_elen, j);
        merge_chains();
        pop_open();
        merge_chains();
        pop_simple();
        merge_chains();
        rm_internal();
        rm_weak_edges();
        merge_chains();
        rm_tips(prm.min_elen, prm.min_ensr);
        merge_chains();
        pop_open();
        merge_chains();
        rm_tips(prm.min_elen, prm.min_ensr);
        merge_chains();
    }

    std::vector<std::string> emit() const {
        std::vector<std::string> out;
        for (const auto &n : nodes)
            if (n.alive) out.push_back(n.seq);
        std::stable_sort(out.begin(), out.end(),
                         [](const std::string &a, const std::string &b) {
                             if (a.size() != b.size())
                                 return a.size() > b.size();
                             return a < b;
                         });
        return out;
    }

  private:
    // ---- read ingestion: dedup + containment ------------------------------

    // 32-mer anchor occurrences: packed word -> (node, pos) on the stored
    // strand.  Queries probe both the word and its reverse complement.
    struct Occ { int node; int pos; };
    std::unordered_map<uint64_t, std::vector<Occ>> anchors;
    static const int AK = 32;  // anchor width (fits one packed uint64)

    static bool pack32(const std::string &s, int pos, uint64_t *out) {
        uint64_t w = 0;
        for (int i = 0; i < AK; ++i) {
            int b = base_index(s[pos + i]);
            if (b < 0) return false;
            w = (w << 2) | (uint64_t)b;
        }
        *out = w;
        return true;
    }

    static uint64_t rc32(uint64_t w) {
        w = ~w;  // complement each 2-bit base (A<->T, C<->G under 2-bit)
        w = ((w & 0x3333333333333333ULL) << 2) |
            ((w >> 2) & 0x3333333333333333ULL);
        w = ((w & 0x0F0F0F0F0F0F0F0FULL) << 4) |
            ((w >> 4) & 0x0F0F0F0F0F0F0F0FULL);
        w = ((w & 0x00FF00FF00FF00FFULL) << 8) |
            ((w >> 8) & 0x00FF00FF00FF00FFULL);
        w = ((w & 0x0000FFFF0000FFFFULL) << 16) |
            ((w >> 16) & 0x0000FFFF0000FFFFULL);
        return (w << 32) | (w >> 32);
    }

    void add_reads(const std::vector<std::string> &reads) {
        // longest first so containment always lands in an existing node
        std::vector<const std::string *> order;
        for (const auto &r : reads)
            if ((int)r.size() >= prm.min_ovl) order.push_back(&r);
        std::stable_sort(order.begin(), order.end(),
                         [](const std::string *a, const std::string *b) {
                             if (a->size() != b->size())
                                 return a->size() > b->size();
                             return *a < *b;
                         });
        for (const auto *rp : order) {
            const std::string &r = *rp;
            int host, pos;
            bool rcflag;
            if (find_container(r, &host, &pos, &rcflag)) {
                // absorbed: depth and support still count (every copy of a
                // duplicated or contained read is evidence for the host)
                SgNode &h = nodes[host];
                int L = (int)r.size();
                int start = pos;  // host coordinates either strand
                (void)rcflag;
                for (int i = 0; i < L; ++i)
                    if (h.cov[start + i] < 0xffff) ++h.cov[start + i];
                ++h.nsr;
                continue;
            }
            SgNode n;
            n.seq = r;
            n.cov.assign(r.size(), 1);
            n.nsr = 1;
            int id = (int)nodes.size();
            nodes.push_back(std::move(n));
            index_node(id);
        }
    }

    void index_node(int id) {
        const std::string &s = nodes[id].seq;
        uint64_t w;
        for (int p = 0; p + AK <= (int)s.size(); ++p)
            if (pack32(s, p, &w)) anchors[w].push_back({id, p});
    }

    // exact containment of `r` (either strand) in an indexed node
    bool find_container(const std::string &r, int *host, int *pos,
                        bool *rcflag) {
        uint64_t w;
        if (!pack32(r, 0, &w)) return false;
        for (int strand = 0; strand < 2; ++strand) {
            std::string q = strand ? revcom(r) : r;
            uint64_t qw = strand ? rc32(w) : w;
            // the anchor of a reverse-complemented query is its LAST 32-mer
            int qoff = strand ? (int)q.size() - AK : 0;
            auto it = anchors.find(qw);
            if (it == anchors.end()) continue;
            for (const Occ &o : it->second) {
                int start = o.pos - qoff;
                const std::string &h = nodes[o.node].seq;
                if (start < 0 || start + (int)q.size() > (int)h.size())
                    continue;
                if (std::memcmp(h.data() + start, q.data(), q.size()) == 0) {
                    *host = o.node;
                    *pos = start;
                    *rcflag = strand != 0;
                    return true;
                }
            }
        }
        return false;
    }

    // ---- overlap discovery -------------------------------------------------

    void add_edge(int u, int uend, int v, int vend, int ovl) {
        if (u == v) return;  // self-overlaps (short repeats) are not edges
        for (auto &e : nodes[u].nei[uend])
            if (e.v == v && e.vend == vend) {
                if (ovl > e.ovl) {  // keep the maximal overlap per pair
                    e.ovl = ovl;
                    for (auto &b : nodes[v].nei[vend])
                        if (b.v == u && b.vend == uend) b.ovl = ovl;
                }
                return;
            }
        nodes[u].nei[uend].push_back({v, (uint8_t)vend, ovl});
        nodes[v].nei[vend].push_back({u, (uint8_t)uend, ovl});
    }

    // All maximal exact suffix-prefix overlaps >= min_ovl.  For each node v
    // and each of its orientations, the first 32 bases anchor a lookup; an
    // occurrence at position p of node u (stored strand) proposes
    // "suffix of u covers prefix of v" with overlap len(u) - p, verified
    // by direct comparison.
    void find_overlaps() {
        int N = (int)nodes.size();
        for (int v = 0; v < N; ++v) {
            for (int f = 0; f < 2; ++f) {
                // orientation of v with end f on the LEFT
                std::string q = nodes[v].oriented(f ^ 1);
                uint64_t qw;
                if (!pack32(q, 0, &qw)) continue;
                for (int qs = 0; qs < 2; ++qs) {
                    uint64_t key = qs ? rc32(qw) : qw;
                    auto it = anchors.find(key);
                    if (it == anchors.end()) continue;
                    for (const Occ &o : it->second) {
                        int u = o.node;
                        const std::string &h = nodes[u].seq;
                        // occurrence strand: qs==0 -> q's prefix matches h
                        // forward at o.pos; qs==1 -> matches rc(h), i.e. at
                        // rc position len(h) - AK - o.pos
                        int p = qs ? nodes[u].len() - AK - o.pos : o.pos;
                        int ovl = nodes[u].len() - p;
                        if (ovl < prm.min_ovl) continue;
                        if (ovl >= (int)q.size()) continue;  // containment
                        if (ovl >= nodes[u].len()) continue;
                        if (u == v) continue;
                        // verify the full overlap on the oriented strings
                        std::string hs = qs ? revcom(h) : h;
                        if (std::memcmp(hs.data() + p, q.data(), ovl) != 0)
                            continue;
                        // suffix of (u oriented fwd-if-qs==0) -> prefix of
                        // (v oriented with f left).  u's outgoing end:
                        // stored end 1 when on its stored strand.
                        int uend = qs ? 0 : 1;
                        add_edge(u, uend, v, f, ovl);
                    }
                }
            }
        }
    }

    // Composite-overlap removal: an edge u->w implied by u->v->w (with the
    // exact-arithmetic overlap len: ovl_uw == ovl_uv + ovl_vw - len(v)) is
    // redundant and dropped.  Each pass computes every drop against the
    // start-of-pass graph (a reducible edge may still witness the reduction
    // of a shorter one: composites are strictly shorter than their
    // witnesses, so there are no cycles), then erases in one sweep;
    // repeats until stable.
    void reduce_transitive() {
        bool changed = true;
        while (changed) {
            changed = false;
            // canonical key of the symmetric edge {(u,e),(v,f)} + overlap
            auto key = [](int u, int e, int v, int f, int ovl) {
                uint64_t a = ((uint64_t)u << 1) | e;
                uint64_t b = ((uint64_t)v << 1) | f;
                if (a > b) std::swap(a, b);
                return (a << 42) | (b << 20) | (uint64_t)ovl;
            };
            std::unordered_map<uint64_t, char> drops;
            for (int u = 0; u < (int)nodes.size(); ++u) {
                for (int e = 0; e < 2; ++e) {
                    const auto &edges = nodes[u].nei[e];
                    for (const SgEdge &uv : edges) {
                        // continue through v: leave by the opposite end
                        int vout = uv.vend ^ 1;
                        for (const SgEdge &vw : nodes[uv.v].nei[vout]) {
                            int need = uv.ovl + vw.ovl - nodes[uv.v].len();
                            if (need < prm.min_ovl) continue;
                            for (const SgEdge &uw : edges) {
                                if (uw.v == vw.v && uw.vend == vw.vend &&
                                    uw.ovl == need &&
                                    !(uw.v == uv.v && uw.vend == uv.vend &&
                                      uw.ovl == uv.ovl))
                                    drops[key(u, e, uw.v, uw.vend,
                                              uw.ovl)] = 1;
                            }
                        }
                    }
                }
            }
            if (!drops.empty()) changed = true;
            for (int u = 0; u < (int)nodes.size(); ++u) {
                for (int e = 0; e < 2; ++e) {
                    auto &edges = nodes[u].nei[e];
                    size_t w = 0;
                    for (size_t a = 0; a < edges.size(); ++a)
                        if (!drops.count(key(u, e, edges[a].v,
                                             edges[a].vend, edges[a].ovl)))
                            edges[w++] = edges[a];
                    edges.resize(w);
                }
            }
        }
    }

    // ---- graph surgery helpers ---------------------------------------------

    void erase_edge(int u, int uend, int v, int vend) {
        auto &es = nodes[u].nei[uend];
        for (size_t i = 0; i < es.size(); ++i)
            if (es[i].v == v && es[i].vend == vend) {
                es.erase(es.begin() + i);
                return;
            }
    }

    void cut_edge(int u, int uend, int v, int vend) {
        erase_edge(u, uend, v, vend);
        erase_edge(v, vend, u, uend);
    }

    void kill_node(int u) {
        for (int e = 0; e < 2; ++e) {
            for (const SgEdge &ed : nodes[u].nei[e])
                erase_edge(ed.v, ed.vend, u, e);
            nodes[u].nei[e].clear();
        }
        nodes[u].alive = false;
    }

    // flip a node's stored orientation in place, fixing back-references
    void flip(int u) {
        SgNode &n = nodes[u];
        n.seq = revcom(n.seq);
        std::reverse(n.cov.begin(), n.cov.end());
        std::swap(n.nei[0], n.nei[1]);
        for (int e = 0; e < 2; ++e)
            for (const SgEdge &ed : n.nei[e])
                for (auto &back : nodes[ed.v].nei[ed.vend])
                    if (back.v == u) back.vend = (uint8_t)e;
    }

    // ---- unambiguous chain merging -----------------------------------------

    // merge along (u, 1) -> (v, f) when both ends are simple; u absorbs v
    bool try_merge_right(int u) {
        SgNode &a = nodes[u];
        if (a.nei[1].size() != 1) return false;
        SgEdge e = a.nei[1][0];
        if (e.v == u) return false;
        if (nodes[e.v].nei[e.vend].size() != 1) return false;
        int v = e.v;
        if (e.vend == 1) flip(v);  // v now enters at its stored left end
        SgNode &b = nodes[v];
        int ovl = e.ovl;
        int alen = a.len();
        // fuse sequences and depth (overlap columns add)
        a.seq += b.seq.substr(ovl);
        for (int i = 0; i < ovl; ++i) {
            uint32_t c = a.cov[alen - ovl + i] + b.cov[i];
            a.cov[alen - ovl + i] = (uint16_t)std::min<uint32_t>(c, 0xffff);
        }
        a.cov.insert(a.cov.end(), b.cov.begin() + ovl, b.cov.end());
        a.nsr += b.nsr;
        // a's right end adopts b's right-end edges
        a.nei[1].clear();
        erase_edge(v, 0, u, 1);
        for (const SgEdge &ed : b.nei[1]) {
            for (auto &back : nodes[ed.v].nei[ed.vend])
                if (back.v == v && back.vend == 1) {
                    back.v = u;
                    back.vend = 1;
                }
            a.nei[1].push_back(ed);
        }
        b.nei[0].clear();
        b.nei[1].clear();
        b.alive = false;
        return true;
    }

    void merge_chains() {
        bool merged = true;
        while (merged) {
            merged = false;
            for (int u = 0; u < (int)nodes.size(); ++u) {
                if (!nodes[u].alive) continue;
                if (try_merge_right(u)) { merged = true; continue; }
                flip(u);
                if (try_merge_right(u)) merged = true;
            }
        }
    }

    // ---- cleaning passes ----------------------------------------------------

    // candidates collected first, processed weakest-first (nsr, then len)
    std::vector<int> weakest_first(const std::vector<int> &ids) {
        std::vector<int> v(ids);
        std::stable_sort(v.begin(), v.end(), [this](int a, int b) {
            if (nodes[a].nsr != nodes[b].nsr)
                return nodes[a].nsr < nodes[b].nsr;
            return nodes[a].len() < nodes[b].len();
        });
        return v;
    }

    bool is_tip(int u, int min_len, int min_nsr) const {
        const SgNode &n = nodes[u];
        return n.alive && n.is_open() && n.len() < min_len &&
               n.nsr < min_nsr;
    }

    void rm_tips(int min_len, int min_nsr) {
        std::vector<int> cand;
        for (int u = 0; u < (int)nodes.size(); ++u)
            if (is_tip(u, min_len, min_nsr)) cand.push_back(u);
        for (int u : weakest_first(cand)) kill_node(u);
    }

    // drop edges much weaker than the strongest at the same end (ratio
    // 0.7), unless the strongest leads into a tip (then every edge at the
    // end is judged against the floor only)
    void rm_weak_edges() {
        const double RATIO = 0.7;
        std::vector<int> cand;
        for (int u = 0; u < (int)nodes.size(); ++u) {
            if (!nodes[u].alive) continue;
            if (is_tip(u, prm.min_elen, prm.min_ensr)) continue;
            cand.push_back(u);
        }
        auto order = weakest_first(cand);
        for (auto it = order.rbegin(); it != order.rend(); ++it) {
            int u = *it;
            if (!nodes[u].alive) continue;
            for (int e = 0; e < 2; ++e) {
                auto edges = nodes[u].nei[e];  // copy: we mutate below
                if (edges.empty()) continue;
                int max_ovl = prm.min_ovl, max_i = -1;
                for (size_t i = 0; i < edges.size(); ++i)
                    if (edges[i].ovl > max_ovl) {
                        max_ovl = edges[i].ovl;
                        max_i = (int)i;
                    }
                if (max_i >= 0 &&
                    is_tip(edges[max_i].v, prm.min_elen, prm.min_ensr))
                    max_ovl = prm.min_ovl;
                for (const SgEdge &ed : edges)
                    if (ed.ovl < prm.min_ovl ||
                        (double)ed.ovl / max_ovl < RATIO)
                        cut_edge(u, e, ed.v, ed.vend);
            }
        }
    }

    // Open bubble: a short dead-end whose single edge competes with sibling
    // branches at the junction.  If the dead-end's overhang aligns well to
    // any sibling's overhang, the dead-end duplicates sequence already on a
    // through path and is removed whole.
    void pop_open() {
        const double MAX_N_DIFF = 2.01, MAX_R_DIFF = 0.1;
        for (int u = 0; u < (int)nodes.size(); ++u) {
            SgNode &n = nodes[u];
            if (!n.alive || n.len() >= prm.min_elen) continue;
            if (n.degree(0) + n.degree(1) != 1) continue;
            int e = n.degree(0) ? 0 : 1;
            SgEdge link = n.nei[e][0];
            if (link.v == u) continue;
            if (nodes[link.v].nei[link.vend].size() <= 1) continue;
            // overhang of u past the junction, pointing away from q
            std::string uo = n.oriented(e);  // e on the right: tail = prefix
            std::string over_u = uo.substr(0, n.len() - link.ovl);
            // compare against sibling overhangs (same junction end)
            std::string rc_over = revcom(over_u);
            bool shadowed = false;
            for (const SgEdge &sib : nodes[link.v].nei[link.vend]) {
                if (sib.v == u && sib.vend == e) continue;
                const SgNode &t = nodes[sib.v];
                // sibling oriented leaving the junction: entering end on
                // the left; overhang beyond its overlap, capped at 2x query
                std::string to = t.oriented(sib.vend ^ 1);
                int cap = std::min((int)to.size() - sib.ovl,
                                   2 * (int)over_u.size());
                if (cap <= 0) continue;
                std::string over_t = to.substr(sib.ovl, cap);
                // the dead-end overhang points AWAY from the junction while
                // the sibling overhang points along it; compare rc
                int score = sw_score(rc_over, over_t);
                if (score < (int)over_u.size() * 5 / 2) continue;
                double nd = ((int)over_u.size() * 5. - score) / 9.;
                double rd = nd / over_u.size();
                if (nd < MAX_N_DIFF || rd < MAX_R_DIFF) {
                    shadowed = true;
                    break;
                }
            }
            if (shadowed) kill_node(u);
        }
    }

    // Simple bubble: two parallel single-in single-out vertices between the
    // same endpoints.  Pop the shallower side only when it is both shallow
    // in absolute depth and a small fraction of the total — balanced
    // (heterozygous) bubbles survive as separate contigs.
    void pop_simple() {
        const double MAX_N_DIFF = 2.01, MAX_R_DIFF = 0.1;
        const double MAX_BCOV = 10.0, MAX_BFRAC = 0.15;
        const int MAX_BDIFF = 50;
        const double L_DIFF_COEF = 0.2;
        for (int u = 0; u < (int)nodes.size(); ++u) {
            if (!nodes[u].alive) continue;
            for (int e = 0; e < 2; ++e) {
                if (nodes[u].nei[e].size() != 2) continue;
                SgEdge arm[2] = {nodes[u].nei[e][0], nodes[u].nei[e][1]};
                int q[2] = {arm[0].v, arm[1].v};
                if (q[0] == u || q[1] == u || q[0] == q[1]) continue;
                bool simple = true;
                for (int j = 0; j < 2; ++j)
                    if (nodes[q[j]].degree(0) != 1 ||
                        nodes[q[j]].degree(1) != 1)
                        simple = false;
                if (!simple) continue;
                // both far ends must rejoin at the same place
                SgEdge far0 = nodes[q[0]].nei[arm[0].vend ^ 1][0];
                SgEdge far1 = nodes[q[1]].nei[arm[1].vend ^ 1][0];
                if (far0.v != far1.v || far0.vend != far1.vend) continue;
                if (far0.v == u && far0.vend == e) continue;
                // interior sequences (between the two junction overlaps)
                int l[2];
                std::string interior[2];
                double avg[2];
                for (int j = 0; j < 2; ++j) {
                    const SgNode &qa = nodes[q[j]];
                    int lov = arm[j].ovl, rov = (j ? far1 : far0).ovl;
                    l[j] = qa.len() - lov - rov;
                    // oriented with the near junction on the left
                    std::string qo = qa.oriented(arm[j].vend ^ 1);
                    if (l[j] > 0) {
                        interior[j] = qo.substr(lov, l[j]);
                        int beg = arm[j].vend == 0 ? lov : rov;
                        avg[j] = qa.avg_cov(beg, beg + l[j]);
                    } else {
                        int beg = std::min(lov, qa.len() - rov);
                        int end = std::max(lov, qa.len() - rov);
                        avg[j] = qa.avg_cov(beg, std::max(end, beg + 1));
                    }
                }
                if (l[0] - l[1] > MAX_BDIFF || l[1] - l[0] > MAX_BDIFF)
                    continue;
                double nd, rd;
                if (l[0] > 0 && l[1] > 0) {
                    nd = sw_ndiff(interior[0], interior[1]);
                    rd = nd / ((l[0] + l[1]) / 2.0);
                } else {
                    nd = std::abs(l[0] - l[1]) * L_DIFF_COEF;
                    rd = 1.0;
                }
                if (!(nd < MAX_N_DIFF || rd < MAX_R_DIFF)) continue;
                int loser = avg[0] < avg[1] ? 0 : 1;
                if (avg[loser] < MAX_BCOV &&
                    avg[loser] / (avg[0] + avg[1]) < MAX_BFRAC)
                    kill_node(q[loser]);
            }
        }
    }

    // internal vertex removal: a short, weakly supported vertex wedged
    // between real paths is deleted, splicing its neighbours together when
    // the composite overlap stays meaningful
    void rm_internal() {
        std::vector<int> cand;
        for (int u = 0; u < (int)nodes.size(); ++u) {
            const SgNode &n = nodes[u];
            if (n.alive && !n.is_open() && n.len() < prm.min_elen &&
                n.nsr < prm.min_insr)
                cand.push_back(u);
        }
        for (int u : weakest_first(cand)) {
            if (!nodes[u].alive) continue;
            auto left = nodes[u].nei[0], right = nodes[u].nei[1];
            kill_node(u);
            for (const SgEdge &a : left)
                for (const SgEdge &b : right) {
                    int ovl = a.ovl + b.ovl - nodes[u].len();
                    if (ovl >= prm.min_ovl && a.v != b.v)
                        add_edge(a.v, a.vend, b.v, b.vend, ovl);
                }
        }
    }
};

// Coverage-scaled cleaning floor: mean abundance of the solid (count >= 4)
// anchor-length k-mers, the same statistic the reference derives its
// supporting-read threshold from (misc.c:285-291).
double anchor_kmer_coverage(const std::vector<std::string> &reads,
                            int min_ovl) {
    KmerSpectrum spec(std::min(min_ovl, 32));
    for (const auto &r : reads) spec.add_read(r);
    uint64_t tot = 0, n = 0;
    for (const auto &kv : spec.counts)
        if (kv.second >= 4) {
            tot += kv.second;
            ++n;
        }
    return n ? (double)tot / n : 0.0;
}

std::vector<std::string> assemble_partition(std::vector<std::string> reads,
                                            int min_ovl) {
    if (reads.empty()) return {};
    uint64_t tot_len = 0;
    for (const auto &r : reads) tot_len += r.size();
    // BFC-analog spectral correction before overlap discovery: a strict
    // long-k pass first (unique repairs only), then a lenient short-k pass
    // whose width scales with partition size (the reference corrector's
    // ec_k heuristic, misc.c:43-54) — the short k keeps window counts high
    // enough to anchor repairs next to low-depth flanks, while the
    // unsalvageable-window exemption stops those flanks from vetoing them.
    if ((int)reads.size() >= 4) {
        std::vector<std::string> before;
        if (getenv("KT_ASM_DEBUG3")) before = reads;
        spectral_correct(reads, 25, 2);
        if (getenv("KT_ASM_DEBUG3")) {
            for (size_t r = 0; r < reads.size(); ++r)
                if (reads[r] != before[r])
                    fprintf(stderr, "[kt_asm] strict fix read %zu\n", r);
            before = reads;
        }
        int log_len = 10;
        while (log_len < 32 && (1ULL << log_len) <= tot_len) ++log_len;
        int k2 = (log_len + 12) / 2;
        if (k2 % 2 == 0) ++k2;
        k2 = std::max(11, std::min(25, k2));
        KmerSpectrum spec2(k2);
        for (const auto &r : reads) spec2.add_read(r);
        uint64_t tk = 0, nk = 0;
        for (const auto &kv : spec2.counts)
            if (kv.second >= 4) { tk += kv.second; ++nk; }
        int ab2 = nk ? (int)(0.1 * ((double)tk / nk) + .499) : 4;
        ab2 = std::max(4, std::min(8, ab2));
        spectral_correct(reads, k2, ab2, /*lenient=*/true);
        if (getenv("KT_ASM_DEBUG3")) {
            fprintf(stderr, "[kt_asm] lenient pass k2=%d ab2=%d\n", k2, ab2);
            for (size_t r = 0; r < reads.size(); ++r)
                if (reads[r] != before[r]) {
                    for (size_t p = 0; p < reads[r].size(); ++p)
                        if (reads[r][p] != before[r][p])
                            fprintf(stderr,
                                    "[kt_asm] lenient fix read %zu pos %zu "
                                    "%c->%c\n", r, p, before[r][p],
                                    reads[r][p]);
                }
        }
    }

    double kcov = anchor_kmer_coverage(reads, min_ovl);
    CleanParams prm;
    prm.min_ovl = min_ovl;
    prm.min_elen = (int)((double)tot_len / reads.size() * 2.5 + .499);
    prm.min_ensr = std::max(4, std::min(8, (int)(kcov * 0.1 + .499)));
    prm.min_insr = prm.min_ensr - 1;

    StringGraph g(prm);
    g.build(reads);
    if (getenv("KT_ASM_DEBUG")) {
        int alive = 0, nedges = 0;
        for (auto &n : g.nodes)
            if (n.alive) {
                ++alive;
                nedges += (int)(n.nei[0].size() + n.nei[1].size());
            }
        fprintf(stderr,
                "[kt_asm] reads=%zu nodes=%d edges=%d min_elen=%d "
                "min_ensr=%d kcov=%.1f\n",
                reads.size(), alive, nedges / 2, prm.min_elen, prm.min_ensr,
                kcov);
    }
    g.clean();
    if (getenv("KT_ASM_DEBUG")) {
        for (auto &n : g.nodes)
            if (n.alive)
                fprintf(stderr, "[kt_asm]   unitig len=%d nsr=%d deg=%d/%d\n",
                        n.len(), n.nsr, n.degree(0), n.degree(1));
    }
    std::vector<std::string> out = g.emit();
    if (out.empty() && (int)reads.size() >= prm.min_ensr &&
        prm.min_ensr > 2) {
        // Low-coverage rescue: at partition depths of only a handful of
        // reads a single residual error splits the chain into pieces whose
        // support sits under the coverage-scaled floor, and every piece
        // dies as a "tip" — the whole locus vanishes.  Re-clean with the
        // minimum meaningful floor (2 supporting reads) so a genuine
        // variant path survives; bubble/weak-edge popping still runs, so
        // error branches are still resolved against the stronger sibling.
        // Gated at >= min_ensr reads so partitions below the reference's
        // supporting-read floor (fermi-lite misc.c:290) still assemble to
        // nothing — that contract is pinned by
        // tests/test_assemble_graph.py::test_tiny_partition_below_support_floor.
        CleanParams relaxed = prm;
        relaxed.min_ensr = 2;
        relaxed.min_insr = 1;
        StringGraph g2(relaxed);
        g2.build(reads);
        g2.clean();
        out = g2.emit();
        if (getenv("KT_ASM_DEBUG"))
            fprintf(stderr, "[kt_asm] rescue pass (min_ensr=2) -> %zu "
                    "unitig(s)\n", out.size());
    }
    return out;
}

}  // namespace

extern "C" {

int kt_correct(const char **reads, int nreads, int k, int minabund,
               char *out, int out_cap) {
    std::vector<std::string> inputs;
    inputs.reserve(nreads);
    for (int i = 0; i < nreads; ++i) inputs.emplace_back(reads[i]);
    spectral_correct(inputs, k, (uint32_t)minabund);
    int pos = 0, n = 0;
    for (auto &s : inputs) {
        int need = (int)s.size() + 1;
        if (pos + need > out_cap) break;
        std::memcpy(out + pos, s.c_str(), need);
        pos += need;
        ++n;
    }
    return n;
}

int kt_assemble(const char **reads, int nreads, int min_overlap, char *out,
                int out_cap) {
    std::vector<std::string> inputs;
    inputs.reserve(nreads);
    for (int i = 0; i < nreads; ++i) {
        std::string s(reads[i]);
        if (!s.empty()) inputs.push_back(std::move(s));
    }
    std::vector<std::string> contigs =
        assemble_partition(std::move(inputs), min_overlap);
    int pos = 0, n = 0;
    for (auto &c : contigs) {
        int need = (int)c.size() + 1;
        if (pos + need > out_cap) break;
        std::memcpy(out + pos, c.c_str(), need);
        pos += need;
        ++n;
    }
    return n;
}

}  // extern "C"
