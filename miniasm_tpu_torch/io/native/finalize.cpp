// ORACLE (sequential C++ cross-check) — NOT the production path.
//
// Production cleaning is graph/hybrid.py + graph/devclean.py +
// graph/devbub.py (device detection, ordered host commits); this file is
// a function-by-function transliteration of the reference kept so tests
// can diff three independent implementations (device-hybrid, this, and
// the Python spec) against each other and the reference binary.  It is
// reachable in the CLI only via the debug switch MINIASM_TPU_CLEAN=native.
//
// Implements the exact sequential semantics of the reference's
// asg.c:83-433 (weak-overlap drop, multi/asymm deletion, tip cutting,
// internal-unitig cutting, bi-loop cutting, bubble popping) and
// asm.c:121-210 (unitig generation), stage-gated like main.c:160-188.
// These passes mutate as they scan (later vertices observe earlier
// deletions), so they are inherently sequential; this is the fast host
// commit path.  The Python implementations in graph/seqclean.py and
// unitig/unitig.py are the executable spec; tests assert identical output.

#include <cassert>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <vector>

extern "C" void ma_radix_argsort_u64(uint64_t*, int64_t*, int64_t);

namespace {

struct Arc {
    uint64_t ul;
    uint32_t v;
    uint32_t ol : 31, del : 1;
};

struct Graph {
    std::vector<Arc> arc;
    std::vector<uint64_t> idx;   // start<<32 | count per vertex
    std::vector<uint32_t> slen;
    std::vector<uint8_t> sdel;
    bool is_symm = false;

    uint32_t n_vtx() const { return static_cast<uint32_t>(slen.size() * 2); }
    uint32_t arc_n(uint32_t v) const { return static_cast<uint32_t>(idx[v]); }
    Arc* arc_a(uint32_t v) { return arc.data() + (idx[v] >> 32); }
};

inline uint32_t arc_len(const Arc& a) { return static_cast<uint32_t>(a.ul); }

void arc_index(Graph& g) {
    g.idx.assign(g.n_vtx(), 0);
    size_t n = g.arc.size(), last = 0;
    for (size_t i = 1; i <= n; ++i) {
        if (i == n || g.arc[i - 1].ul >> 32 != g.arc[i].ul >> 32) {
            g.idx[g.arc[i - 1].ul >> 32] =
                static_cast<uint64_t>(last) << 32 | (i - last);
            last = i;
        }
    }
}

// asg_arc_rm + reindex; arcs arrive sorted and compaction preserves order
// (the reference never re-sorts after the first cleanup, asg.c:72-80)
void cleanup(Graph& g) {
    size_t m = 0;
    for (size_t e = 0; e < g.arc.size(); ++e) {
        uint32_t u = g.arc[e].ul >> 32, v = g.arc[e].v;
        if (!g.arc[e].del && !g.sdel[u >> 1] && !g.sdel[v >> 1])
            g.arc[m++] = g.arc[e];
    }
    g.arc.resize(m);
    arc_index(g);
}

void arc_del(Graph& g, uint32_t v, uint32_t w, int del) {
    uint32_t nv = g.arc_n(v);
    Arc* av = g.arc_a(v);
    for (uint32_t i = 0; i < nv; ++i)
        if (av[i].v == w) av[i].del = !!del;
}

void seq_del(Graph& g, uint32_t s) {
    g.sdel[s] = 1;
    for (int k = 0; k < 2; ++k) {
        uint32_t v = s << 1 | k;
        uint32_t nv = g.arc_n(v);
        Arc* av = g.arc_a(v);
        for (uint32_t i = 0; i < nv; ++i) {
            av[i].del = 1;
            arc_del(g, av[i].v ^ 1, v ^ 1, 1);
        }
    }
}

// asg_arc_del_multi (asg.c:104-121): keep the first arc per (v, w)
int del_multi(Graph& g) {
    std::vector<uint32_t> cnt(g.n_vtx(), 0);
    uint32_t n_multi = 0;
    for (uint32_t v = 0; v < g.n_vtx(); ++v) {
        int32_t nv = g.arc_n(v);
        Arc* av = g.arc_a(v);
        if (nv < 2) continue;
        for (int32_t i = nv - 1; i >= 0; --i) ++cnt[av[i].v];
        for (int32_t i = nv - 1; i >= 0; --i)
            if (--cnt[av[i].v] != 0) av[i].del = 1, ++n_multi;
    }
    if (n_multi) cleanup(g);
    return n_multi;
}

// asg_arc_del_asymm (asg.c:124-138)
int del_asymm(Graph& g) {
    uint32_t n_asymm = 0;
    for (size_t e = 0; e < g.arc.size(); ++e) {
        uint32_t v = g.arc[e].v ^ 1, u = static_cast<uint32_t>(g.arc[e].ul >> 32) ^ 1;
        uint32_t nv = g.arc_n(v), i;
        Arc* av = g.arc_a(v);
        for (i = 0; i < nv; ++i)
            if (av[i].v == u) break;
        if (i == nv) g.arc[e].del = 1, ++n_asymm;
    }
    if (n_asymm) cleanup(g);
    return n_asymm;
}

void symm(Graph& g) {
    del_multi(g);
    del_asymm(g);
    g.is_symm = true;
}

// asg_arc_del_short (asg.c:83-101)
int del_short(Graph& g, float drop_ratio) {
    uint32_t n_short = 0;
    for (uint32_t v = 0; v < g.n_vtx(); ++v) {
        uint32_t nv = g.arc_n(v);
        Arc* av = g.arc_a(v);
        if (nv < 2) continue;
        uint32_t thres = static_cast<uint32_t>(av[0].ol * drop_ratio + .499);
        uint32_t i;
        for (i = nv - 1; i >= 1 && av[i].ol < thres; --i) {
        }
        for (i = i + 1; i < nv; ++i) av[i].del = 1, ++n_short;
    }
    if (n_short) {
        cleanup(g);
        symm(g);
    }
    return n_short;
}

// asg_is_utg_end (asg.c:204-221)
constexpr int ET_MERGEABLE = 0, ET_TIP = 1, ET_MULTI_OUT = 2, ET_MULTI_NEI = 3;

int is_utg_end(Graph& g, uint32_t v, uint64_t* lw) {
    uint32_t nv0 = g.arc_n(v ^ 1);
    Arc* av = g.arc_a(v ^ 1);
    int i0 = -1;
    uint32_t nv = 0;
    for (uint32_t i = 0; i < nv0; ++i)
        if (!av[i].del) i0 = static_cast<int>(i), ++nv;
    if (nv == 0) return ET_TIP;
    if (nv > 1) return ET_MULTI_OUT;
    if (lw) *lw = av[i0].ul << 32 | av[i0].v;
    uint32_t w = av[i0].v ^ 1;
    uint32_t nw0 = g.arc_n(w), nw = 0;
    Arc* aw = g.arc_a(w);
    for (uint32_t i = 0; i < nw0; ++i)
        if (!aw[i].del) ++nw;
    if (nw != 1) return ET_MULTI_NEI;
    return ET_MERGEABLE;
}

// asg_extend (asg.c:223-236)
int extend(Graph& g, uint32_t v, int max_ext, std::vector<uint64_t>& a) {
    int ret;
    uint64_t lw = 0;
    a.clear();
    a.push_back(v);
    do {
        ret = is_utg_end(g, v ^ 1, &lw);
        if (ret != 0) break;
        a.push_back(lw);
        v = static_cast<uint32_t>(lw);
    } while (--max_ext > 0);
    return ret;
}

int cut_tip(Graph& g, int max_ext) {
    std::vector<uint64_t> a;
    uint32_t cnt = 0;
    for (uint32_t v = 0; v < g.n_vtx(); ++v) {
        if (g.sdel[v >> 1]) continue;
        if (is_utg_end(g, v, nullptr) != ET_TIP) continue;
        if (extend(g, v, max_ext, a) == ET_MERGEABLE) continue;
        for (uint64_t x : a) seq_del(g, static_cast<uint32_t>(x) >> 1);
        ++cnt;
    }
    if (cnt > 0) cleanup(g);
    return cnt;
}

int cut_internal(Graph& g, int max_ext) {
    std::vector<uint64_t> a;
    uint32_t cnt = 0;
    for (uint32_t v = 0; v < g.n_vtx(); ++v) {
        if (g.sdel[v >> 1]) continue;
        if (is_utg_end(g, v, nullptr) != ET_MULTI_NEI) continue;
        if (extend(g, v, max_ext, a) != ET_MULTI_NEI) continue;
        for (uint64_t x : a) seq_del(g, static_cast<uint32_t>(x) >> 1);
        ++cnt;
    }
    if (cnt > 0) cleanup(g);
    return cnt;
}

int cut_biloop(Graph& g, int max_ext) {
    std::vector<uint64_t> a;
    uint32_t cnt = 0;
    for (uint32_t v = 0; v < g.n_vtx(); ++v) {
        if (g.sdel[v >> 1]) continue;
        if (is_utg_end(g, v, nullptr) != ET_MULTI_NEI) continue;
        if (extend(g, v, max_ext, a) != ET_MULTI_OUT) continue;
        uint32_t x = static_cast<uint32_t>(a.back()) ^ 1;
        uint32_t w = UINT32_MAX, ov = 0, ox = 0;
        uint32_t nv = g.arc_n(v ^ 1);
        Arc* av = g.arc_a(v ^ 1);
        for (uint32_t i = 0; i < nv; ++i)
            if (!av[i].del) w = av[i].v ^ 1;
        assert(w != UINT32_MAX);
        uint32_t nw = g.arc_n(w);
        Arc* aw = g.arc_a(w);
        for (uint32_t i = 0; i < nw; ++i) {
            if (aw[i].del) continue;
            if (aw[i].v == x) ox = aw[i].ol;
            if (aw[i].v == v) ov = aw[i].ol;
        }
        if (ov == 0 && ox == 0) continue;
        if (ov > ox) {
            arc_del(g, w, x, 1);
            arc_del(g, x ^ 1, w ^ 1, 1);
            ++cnt;
        }
    }
    if (cnt > 0) cleanup(g);
    return cnt;
}

// ---- bubble popping (asg.c:312-433) ----

struct BInfo {
    uint32_t p, d, c, r;
    uint8_t s;
};

int count_out(Graph& g, uint32_t v) {
    uint32_t nv = g.arc_n(v), n = 0;
    const Arc* av = g.arc_a(v);
    for (uint32_t i = 0; i < nv; ++i)
        if (!av[i].del) ++n;
    return static_cast<int>(n);
}

void bub_backtrack(Graph& g, uint32_t v0, std::vector<uint32_t>& S,
                   std::vector<uint32_t>& b, std::vector<uint32_t>& e,
                   std::vector<BInfo>& bi) {
    assert(S.size() == 1);
    for (uint32_t w : b) g.sdel[w >> 1] = 1;
    for (uint32_t ai : e) {
        Arc* a = &g.arc[ai];
        a->del = 1;
        arc_del(g, a->v ^ 1, static_cast<uint32_t>(a->ul >> 32) ^ 1, 1);
    }
    uint32_t v = S[0];
    do {
        uint32_t u = bi[v].p;
        g.sdel[v >> 1] = 0;
        arc_del(g, u, v, 0);
        arc_del(g, v ^ 1, u ^ 1, 0);
        v = u;
    } while (v != v0);
}

uint64_t bub_pop1(Graph& g, uint32_t v0, int max_dist, std::vector<BInfo>& bi) {
    uint64_t n_pop = 0;
    if (g.sdel[v0 >> 1]) return 0;
    if (g.arc_n(v0) < 2) return 0;
    std::vector<uint32_t> S, T, b, e;
    uint32_t n_pending = 0;
    bi[v0].c = bi[v0].d = 0;
    S.push_back(v0);
    do {
        uint32_t v = S.back();
        S.pop_back();
        uint32_t d = bi[v].d, c = bi[v].c;
        uint32_t nv = g.arc_n(v);
        Arc* av = g.arc_a(v);
        assert(nv > 0);
        uint32_t i;
        bool abort = false;
        for (i = 0; i < nv; ++i) {
            uint32_t w = av[i].v, l = arc_len(av[i]);
            BInfo* t = &bi[w];
            if (w == v0) {
                abort = true;
                break;
            }
            if (av[i].del) continue;
            e.push_back(static_cast<uint32_t>((g.idx[v] >> 32) + i));
            if (d + l > static_cast<uint32_t>(max_dist)) break;
            if (t->s == 0) {
                b.push_back(w);
                t->p = v, t->s = 1, t->d = d + l;
                t->r = count_out(g, w ^ 1);
                ++n_pending;
            } else {
                if (c + 1 > t->c || (c + 1 == t->c && d + l > t->d)) t->p = v;
                if (c + 1 > t->c) t->c = c + 1;
                if (d + l < t->d) t->d = d + l;
            }
            assert(t->r > 0);
            if (--(t->r) == 0) {
                if (g.arc_n(w))
                    S.push_back(w);
                else
                    T.push_back(w);
                --n_pending;
            }
        }
        if (abort || i < nv || S.empty()) goto pop_reset;
    } while (S.size() > 1 || n_pending);
    bub_backtrack(g, v0, S, b, e, bi);
    n_pop = 1 | static_cast<uint64_t>(T.size()) << 32;
pop_reset:
    for (uint32_t w : b) {
        bi[w].s = 0;
        bi[w].c = bi[w].d = 0;
    }
    return n_pop;
}

uint64_t pop_bubble(Graph& g, int max_dist) {
    if (!g.is_symm) symm(g);
    std::vector<BInfo> bi(g.n_vtx());
    std::memset(bi.data(), 0, bi.size() * sizeof(BInfo));
    uint64_t n_pop = 0;
    for (uint32_t v = 0; v < g.n_vtx(); ++v) {
        uint32_t nv = g.arc_n(v);
        if (nv < 2 || g.sdel[v >> 1]) continue;
        Arc* av = g.arc_a(v);
        uint32_t n_arc = 0;
        for (uint32_t i = 0; i < nv; ++i)
            if (!av[i].del) ++n_arc;
        if (n_arc > 1) n_pop += bub_pop1(g, v, max_dist, bi);
    }
    if (n_pop) cleanup(g);
    return n_pop;
}

}  // namespace

// ---- C ABI ----

extern "C" {

struct MaFinalizeOut {
    // final read-level graph (compacted, sorted)
    int64_t n_arc;
    uint64_t* ul;
    uint32_t* av;
    uint32_t* aol;
    uint8_t* sdel;  // n_seq
    // unitigs (filled when do_ug)
    int64_t n_utg;
    uint32_t* utg_len;
    uint8_t* utg_circ;
    uint32_t* utg_start;
    uint32_t* utg_end;
    int64_t* path_off;  // n_utg+1 offsets into path
    int64_t n_path;
    uint64_t* path;  // (vertex<<32 | l)
    int64_t n_uarc;
    uint64_t* uarc_ul;
    uint32_t* uarc_v;
    uint32_t* uarc_ol;
    uint32_t* uarc_cnt;  // per ug vertex (2*n_utg)
    // pass counters, for logging: tips0, pop0, [per round: short, tip, pop]...
    int64_t counters[64];
};

static uint64_t pack_pop(uint64_t p) { return p; }

MaFinalizeOut* ma_graph_finalize(
    int64_t n_seq, const uint32_t* slen, const uint8_t* sdel_in,
    int64_t n_arc, const uint64_t* ul, const uint32_t* av,
    const uint32_t* aol, int is_symm, int stage, int max_ext, int bub_dist,
    int n_rounds, double min_drop, double max_drop, double final_drop,
    int do_ug) {
    Graph g;
    g.slen.assign(slen, slen + n_seq);
    g.sdel.assign(sdel_in, sdel_in + n_seq);
    g.arc.resize(n_arc);
    for (int64_t i = 0; i < n_arc; ++i) {
        g.arc[i].ul = ul[i];
        g.arc[i].v = av[i];
        g.arc[i].ol = aol[i];
        g.arc[i].del = 0;
    }
    g.is_symm = is_symm != 0;
    arc_index(g);

    auto* out = new MaFinalizeOut();
    std::memset(out->counters, 0, sizeof(out->counters));
    int64_t* C = out->counters;  // [tips, pops(packed sums), shorts, internal, biloop]

    // main.c:160-188 stage gating.  The per-round drop ratio is computed in
    // FLOAT arithmetic exactly as the reference (its ma_opt_t members are
    // float; double math can differ by 1 ulp and shift a threshold).
    float fmin = static_cast<float>(min_drop), fmax = static_cast<float>(max_drop);
    if (stage >= 7) {
        C[0] += cut_tip(g, max_ext);
        C[1] += static_cast<int64_t>(pack_pop(pop_bubble(g, bub_dist)));
    }
    if (stage >= 9) {
        for (int i = 0; i <= n_rounds; ++i) {
            float r = fmin + (fmax - fmin) / n_rounds * i;
            int ns = del_short(g, r);
            C[2] += ns;
            if (ns != 0) {
                C[0] += cut_tip(g, max_ext);
                C[1] += static_cast<int64_t>(pop_bubble(g, bub_dist));
            }
        }
    }
    if (stage >= 10) {
        C[3] += cut_internal(g, 1);
        C[4] += cut_biloop(g, max_ext);
        C[0] += cut_tip(g, max_ext);
        C[1] += static_cast<int64_t>(pop_bubble(g, bub_dist));
    }
    if (stage >= 11) {
        int ns = del_short(g, static_cast<float>(final_drop));
        C[2] += ns;
        if (ns != 0) {
            C[0] += cut_tip(g, max_ext);
            C[1] += static_cast<int64_t>(pop_bubble(g, bub_dist));
        }
    }

    // export final read-level graph
    out->n_arc = static_cast<int64_t>(g.arc.size());
    out->ul = static_cast<uint64_t*>(std::malloc(g.arc.size() * 8 + 1));
    out->av = static_cast<uint32_t*>(std::malloc(g.arc.size() * 4 + 1));
    out->aol = static_cast<uint32_t*>(std::malloc(g.arc.size() * 4 + 1));
    for (size_t i = 0; i < g.arc.size(); ++i) {
        out->ul[i] = g.arc[i].ul;
        out->av[i] = g.arc[i].v;
        out->aol[i] = g.arc[i].ol;
    }
    out->sdel = static_cast<uint8_t*>(std::malloc(n_seq + 1));
    std::memcpy(out->sdel, g.sdel.data(), n_seq);

    out->n_utg = 0;
    out->n_path = 0;
    out->n_uarc = 0;
    out->utg_len = nullptr;
    out->utg_circ = nullptr;
    out->utg_start = nullptr;
    out->utg_end = nullptr;
    out->path_off = nullptr;
    out->path = nullptr;
    out->uarc_ul = nullptr;
    out->uarc_v = nullptr;
    out->uarc_ol = nullptr;
    out->uarc_cnt = nullptr;
    if (!do_ug) return out;

    // ---- unitig generation (ma_ug_gen, asm.c:121-210) ----
    uint32_t n_vtx = g.n_vtx();
    std::vector<int64_t> mark(n_vtx, 0);
    std::deque<uint64_t> q;
    struct Utg {
        uint32_t len, start, end;
        uint8_t circ;
        std::vector<uint64_t> a;
    };
    std::vector<Utg> utgs;
    for (uint32_t v = 0; v < n_vtx; ++v) {
        if (g.sdel[v >> 1] || g.arc_n(v) == 0 || mark[v]) continue;
        mark[v] = 1;
        q.clear();
        uint32_t start = v, end = v ^ 1, len = 0;
        uint32_t w = v;
        bool circ = false;
        while (true) {
            if (g.arc_n(w) != 1) break;
            uint32_t x = g.arc_a(w)[0].v;
            if (g.arc_n(x ^ 1) != 1) break;
            mark[x] = mark[w ^ 1] = 1;
            uint32_t l = arc_len(g.arc_a(w)[0]);
            q.push_back(static_cast<uint64_t>(w) << 32 | l);
            end = x ^ 1;
            len += l;
            w = x;
            if (x == v) break;
        }
        if (start != (end ^ 1) || q.empty()) {  // linear
            uint32_t l = g.slen[end >> 1];
            q.push_back(static_cast<uint64_t>(end ^ 1) << 32 | l);
            len += l;
            uint32_t x = v;
            while (true) {
                if (g.arc_n(x ^ 1) != 1) break;
                uint32_t wv = g.arc_a(x ^ 1)[0].v ^ 1;
                if (g.arc_n(wv) != 1) break;
                mark[x] = mark[wv ^ 1] = 1;
                l = arc_len(g.arc_a(wv)[0]);
                q.push_front(static_cast<uint64_t>(wv) << 32 | l);
                start = wv;
                len += l;
                x = wv;
            }
        } else {
            start = end = UINT32_MAX;
            circ = true;
        }
        if (start != UINT32_MAX) mark[start] = mark[end] = 1;
        Utg u;
        u.len = len;
        u.start = start;
        u.end = end;
        u.circ = circ;
        u.a.assign(q.begin(), q.end());
        utgs.push_back(std::move(u));
    }

    // unitig-level arcs (asm.c:184-207)
    std::vector<int64_t> vmark(n_vtx, -1);
    for (size_t i = 0; i < utgs.size(); ++i) {
        if (utgs[i].circ) continue;
        vmark[utgs[i].start] = static_cast<int64_t>(i) << 1 | 0;
        vmark[utgs[i].end] = static_cast<int64_t>(i) << 1 | 1;
    }
    std::vector<Arc> uarc;
    for (size_t i = 0; i < g.arc.size(); ++i) {
        Arc* p = &g.arc[i];
        if (p->del) continue;
        if (vmark[p->ul >> 32 ^ 1] >= 0 && vmark[p->v] >= 0) {
            uint32_t u2 = static_cast<uint32_t>(vmark[p->ul >> 32 ^ 1]) ^ 1;
            int64_t l2 = static_cast<int64_t>(utgs[u2 >> 1].len) - p->ol;
            if (l2 < 0) l2 = 1;
            Arc a;
            a.ul = static_cast<uint64_t>(u2) << 32 | static_cast<uint64_t>(l2);
            a.v = static_cast<uint32_t>(vmark[p->v]);
            a.ol = p->ol;
            a.del = 0;
            uarc.push_back(a);
        }
    }
    // cleanup of the unitig graph: first sort (reference radix order). The
    // arc list is built in scan order; the reference radix-sorts it once.
    // Reproduce via the shared exact radix on (ul) keys.
    {
        int64_t n = static_cast<int64_t>(uarc.size());
        std::vector<uint64_t> keys(n);
        std::vector<int64_t> idx(n);
        for (int64_t i = 0; i < n; ++i) keys[i] = uarc[i].ul, idx[i] = i;
        ma_radix_argsort_u64(keys.data(), idx.data(), n);
        std::vector<Arc> sorted(n);
        for (int64_t i = 0; i < n; ++i) sorted[i] = uarc[idx[i]];
        uarc.swap(sorted);
    }
    Graph ug;
    ug.arc = uarc;
    ug.slen.resize(utgs.size());
    for (size_t i = 0; i < utgs.size(); ++i) ug.slen[i] = utgs[i].len;
    ug.sdel.assign(utgs.size(), 0);
    arc_index(ug);
    cleanup(ug);

    // export
    int64_t nu = static_cast<int64_t>(utgs.size());
    out->n_utg = nu;
    out->utg_len = static_cast<uint32_t*>(std::malloc(nu * 4 + 1));
    out->utg_circ = static_cast<uint8_t*>(std::malloc(nu + 1));
    out->utg_start = static_cast<uint32_t*>(std::malloc(nu * 4 + 1));
    out->utg_end = static_cast<uint32_t*>(std::malloc(nu * 4 + 1));
    out->path_off = static_cast<int64_t*>(std::malloc((nu + 1) * 8));
    int64_t npath = 0;
    for (auto& u : utgs) npath += static_cast<int64_t>(u.a.size());
    out->n_path = npath;
    out->path = static_cast<uint64_t*>(std::malloc(npath * 8 + 1));
    int64_t off = 0;
    for (int64_t i = 0; i < nu; ++i) {
        out->utg_len[i] = utgs[i].len;
        out->utg_circ[i] = utgs[i].circ;
        out->utg_start[i] = utgs[i].start;
        out->utg_end[i] = utgs[i].end;
        out->path_off[i] = off;
        std::memcpy(out->path + off, utgs[i].a.data(), utgs[i].a.size() * 8);
        off += static_cast<int64_t>(utgs[i].a.size());
    }
    out->path_off[nu] = off;
    int64_t na = static_cast<int64_t>(ug.arc.size());
    out->n_uarc = na;
    out->uarc_ul = static_cast<uint64_t*>(std::malloc(na * 8 + 1));
    out->uarc_v = static_cast<uint32_t*>(std::malloc(na * 4 + 1));
    out->uarc_ol = static_cast<uint32_t*>(std::malloc(na * 4 + 1));
    for (int64_t i = 0; i < na; ++i) {
        out->uarc_ul[i] = ug.arc[i].ul;
        out->uarc_v[i] = ug.arc[i].v;
        out->uarc_ol[i] = ug.arc[i].ol;
    }
    out->uarc_cnt = static_cast<uint32_t*>(std::malloc(nu * 2 * 4 + 1));
    for (int64_t i = 0; i < nu * 2; ++i)
        out->uarc_cnt[i] = ug.arc_n(static_cast<uint32_t>(i));
    return out;
}

void ma_finalize_free(MaFinalizeOut* p) {
    if (!p) return;
    std::free(p->ul);
    std::free(p->av);
    std::free(p->aol);
    std::free(p->sdel);
    std::free(p->utg_len);
    std::free(p->utg_circ);
    std::free(p->utg_start);
    std::free(p->utg_end);
    std::free(p->path_off);
    std::free(p->path);
    std::free(p->uarc_ul);
    std::free(p->uarc_v);
    std::free(p->uarc_ol);
    std::free(p->uarc_cnt);
    delete p;
}

}  // extern "C"
