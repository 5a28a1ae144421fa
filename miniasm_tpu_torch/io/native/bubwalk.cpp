// The bubble pass's ordered commit (reference asg_pop_bubble, asg.c:405-433)
// over the verdicts of the device's bubble BFS (K4, csrc/bubble.cu), in
// place on the hybrid cleaner's graph columns (graph/devbub.py
// pop_bubbles_dev calls it once a pass through ctypes).
//
// Sources are walked in the order given (ascending).  Each one is first
// re-validated against the live graph like the reference's scan
// (asg.c:420-424).  Its device verdict holds while the bubble's read set
// {v0, v0^1} u visited u visited^1 is disjoint from the vertices earlier
// commits touched; a stale source runs the sequential BFS again
// (asg_bub_pop1, asg.c:360-403) against the live graph.  A popped bubble
// is committed as asg_bub_backtrack does (asg.c:338-357).
//
// BFS semantics, as the kernel and the reference:
//   - an arc back to v0 aborts even when it is deleted (asg.c:379-381);
//   - a live arc past max_dist aborts;
//   - a first visit sets parent, distance and the pending in-arc count but
//     leaves the read count c at 0; a revisit takes the parent when
//     c+1 > c_w, or c+1 == c_w and d+l > d_w, against the running values;
//   - a vertex with no arc slots is a tip and never enters the stack;
//   - success: the stack holds one vertex (the sink), nothing pending.

#include <cstdint>
#include <vector>

namespace {

struct Walk {
    int64_t n_vtx;
    const int32_t *av, *au, *al;
    const int64_t *start;
    const int32_t *cnt;
    uint8_t *adel, *sdel;
    // per-vertex BFS state, valid where stamp == cur (one stamp a source:
    // fewer sources than vertices, so it never wraps)
    std::vector<uint32_t> stamp;
    uint32_t cur = 0;
    std::vector<int64_t> d, c, r;
    std::vector<int32_t> parent, stack, vlist;

    Walk(int64_t n) : n_vtx(n), stamp(n), d(n), c(n), r(n), parent(n) {}

    int64_t live_out(int32_t v) const {
        int64_t n = 0;
        for (int64_t a = start[v], e = start[v] + cnt[v]; a < e; ++a)
            n += adel[a] == 0;
        return n;
    }

    // tombstone (del = 1) or restore (del = 0) every arc v -> w
    void arc_del(int32_t v, int32_t w, uint8_t del) {
        for (int64_t a = start[v], e = start[v] + cnt[v]; a < e; ++a)
            if (av[a] == w) adel[a] = del;
    }

    // the sequential BFS of one source on the live graph: vlist takes the
    // visited vertices in visit order, parent[] their parents; returns
    // whether the bubble holds, with its sink and tip count
    bool pop1(int32_t v0, int64_t max_dist, int32_t *sink, int64_t *ntip) {
        ++cur;
        vlist.assign(1, v0);
        stack.assign(1, v0);
        stamp[v0] = cur;
        d[v0] = 0;
        c[v0] = 0;
        int64_t npend = 0, tips = 0;
        for (;;) {
            const int32_t v = stack.back();
            stack.pop_back();
            const int64_t dv = d[v], cv = c[v];
            for (int64_t a = start[v], e = start[v] + cnt[v]; a < e; ++a) {
                const int32_t w = av[a];
                if (w == v0) return false;
                if (adel[a]) continue;
                const int64_t dl = dv + al[a];
                if (dl > max_dist) return false;
                if (stamp[w] != cur) {
                    stamp[w] = cur;
                    vlist.push_back(w);
                    parent[w] = v;
                    d[w] = dl;
                    c[w] = 0;
                    r[w] = live_out(w ^ 1);
                    ++npend;
                } else {
                    if (cv + 1 > c[w] || (cv + 1 == c[w] && dl > d[w]))
                        parent[w] = v;
                    if (cv + 1 > c[w]) c[w] = cv + 1;
                    if (dl < d[w]) d[w] = dl;
                }
                if (--r[w] == 0) {
                    if (cnt[w]) stack.push_back(w);
                    else ++tips;
                    --npend;
                }
            }
            if (stack.empty()) return false;
            if (stack.size() == 1 && npend == 0) {
                *sink = stack[0];
                *ntip = tips;
                return true;
            }
        }
    }

    // asg_bub_backtrack: delete every visited read and every live out-arc
    // of the processed vertices with its complement, then restore the
    // path sink -> v0 through parent[]; false when that path leaves the
    // visited set (a malformed verdict)
    bool commit(int32_t v0, const int32_t *vset, int64_t n, int32_t sink) {
        for (int64_t k = 1; k < n; ++k) sdel[vset[k] >> 1] = 1;
        for (int64_t k = 0; k < n; ++k) {
            const int32_t u = k ? vset[k] : v0;
            if (u == sink) continue;
            for (int64_t a = start[u], e = start[u] + cnt[u]; a < e; ++a) {
                if (adel[a]) continue;
                adel[a] = 1;
                arc_del(av[a] ^ 1, au[a] ^ 1, 1);
            }
        }
        if (sink < 0 || sink >= n_vtx || stamp[sink] != cur) return false;
        int32_t v = sink;
        for (int64_t steps = 0; v != v0; ++steps) {
            const int32_t u = parent[v];
            if (steps >= n || u < 0 || u >= n_vtx || stamp[u] != cur)
                return false;
            sdel[v >> 1] = 0;
            arc_del(u, v, 0);
            arc_del(v ^ 1, u ^ 1, 0);
            v = u;
        }
        return true;
    }
};

}  // namespace

extern "C" {

// The ordered commit of one bubble pass.  Graph columns: av, au, al (n_arc)
// int32; start (n_vtx) int64, cnt (n_vtx) int32; adel (n_arc) and sdel
// (n_vtx / 2) bytes, written in place.  The device's verdicts of the
// n_cand sources cand: ok bytes, nb, ntip, sink (n_cand) int32 and the
// (n_cand, K) int32 tables vis and par.  out[4] = {n_pop | n_tip << 32,
// candidates, commits, sources recomputed on the host}.  Returns 0, or
// 1 when a source or a verdict names a vertex outside the graph or a
// path outside its visited set (the graph is then partly committed).
int ma_bubble_walk(int64_t n_vtx, const int32_t *av, const int32_t *au,
                   const int32_t *al, const int64_t *start,
                   const int32_t *cnt, uint8_t *adel, uint8_t *sdel,
                   int64_t n_cand, const int32_t *cand, const uint8_t *ok,
                   const int32_t *nb, const int32_t *ntip,
                   const int32_t *sink, const int32_t *vis,
                   const int32_t *par, int64_t K, int64_t max_dist,
                   int64_t *out) {
    Walk w(n_vtx);
    w.av = av;
    w.au = au;
    w.al = al;
    w.start = start;
    w.cnt = cnt;
    w.adel = adel;
    w.sdel = sdel;
    std::vector<uint8_t> touched(n_vtx, 0);
    int64_t n_pop = 0, n_tip = 0, n_redo = 0;
    for (int64_t j = 0; j < n_cand; ++j) {
        const int32_t v0 = cand[j];
        if (v0 < 0 || v0 >= n_vtx) return 1;
        if (sdel[v0 >> 1] || cnt[v0] < 2 || w.live_out(v0) < 2) continue;
        const int64_t nbj = nb[j];
        if (nbj < 1 || nbj > K) return 1;
        const int32_t *vset = vis + j * K;
        bool stale = touched[v0] || touched[v0 ^ 1];
        for (int64_t k = 0; k < nbj; ++k) {
            const int32_t x = vset[k];
            if (x < 0 || x >= n_vtx) return 1;
            stale = stale || touched[x] || touched[x ^ 1];
        }
        int64_t n, tips;
        int32_t snk;
        if (stale) {
            ++n_redo;
            if (!w.pop1(v0, max_dist, &snk, &tips)) continue;
            vset = w.vlist.data();
            n = static_cast<int64_t>(w.vlist.size());
        } else {
            if (!ok[j]) continue;
            ++w.cur;
            const int32_t *pj = par + j * K;
            for (int64_t k = 0; k < nbj; ++k) {
                w.stamp[vset[k]] = w.cur;
                w.parent[vset[k]] = pj[k];
            }
            snk = sink[j];
            tips = ntip[j];
            n = nbj;
        }
        if (!w.commit(v0, vset, n, snk)) return 1;
        ++n_pop;
        n_tip += tips;
        touched[v0] = touched[v0 ^ 1] = 1;
        for (int64_t k = 0; k < n; ++k)
            touched[vset[k]] = touched[vset[k] ^ 1] = 1;
    }
    out[0] = static_cast<int64_t>(static_cast<uint64_t>(n_pop)
                                  | static_cast<uint64_t>(n_tip) << 32);
    out[1] = n_cand;
    out[2] = n_pop;
    out[3] = n_redo;
    return 0;
}

}  // extern "C"
