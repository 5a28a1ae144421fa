"""The benchmark's plain reference: miniasm 0.3-r179 from PAF to GFA.

A straightforward rendering of lh3/miniasm's steps in NumPy and Python
(main.c, hit.c, asg.c, asm.c), written for the benchmark and independent
of the program under test: it imports nothing of miniasm_tpu_torch.  The
order-dependent graph passes follow the C loops one vertex at a time;
the passes over hits, which read no state that the same pass writes, are
whole-array NumPy.  Two loops run in C (native.c, built on first use):
the PAF read and miniasm's radix order; paf.read_paf_numpy and
radix.radix_argsort are their specs, which the tests hold the C against.
Integer columns keep the C's 32-bit wrapping where the C relies on it, and
the float tests are float32 as in the C.

    gfa = assemble("reads.paf", ["-p", "ug"])      # the bytes of stdout
"""

from __future__ import annotations

import getopt
import io
import time

import numpy as np

from . import native
from .paf import read_paf

MA_HT_INT, MA_HT_QCONT, MA_HT_TCONT, MA_HT_SHORT_OVLP = -1, -2, -3, -4
ET_MERGEABLE, ET_TIP, ET_MULTI_OUT, ET_MULTI_NEI = 0, 1, 2, 3
M32 = 0xFFFFFFFF


class Opt:
    """ma_opt_t with ma_opt_init's defaults (common.c)."""

    def __init__(self):
        self.min_span, self.min_match, self.min_dp = 2000, 100, 3
        self.min_iden = 0.05
        self.max_hang, self.min_ovlp, self.int_frac = 1000, 2000, 0.8
        self.gap_fuzz, self.n_rounds, self.bub_dist, self.max_ext = \
            1000, 2, 50000, 4
        self.min_ovlp_drop_ratio, self.max_ovlp_drop_ratio = 0.5, 0.7
        self.final_ovlp_drop_ratio = 0.8


def parse_argv(argv):
    """miniasm's options (main.c:32-106).  Returns (opt, outfmt, paf)."""
    opt = Opt()
    outfmt = "ug"
    o_set = False
    opts, args = getopt.getopt(argv, "n:m:s:c:S:i:d:g:o:h:I:r:f:e:p:12VBRbF:")
    for c, a in opts:
        if c in ("-1", "-2", "-S", "-R", "-f", "-b", "-V"):
            raise NotImplementedError("the reference does not take %s" % c)
        if c == "-m":
            opt.min_match = int(a)
        elif c == "-i":
            opt.min_iden = float(a)
        elif c == "-s":
            opt.min_span = int(a)
        elif c == "-c":
            opt.min_dp = int(a)
        elif c == "-o":
            opt.min_ovlp, o_set = int(a), True
        elif c == "-d":
            opt.bub_dist = int(a)
        elif c == "-g":
            opt.gap_fuzz = int(a)
        elif c == "-h":
            opt.max_hang = int(a)
        elif c == "-I":
            opt.int_frac = float(a)
        elif c == "-e":
            opt.max_ext = int(a)
        elif c == "-p":
            outfmt = a
        elif c == "-n":
            opt.n_rounds = int(a) - 1
        elif c == "-F":
            opt.final_ovlp_drop_ratio = float(a)
        elif c == "-r":
            parts = a.split(",")
            opt.max_ovlp_drop_ratio = float(parts[0])
            if len(parts) > 1:
                opt.min_ovlp_drop_ratio = float(parts[1])
    if not o_set:
        opt.min_ovlp = opt.min_span
    if len(args) != 1 or outfmt not in ("ug", "paf"):
        raise NotImplementedError("the reference prints -p ug or paf")
    return opt, outfmt, args[0]


# ---------------------------------------------------------------- hits


def hit2arc(qid, qs, qe, tid, ts, te, rev, ql, tl, max_hang, int_frac,
            min_ovlp):
    """ma_hit2arc (miniasm.h) over arrays: (r, u, v, l, ol); r >= 0 is an
    arc whose l is r.  qs, qe, ts, te, ql, tl are int32 arrays, which wrap
    as the C's 32-bit arithmetic does; qid, tid int64."""
    rev = rev != 0
    tl5 = np.where(rev, tl - te, ts)
    tl3 = np.where(rev, ts, tl - te)
    qh3 = ql - qe
    ext5 = np.minimum(qs, tl5)
    ext3 = np.minimum(qh3, tl3)
    span = qe - qs
    tot = span + ext5 + ext3
    f = np.float32(int_frac)
    internal = (ext5 > max_hang) | (ext3 > max_hang) | \
        (span.astype(np.float32) < tot.astype(np.float32) * f)
    qcont = (qs <= tl5) & (qh3 <= tl3)
    tcont = (qs >= tl5) & (qh3 >= tl3)
    from5 = qs > tl5
    l = np.where(from5, qs - tl5, qh3 - tl3)
    short = (tot < min_ovlp) | ((te - ts) + ext5 + ext3 < min_ovlp)
    r = np.where(internal, MA_HT_INT,
                 np.where(qcont, MA_HT_QCONT,
                          np.where(tcont, MA_HT_TCONT,
                                   np.where(short, MA_HT_SHORT_OVLP, l))))
    u = (qid << 1) | (~from5).astype(np.int64)
    v = (tid << 1) | np.where(from5, rev, ~rev).astype(np.int64)
    ol = ql - l
    return r, u, v, l, ol


def hit_sub(h, n_seq, min_dp, min_iden, end_clip):
    """ma_hit_sub (hit.c): each read's first longest region covered at
    least min_dp deep by its hits as query.  Returns (s, e, del) uint32 /
    bool arrays; a read with no hit as query keeps s = e = 0, del = 0."""
    qid = h["qid"]
    f = np.float32(min_iden)
    evs = (h["qs"] + end_clip) & M32
    eve = (h["qe"] - end_clip) & M32
    ok = (h["tid"] != qid) & \
        ~(h["ml"].astype(np.float32) < h["bl"].astype(np.float32) * f) & \
        (eve > evs)
    has_q = np.zeros(n_seq, dtype=bool)
    has_q[qid] = True
    # each event as qid<<32 | key, key = pos<<1 | is_end (uint32), sorted
    q = qid[ok] << 32
    m = q.size
    both = np.empty(2 * m, dtype=np.int64)
    both[:m] = q | ((evs[ok] << 1) & M32)
    both[m:] = q | (((eve[ok] << 1) | 1) & M32)
    del q
    both.sort()
    delta = 1 - 2 * (both & 1).astype(np.int32)
    dp = np.cumsum(delta, dtype=np.int32)
    old = dp - delta
    start_tr = (old < min_dp) & (dp >= min_dp)
    end_tr = (old >= min_dp) & (dp < min_dp)
    ti = np.flatnonzero(start_tr | end_tr)
    pos = (both[ti] & M32) >> 1
    prev = np.concatenate([[0], pos[:-1]])
    tseg = both[ti] >> 32
    length = np.where(end_tr[ti], pos - prev, -1)
    best = np.full(n_seq, -1, dtype=np.int64)
    np.maximum.at(best, tseg, length)
    cand = np.flatnonzero((length == best[tseg]) & (length > 0))
    first = np.full(n_seq, -1, dtype=np.int64)
    # the first crossing of each read's best length (candidates ascend)
    rs = tseg[cand]
    firsts = np.flatnonzero(np.concatenate([[True], rs[1:] != rs[:-1]])) \
        if cand.size else cand
    first[rs[firsts]] = cand[firsts]
    region = first >= 0
    s = np.zeros(n_seq, dtype=np.int64)
    e = np.zeros(n_seq, dtype=np.int64)
    fi = first[region]
    s[region] = (prev[fi] - end_clip) & M32
    e[region] = (pos[fi] + end_clip) & M32
    dele = has_q & ~region
    return s, e, dele


def _live(h, keep):
    return {k: v[keep] for k, v in h.items()}


def hit_cut(h, sub, min_span):
    """ma_hit_cut (hit.c): the hits in each read's trimmed frame, those
    of deleted reads and those shorter than min_span dropped.  int32 and
    uint32 arrays wrap as the C's 32-bit arithmetic does."""
    s, e, dele = sub
    qi, ti = h["qid"], h["tid"]
    i32, u32 = np.int32, np.uint32
    s32, e32 = s.astype(i32), e.astype(i32)
    rq_s, rq_e, rt_s, rt_e = s32[qi], e32[qi], s32[ti], e32[ti]
    qs0, qe0, ts0, te0 = (h[k].astype(i32) for k in ("qs", "qe", "ts", "te"))
    rev = h["rev"] != 0
    w = np.where
    qs1 = w(rev, w(te0 < rt_e, qs0, qs0 + (te0 - rt_e)),
            w(ts0 > rt_s, qs0, qs0 + (rt_s - ts0)))
    qe1 = w(rev, w(ts0 > rt_s, qe0, qe0 - (rt_s - ts0)),
            w(te0 < rt_e, qe0, qe0 - (te0 - rt_e)))
    ts1 = w(rev, w(qe0 < rq_e, ts0, ts0 + (qe0 - rq_e)),
            w(qs0 > rq_s, ts0, ts0 + (rq_s - qs0)))
    te1 = w(rev, w(qs0 > rq_s, te0, te0 - (rq_s - qs0)),
            w(qe0 < rq_e, te0, te0 - (qe0 - rq_e)))
    uqs, uqe, uts, ute = (x.view(u32) for x in (rq_s, rq_e, rt_s, rt_e))
    qs2 = (np.maximum(qs1.view(u32), uqs) - uqs).view(i32)
    qe2 = (np.minimum(qe1.view(u32), uqe) - uqs).view(i32)
    ts2 = (np.maximum(ts1.view(u32), uts) - uts).view(i32)
    te2 = (np.minimum(te1.view(u32), ute) - uts).view(i32)
    keep = ~dele[qi] & ~dele[ti] & (qe2 - qs2 >= min_span) & \
        (te2 - ts2 >= min_span)
    out = {k: v[keep] for k, v in h.items()}
    for k, v in (("qs", qs2), ("qe", qe2), ("ts", ts2), ("te", te2)):
        out[k] = v[keep].view(u32)
    return out


def _classify(h, sub, max_hang, int_frac, min_ovlp):
    s, e = sub[0], sub[1]
    i32 = np.int32
    lens = (e - s).astype(i32)
    return hit2arc(h["qid"], h["qs"].astype(i32), h["qe"].astype(i32),
                   h["tid"], h["ts"].astype(i32), h["te"].astype(i32),
                   h["rev"], lens[h["qid"]], lens[h["tid"]], max_hang,
                   int_frac, min_ovlp)


def hit_flt(h, sub, max_hang, min_ovlp):
    """ma_hit_flt (hit.c): hits that are arcs or containments under
    relaxed parameters (int_frac .5)."""
    r = _classify(h, sub, max_hang, 0.5, min_ovlp)[0]
    dele = sub[2]
    keep = ~dele[h["qid"]] & ~dele[h["tid"]] & \
        ((r >= 0) | (r == MA_HT_QCONT) | (r == MA_HT_TCONT))
    return _live(h, keep)


def hit_contained(h, sub, opt, names):
    """ma_hit_contained (hit.c): contained reads and reads in no hit
    deleted, the rest renumbered in order.  Returns (hits, sub, names)."""
    s, e, dele = sub
    r = _classify(h, sub, opt.max_hang, opt.int_frac, opt.min_ovlp)[0]
    n_seq = len(names)
    dd = dele.copy()
    dd[h["qid"][r == MA_HT_QCONT]] = True
    dd[h["tid"][r == MA_HT_TCONT]] = True
    used = np.zeros(n_seq, dtype=bool)
    used[h["qid"]] = True
    used[h["tid"]] = True
    keep_read = ~dd & used
    mp = np.where(keep_read, np.cumsum(keep_read) - 1, -1)
    kept = mp[h["qid"]] >= 0
    kept &= mp[h["tid"]] >= 0
    h = _live(h, kept)
    h["qid"] = mp[h["qid"]]
    h["tid"] = mp[h["tid"]]
    old = np.flatnonzero(keep_read)
    return h, (s[old], e[old], np.zeros(old.size, dtype=bool)), \
        [names[i] for i in old.tolist()]


# ---------------------------------------------------------------- graph


class Graph:
    """asg_t: arcs (u, l, v, ol, del) sorted by u<<32|l, and per read the
    length and the deletion mark; vertex v = read<<1|strand."""

    def __init__(self, u, l, v, ol, slen, sdel):
        self.u, self.l, self.v, self.ol = u, l, v, ol
        self.adel = np.zeros(len(u), dtype=bool)
        self.slen = slen
        self.sdel = sdel
        self.is_srt = False
        self.is_symm = False
        self.cleanup()

    @property
    def n_vtx(self):
        return 2 * len(self.slen)

    def cleanup(self):
        """asg_cleanup (asg.c): drop deleted arcs and arcs of deleted
        reads; sort by u<<32|l with miniasm's radix sort the first time;
        index the arcs by source vertex."""
        keep = ~self.adel & ~self.sdel[self.u >> 1] & ~self.sdel[self.v >> 1]
        u, l, v, ol = self.u[keep], self.l[keep], self.v[keep], self.ol[keep]
        if not self.is_srt:
            key = (u.astype(np.uint64) << np.uint64(32)) | \
                (l.astype(np.int64) & M32).astype(np.uint64)
            o = native.radix_order(key)
            u, l, v, ol = u[o], l[o], v[o], ol[o]
            self.is_srt = True
        self.u, self.l, self.v, self.ol = u, l, v, ol
        self.adel = np.zeros(len(u), dtype=bool)
        vt = np.arange(self.n_vtx)
        self.start = np.searchsorted(u, vt, side="left")
        self.cnt = np.searchsorted(u, vt, side="right") - self.start

    def lists(self):
        """The arrays as Python lists, for the sequential passes."""
        return (self.u.tolist(), self.l.tolist(), self.v.tolist(),
                self.ol.tolist(), self.start.tolist(), self.cnt.tolist())


def sg_gen(h, sub, opt):
    """ma_sg_gen (asm.c): an arc for each hit that classifies as one (not
    a self match); the query of a contained hit and an exact reverse
    self-match delete their read."""
    s, e, dele = sub
    r, u, v, l, ol = _classify(h, sub, opt.max_hang, opt.int_frac,
                               opt.min_ovlp)
    self_ = h["qid"] == h["tid"]
    sdel = dele.copy()
    pal = (r >= 0) & self_ & (h["qs"] == h["ts"]) & (h["qe"] == h["te"]) & \
        (h["rev"] != 0)
    sdel[h["qid"][pal | (r == MA_HT_QCONT)]] = True
    a = (r >= 0) & ~self_
    return Graph(u[a], l[a], v[a], ol[a], (e - s) & M32, sdel)


def symm(g):
    """asg_symm: del_multi (the first arc of each (u, v) stays), then
    del_asymm (an arc u->v without v^1->u^1 goes)."""
    key = (g.u << 32) | g.v
    o = np.argsort(key, kind="stable")
    ks = key[o]
    dup = np.zeros(len(key), dtype=bool)
    dup[o[1:]] = ks[1:] == ks[:-1]
    if dup.any():
        g.adel |= dup
        g.cleanup()
    key = (g.u << 32) | g.v
    comp = ((g.v ^ 1) << 32) | (g.u ^ 1)
    asym = ~np.isin(comp, key)
    if asym.any():
        g.adel |= asym
        g.cleanup()
    g.is_symm = True


def del_trans(g, fuzz):
    """asg_arc_del_trans (asg.c): Myers' transitive reduction."""
    u, l, v, ol, start, cnt = g.lists()
    sdel = g.sdel.tolist()
    mark = {}
    red = np.zeros(len(u), dtype=bool)
    for x in range(g.n_vtx):
        nv = cnt[x]
        if nv == 0:
            continue
        s0 = start[x]
        if sdel[x >> 1]:
            red[s0:s0 + nv] = True
            continue
        for i in range(s0, s0 + nv):
            mark[v[i]] = 1
        L = (l[s0 + nv - 1] + fuzz) & M32
        for i in range(s0, s0 + nv):
            w = v[i]
            if mark.get(w) != 1:
                continue
            li = l[i]
            sw, nw = start[w], cnt[w]
            for j in range(sw, sw + nw):
                if ((l[j] + li) & M32) > L:
                    break
                if mark.get(v[j]) == 1:
                    mark[v[j]] = 2
        for i in range(s0, s0 + nv):
            if mark.get(v[i]) == 2:
                red[i] = True
        mark.clear()
    if red.any():
        g.adel |= red
        g.cleanup()
        symm(g)


def del_short(g, ratio):
    """asg_arc_del_short (asg.c): per vertex of two or more arcs, the
    tail of arcs whose overlap is under (uint32)(ol0 * ratio + .499).
    Returns the arcs removed."""
    if len(g.u) == 0:
        return 0
    x = g.u
    first_ol = g.ol[g.start[x]]
    thres = ((first_ol.astype(np.float32) * np.float32(ratio)).astype(
        np.float64) + 0.499).astype(np.int64) & M32
    slot = np.arange(len(x)) - g.start[x]
    strong = (slot >= 1) & (g.ol >= thres)
    last = np.zeros(g.n_vtx, dtype=np.int64)
    np.maximum.at(last, x[strong], slot[strong])
    dele = (g.cnt[x] >= 2) & (slot >= 1) & (slot > last[x])
    n = int(dele.sum())
    if n:
        g.adel |= dele
        g.cleanup()
        symm(g)
    return n


class _Seq:
    """The sequential passes of asg.c over a graph's lists; deletions
    mark adel and sdel in place."""

    def __init__(self, g):
        self.g = g
        self.u, self.l, self.v, self.ol, self.start, self.cnt = g.lists()
        self.adel = g.adel.tolist()
        self.sdel = g.sdel.tolist()

    def done(self, changed):
        g = self.g
        g.adel = np.asarray(self.adel, dtype=bool)
        g.sdel = np.asarray(self.sdel, dtype=bool)
        if changed:
            g.cleanup()

    def n_live(self, x):
        s = self.start[x]
        return sum(1 for i in range(s, s + self.cnt[x]) if not self.adel[i])

    def utg_end(self, x):
        """asg_is_utg_end: (code, (l, w)) of x's backward side."""
        s, n = self.start[x ^ 1], self.cnt[x ^ 1]
        nv, i0 = 0, -1
        for i in range(s, s + n):
            if not self.adel[i]:
                i0, nv = i, nv + 1
        if nv == 0:
            return ET_TIP, None
        if nv > 1:
            return ET_MULTI_OUT, None
        lw = (self.l[i0], self.v[i0])
        if self.n_live(self.v[i0] ^ 1) != 1:
            return ET_MULTI_NEI, lw
        return ET_MERGEABLE, lw

    def extend(self, x, max_ext):
        """asg_extend: (code, [x, w1, w2, ...])."""
        chain = [x]
        while True:
            ret, lw = self.utg_end(x ^ 1)
            if ret != ET_MERGEABLE:
                break
            chain.append(lw[1])
            x = lw[1]
            max_ext -= 1
            if max_ext <= 0:
                break
        return ret, chain

    def arc_del(self, x, w, d):
        s = self.start[x]
        for i in range(s, s + self.cnt[x]):
            if self.v[i] == w:
                self.adel[i] = d

    def seq_del(self, sid):
        self.sdel[sid] = True
        for k in (0, 1):
            x = sid << 1 | k
            s = self.start[x]
            for i in range(s, s + self.cnt[x]):
                self.adel[i] = True
                self.arc_del(self.v[i] ^ 1, x ^ 1, True)


def cut_tip(g, max_ext):
    p = _Seq(g)
    n = 0
    for x in range(g.n_vtx):
        if p.sdel[x >> 1] or p.utg_end(x)[0] != ET_TIP:
            continue
        ret, chain = p.extend(x, max_ext)
        if ret == ET_MERGEABLE:
            continue
        for w in chain:
            p.seq_del(w >> 1)
        n += 1
    p.done(n > 0)
    return n


def cut_internal(g, max_ext):
    p = _Seq(g)
    n = 0
    for x in range(g.n_vtx):
        if p.sdel[x >> 1] or p.utg_end(x)[0] != ET_MULTI_NEI:
            continue
        ret, chain = p.extend(x, max_ext)
        if ret != ET_MULTI_NEI:
            continue
        for w in chain:
            p.seq_del(w >> 1)
        n += 1
    p.done(n > 0)
    return n


def cut_biloop(g, max_ext):
    p = _Seq(g)
    n = 0
    for x in range(g.n_vtx):
        if p.sdel[x >> 1] or p.utg_end(x)[0] != ET_MULTI_NEI:
            continue
        ret, chain = p.extend(x, max_ext)
        if ret != ET_MULTI_OUT:
            continue
        y = chain[-1] ^ 1
        w = None
        s = p.start[x ^ 1]
        for i in range(s, s + p.cnt[x ^ 1]):
            if not p.adel[i]:
                w = p.v[i] ^ 1
        sw = p.start[w]
        ov = oy = 0
        for i in range(sw, sw + p.cnt[w]):
            if p.adel[i]:
                continue
            if p.v[i] == y:
                oy = p.ol[i]
            if p.v[i] == x:
                ov = p.ol[i]
        if ov == 0 and oy == 0:
            continue
        if ov > oy:
            p.arc_del(w, y, True)
            p.arc_del(y ^ 1, w ^ 1, True)
            n += 1
    p.done(n > 0)
    return n


def _bub_pop1(p, v0, max_dist, st):
    """asg_bub_pop1 (asg.c): a bounded search from v0 for a bubble that
    closes in one sink; pops it.  Returns 1 | tips << 32, or 0."""
    P, D, C, R, S_ = st
    if p.sdel[v0 >> 1] or p.cnt[v0] < 2:
        return 0
    S, T, b, e = [], [], [], []
    n_pending = 0
    n_pop = 0
    C[v0] = 0
    D[v0] = 0
    S.append(v0)
    ok = True
    while True:
        x = S.pop()
        d, c = D[x], C[x]
        s, nv = p.start[x], p.cnt[x]
        i = 0
        while i < nv:
            ai = s + i
            w = p.v[ai]
            ll = p.l[ai]
            if w == v0:
                ok = False
                break
            if p.adel[ai]:
                i += 1
                continue
            e.append(ai)
            if d + ll > max_dist:
                break
            if S_[w] == 0:
                b.append(w)
                P[w] = x
                S_[w] = 1
                D[w] = d + ll
                R[w] = p.n_live(w ^ 1)
                n_pending += 1
            else:
                if c + 1 > C[w] or (c + 1 == C[w] and d + ll > D[w]):
                    P[w] = x
                if c + 1 > C[w]:
                    C[w] = c + 1
                if d + ll < D[w]:
                    D[w] = d + ll
            R[w] -= 1
            if R[w] == 0:
                if p.cnt[w]:
                    S.append(w)
                else:
                    T.append(w)
                n_pending -= 1
            i += 1
        if not ok or i < nv or not S:
            break
        if not (len(S) > 1 or n_pending):
            # one sink and nothing pending: a bubble (asg_bub_backtrack)
            for w in b:
                p.sdel[w >> 1] = True
            for ai in e:
                p.adel[ai] = True
                p.arc_del(p.v[ai] ^ 1, p.u[ai] ^ 1, True)
            x = S[0]
            while x != v0:
                uu = P[x]
                p.sdel[x >> 1] = False
                p.arc_del(uu, x, False)
                p.arc_del(x ^ 1, uu ^ 1, False)
                x = uu
            n_pop = 1 | (len(T) << 32)
            break
    for w in b:
        S_[w] = 0
        C[w] = 0
        D[w] = 0
    return n_pop


def pop_bubble(g, max_dist):
    """asg_pop_bubble (asg.c)."""
    if not g.is_symm:
        symm(g)
    p = _Seq(g)
    V = g.n_vtx
    st = ([0] * V, [0] * V, [0] * V, [0] * V, [0] * V)
    n = 0
    for x in range(V):
        if p.cnt[x] < 2 or p.sdel[x >> 1]:
            continue
        if p.n_live(x) > 1:
            n += _bub_pop1(p, x, max_dist, st)
    p.done(n != 0)
    return n


def clean(g, opt):
    """main.c's Steps 4.1-4.5 at the default stage."""
    del_trans(g, opt.gap_fuzz)
    cut_tip(g, opt.max_ext)
    pop_bubble(g, opt.bub_dist)
    fmin = np.float32(opt.min_ovlp_drop_ratio)
    fmax = np.float32(opt.max_ovlp_drop_ratio)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(opt.n_rounds + 1):
            r = fmin + (fmax - fmin) / np.float32(opt.n_rounds) * np.float32(i)
            if del_short(g, r):
                cut_tip(g, opt.max_ext)
                pop_bubble(g, opt.bub_dist)
    cut_internal(g, 1)
    cut_biloop(g, opt.max_ext)
    cut_tip(g, opt.max_ext)
    pop_bubble(g, opt.bub_dist)
    if del_short(g, opt.final_ovlp_drop_ratio):
        cut_tip(g, opt.max_ext)
        pop_bubble(g, opt.bub_dist)


# ---------------------------------------------------------------- unitigs


def ug_gen(g):
    """ma_ug_gen (asm.c): the unitigs, each (len, circ, start, end, [(x,
    l), ...]), and the unitig graph."""
    u, l, v, ol, start, cnt = g.lists()
    sdel = g.sdel.tolist()
    V = g.n_vtx
    mark = [0] * V
    units = []
    for x0 in range(V):
        if sdel[x0 >> 1] or cnt[x0] == 0 or mark[x0]:
            continue
        mark[x0] = 1
        q = []
        st, en, length = x0, x0 ^ 1, 0
        w = x0
        while True:
            if cnt[w] != 1:
                break
            x, ll = v[start[w]], l[start[w]]
            if cnt[x ^ 1] != 1:
                break
            mark[x] = mark[w ^ 1] = 1
            q.append((w, ll))
            en = x ^ 1
            length += ll
            w = x
            if x == x0:
                break
        circ = False
        if st != (en ^ 1) or not q:
            ll = g.slen[en >> 1]
            q.append((en ^ 1, int(ll)))
            length += int(ll)
            back = []
            x = x0
            while True:
                if cnt[x ^ 1] != 1:
                    break
                w = v[start[x ^ 1]] ^ 1
                if cnt[w] != 1:
                    break
                mark[x] = mark[w ^ 1] = 1
                back.append((w, l[start[w]]))
                st = w
                length += l[start[w]]
                x = w
            q = back[::-1] + q
        else:
            st = en = M32
            circ = True
        if st != M32:
            mark[st] = mark[en] = 1
        units.append((length, circ, st, en, q))
    vmark = np.full(V, -1, dtype=np.int64)
    for i, (_, circ, st, en, _) in enumerate(units):
        if not circ:
            vmark[st] = i << 1
            vmark[en] = i << 1 | 1
    ulen = np.array([t[0] for t in units], dtype=np.int64)
    m1 = vmark[g.u ^ 1]
    m2 = vmark[g.v]
    sel = (m1 >= 0) & (m2 >= 0)
    u2 = m1[sel] ^ 1
    l2 = ulen[u2 >> 1] - g.ol[sel]
    l2 = np.where(l2 < 0, 1, l2)
    nu = len(units)
    ug = Graph(u2, l2, m2[sel], g.ol[sel], ulen & M32,
               np.zeros(nu, dtype=bool))
    return units, ug


def _utg(i, circ):
    return "utg%.6d%c" % (i + 1, "c" if circ else "l")


def ug_print(units, ug, names, s, e, out):
    """ma_ug_print (asm.c): S, L, a and x lines."""
    w = out.write
    for i, (length, circ, st, en, q) in enumerate(units):
        name = _utg(i, circ)
        w("S\t%s\t*\tLN:i:%d\n" % (name, length))
        if circ:
            w("L\t%s\t+\t%s\t+\t0M\n" % (name, name))
            w("L\t%s\t-\t%s\t-\t0M\n" % (name, name))
        off = 0
        for x, ll in q:
            r = x >> 1
            w("a\t%s\t%d\t%s:%d-%d\t%c\t%d\n" % (
                name, off, names[r], int(s[r]) + 1, int(e[r]), "+-"[x & 1],
                ll))
            off += ll
    for a, b, o, ll in zip(ug.u.tolist(), ug.v.tolist(), ug.ol.tolist(),
                           ug.l.tolist()):
        w("L\t%s\t%c\t%s\t%c\t%dM\tSD:i:%d\n" % (
            _utg(a >> 1, units[a >> 1][1]), "+-"[a & 1],
            _utg(b >> 1, units[b >> 1][1]), "+-"[b & 1], o, ll))
    for i, (length, circ, st, en, q) in enumerate(units):
        if st == M32:
            w("x\tutg%.6dc\t%d\t%d\n" % (i + 1, length, len(q)))
        else:
            c0, c1 = int(ug.cnt[i << 1]), int(ug.cnt[i << 1 | 1])
            a, b = st >> 1, en >> 1
            w("x\tutg%.6dl\t%d\t%d\t%d\t%d\t%s:%d-%d\t%c\t%s:%d-%d\t%c\n" % (
                i + 1, length, len(q), c1, c0,
                names[a], int(s[a]) + 1, int(e[a]), "+-"[st & 1],
                names[b], int(s[b]) + 1, int(e[b]), "+-"[en & 1]))


# ---------------------------------------------------------------- main.c


def _pair(a, b):
    """a[0], b[0], a[1], b[1], ...: each record, then its mirror."""
    out = np.empty(2 * a.size, dtype=a.dtype)
    out[0::2], out[1::2] = a, b
    return out


def _hits(rec):
    """ma_hit_read's hit array (hit.c): each record, then its mirror when
    the two reads differ, in the order of miniasm's radix sort of the key
    qid<<32|qs (ties of the key reach the output).  Coordinates, ml and bl
    are uint32 as in the C; qid, tid int64; rev bool."""
    qid = _pair(rec["qid"], rec["tid"])
    qs = _pair(rec["qs"], rec["ts"])
    keep = np.ones(qid.size, dtype=bool)
    keep[1::2] = rec["qid"] != rec["tid"]
    src = np.flatnonzero(keep)
    key = (qid[src].astype(np.uint64) << np.uint64(32)) | \
        qs[src].astype(np.uint64)
    src = src[native.radix_order(key)]
    del key
    u32 = np.uint32
    return {"qid": qid[src], "qs": qs[src].astype(u32),
            "qe": _pair(rec["qe"], rec["te"])[src].astype(u32),
            "tid": _pair(rec["tid"], rec["qid"])[src],
            "ts": _pair(rec["ts"], rec["qs"])[src].astype(u32),
            "te": _pair(rec["te"], rec["qe"])[src].astype(u32),
            "ml": (rec["ml"][src >> 1]).astype(u32),
            "bl": (rec["bl"][src >> 1]).astype(u32),
            "rev": rec["rev"][src >> 1] != 0}


def select(rec, opt, n_seq):
    """Steps 1-3 of main.c: the hits in miniasm's radix order, both read
    selection passes and containment."""
    h = _hits(rec)
    sub = hit_sub(h, n_seq, opt.min_dp, opt.min_iden, 0)
    h = hit_cut(h, sub, opt.min_span)
    h = hit_flt(h, sub, int(opt.max_hang * 1.5), int(opt.min_ovlp * .5))
    sub2 = hit_sub(h, n_seq, opt.min_dp, opt.min_iden, opt.min_span // 2)
    h = hit_cut(h, sub2, opt.min_span)
    sub = ((sub[0] + sub2[0]) & M32, (sub[0] + sub2[1]) & M32,
           sub[2] | sub2[2])
    return h, sub


def assemble(paf: str, argv=("-p", "ug"), intern: str = "order",
             stats: dict | None = None) -> bytes:
    """miniasm's stdout for `argv` (without the file) on `paf`.
    `intern="split"` numbers the reads in another order (see
    paf.read_paf_numpy): the control of the benchmark's check.  `stats`, when
    given, receives the sizes of the work: PAF lines, kept records,
    reads, and (-p ug) the arcs that the hits give, and the seconds of
    its steps."""
    opt, outfmt, _ = parse_argv(list(argv) + [paf])
    t0 = time.perf_counter()
    rec = read_paf(paf, opt.min_span, opt.min_match, intern)
    t_read = time.perf_counter() - t0
    names = rec["names"]
    n_seq = len(names)
    stats = {} if stats is None else stats
    stats.update(lines=rec["n_lines"], records=int(rec["qid"].size),
                 reads=n_seq, read_s=t_read)
    h, sub = select(rec, opt, n_seq)
    out = io.StringIO()
    h, sub, names = hit_contained(h, sub, opt, names)
    if outfmt == "paf":
        s, e = sub[0], sub[1]
        for q, qs, qe, t, ts, te, ml, bl, rv in zip(*(h[k].tolist() for k in (
                "qid", "qs", "qe", "tid", "ts", "te", "ml", "bl", "rev"))):
            out.write("%s:%d-%d\t%d\t%d\t%d\t%c\t%s:%d-%d\t%d\t%d\t%d\t%d\t"
                      "%d\t255\n" % (
                          names[q], s[q] + 1, e[q], e[q] - s[q], qs, qe,
                          "+-"[rv], names[t], s[t] + 1, e[t], e[t] - s[t],
                          ts, te, ml, bl))
        return out.getvalue().encode("latin-1")
    r, u, _, l, _ = _classify(h, sub, opt.max_hang, opt.int_frac,
                              opt.min_ovlp)
    a = (r >= 0) & (h["qid"] != h["tid"])
    stats["arcs"] = int(a.sum())
    stats["select_s"] = time.perf_counter() - t0 - t_read
    g = sg_gen(h, sub, opt)
    clean(g, opt)
    stats["graph_s"] = time.perf_counter() - t0 - t_read - stats["select_s"]
    units, ug = ug_gen(g)
    ug_print(units, ug, names, sub[0], sub[1], out)
    return out.getvalue().encode("latin-1")
