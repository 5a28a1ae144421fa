"""ORACLE (executable spec) — NOT the production path.  Port of
miniasm_tpu/graph/seqclean.py.

Sequential transliteration of the reference's order-dependent cleaning
passes (asg.c:199-433): tip cutting, internal-unitig cutting, bi-loop
cutting and bubble popping.  These passes mutate the graph as they scan,
and later vertices observe earlier deletions, so their results depend on
commit order; this module reproduces that order verbatim and exists so
the property tests can cross-check the production hybrid path
(graph/hybrid.py + graph/devbub.py: device detection, ordered host
commits) against a direct rendering of the reference semantics.  It is
reachable in the CLI only via the debug switch MINIASM_TPU_CLEAN=py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timers import log
from .asg import Graph, cleanup

ET_MERGEABLE = 0
ET_TIP = 1
ET_MULTI_OUT = 2
ET_MULTI_NEI = 3


def _live(g: Graph, vtx: int):
    """(slots, targets) of live arcs out of vtx."""
    s = g.idx_start[vtx]
    c = g.idx_cnt[vtx]
    sl = np.arange(s, s + c)
    alive = ~g.adel[s:s + c]
    return sl[alive], g.v[s:s + c][alive]


def is_utg_end(g: Graph, v: int):
    """Classify the backward side of v (reference asg_is_utg_end,
    asg.c:204-221). Returns (code, lw) where lw=(l, next_v) of the unique
    incoming arc when it exists."""
    s = g.idx_start[v ^ 1]
    c = g.idx_cnt[v ^ 1]
    adel = g.adel[s:s + c]
    live_idx = np.flatnonzero(~adel)
    nv = len(live_idx)
    if nv == 0:
        return ET_TIP, None
    if nv > 1:
        return ET_MULTI_OUT, None
    i0 = s + live_idx[-1]
    lw = (int(g.l[i0]), int(g.v[i0]))
    w = int(g.v[i0]) ^ 1
    sw = g.idx_start[w]
    cw = g.idx_cnt[w]
    nw = int(np.sum(~g.adel[sw:sw + cw]))
    if nw != 1:
        return ET_MULTI_NEI, lw
    return ET_MERGEABLE, lw


def extend(g: Graph, v: int, max_ext: int):
    """Follow a mergeable chain up to max_ext vertices (reference
    asg_extend, asg.c:223-236). Returns (terminating code, chain) where
    chain[0] = v and chain[i>0] = (l, vertex)."""
    chain = [(0, v)]
    while True:
        ret, lw = is_utg_end(g, v ^ 1)
        if ret != ET_MERGEABLE:
            break
        chain.append(lw)
        v = lw[1]
        max_ext -= 1
        if max_ext <= 0:
            break
    return ret, chain


def seq_del(g: Graph, sid: int) -> None:
    g.seq_del(sid)


def cut_tip(g: Graph, max_ext: int) -> tuple[Graph, int]:
    """reference asg_cut_tip (asg.c:238-254)."""
    cnt = 0
    for v in range(g.n_vtx):
        if g.sdel[v >> 1]:
            continue
        if is_utg_end(g, v)[0] != ET_TIP:
            continue
        ret, chain = extend(g, v, max_ext)
        if ret == ET_MERGEABLE:
            continue  # long enough to keep
        for _, vv in chain:
            g.seq_del(vv >> 1)
        cnt += 1
    if cnt > 0:
        g = cleanup(g)
    log("cut_tip", "cut %d tips", cnt)
    return g, cnt


def cut_internal(g: Graph, max_ext: int) -> tuple[Graph, int]:
    """reference asg_cut_internal (asg.c:256-272)."""
    cnt = 0
    for v in range(g.n_vtx):
        if g.sdel[v >> 1]:
            continue
        if is_utg_end(g, v)[0] != ET_MULTI_NEI:
            continue
        ret, chain = extend(g, v, max_ext)
        if ret != ET_MULTI_NEI:
            continue
        for _, vv in chain:
            g.seq_del(vv >> 1)
        cnt += 1
    if cnt > 0:
        g = cleanup(g)
    log("cut_internal", "cut %d internal sequences", cnt)
    return g, cnt


def cut_biloop(g: Graph, max_ext: int) -> tuple[Graph, int]:
    """reference asg_cut_biloop (asg.c:274-306)."""
    cnt = 0
    for v in range(g.n_vtx):
        if g.sdel[v >> 1]:
            continue
        if is_utg_end(g, v)[0] != ET_MULTI_NEI:
            continue
        ret, chain = extend(g, v, max_ext)
        if ret != ET_MULTI_OUT:
            continue
        x = chain[-1][1] ^ 1
        w = None
        _, targets = _live(g, v ^ 1)
        for t in targets:
            w = int(t) ^ 1  # last live arc wins, like the reference loop
        assert w is not None
        sw = g.idx_start[w]
        cw = g.idx_cnt[w]
        ov = ox = 0
        for i in range(sw, sw + cw):  # looking for w->v and w->x
            if g.adel[i]:
                continue
            if g.v[i] == x:
                ox = int(g.ol[i])
            if g.v[i] == v:
                ov = int(g.ol[i])
        if ov == 0 and ox == 0:
            continue
        if ov > ox:
            g.arc_del(w, x, True)
            g.arc_del(x ^ 1, w ^ 1, True)
            cnt += 1
    if cnt > 0:
        g = cleanup(g)
    log("cut_biloop", "cut %d small bi-loops", cnt)
    return g, cnt


def _count_out(g: Graph, v: int) -> int:
    s = g.idx_start[v]
    c = g.idx_cnt[v]
    return int(np.sum(~g.adel[s:s + c]))


def _bub_pop1(g: Graph, v0: int, max_dist: int, binfo) -> int:
    """Pop one potential bubble from v0 (reference asg_bub_pop1,
    asg.c:360-409): Kahn-style BFS bounded by max_dist, LIFO stack order
    preserved for parity; returns (1 | n_tips<<32) on success, else 0."""
    p_, d_, c_, r_, s_ = binfo
    if g.sdel[v0 >> 1]:
        return 0
    if g.idx_cnt[v0] < 2:
        return 0
    S: list[int] = []
    T: list[int] = []
    b: list[int] = []
    e: list[int] = []
    n_pending = 0
    n_pop = 0
    c_[v0] = 0
    d_[v0] = 0
    S.append(v0)
    ok = True
    while True:
        v = S.pop()
        d = int(d_[v])
        c = int(c_[v])
        s = g.idx_start[v]
        nv = g.idx_cnt[v]
        assert nv > 0
        i = 0
        while i < nv:
            ai = s + i
            w = int(g.v[ai])
            l = int(g.l[ai])
            if w == v0:
                ok = False
                break
            if g.adel[ai]:
                i += 1
                continue
            e.append(ai)
            if d + l > max_dist:
                break
            if s_[w] == 0:  # first visit
                b.append(w)
                p_[w] = v
                s_[w] = 1
                d_[w] = d + l
                r_[w] = _count_out(g, w ^ 1)
                n_pending += 1
            else:
                if c + 1 > c_[w] or (c + 1 == c_[w] and d + l > d_[w]):
                    p_[w] = v
                if c + 1 > c_[w]:
                    c_[w] = c + 1
                if d + l < d_[w]:
                    d_[w] = d + l
            assert r_[w] > 0
            r_[w] -= 1
            if r_[w] == 0:
                if g.idx_cnt[w]:
                    S.append(w)
                else:
                    T.append(w)
                n_pending -= 1
            i += 1
        if not ok or i < nv or len(S) == 0:
            break
        if not (len(S) > 1 or n_pending):
            # exactly one sink, nothing pending: bubble found
            _bub_backtrack(g, v0, S, b, e, p_)
            n_pop = 1 | (len(T) << 32)
            break
    for w in b:  # clear visited state
        s_[w] = 0
        c_[w] = 0
        d_[w] = 0
    return n_pop


def _bub_backtrack(g: Graph, v0: int, S, b, e, p_) -> None:
    """reference asg_bub_backtrack (asg.c:338-357)."""
    assert len(S) == 1
    for w in b:
        g.sdel[w >> 1] = True
    for ai in e:
        g.adel[ai] = True
        g.arc_del(int(g.v[ai]) ^ 1, int(g.u[ai]) ^ 1, True)
    v = S[0]
    while v != v0:
        u = int(p_[v])
        g.sdel[v >> 1] = False
        g.arc_del(u, v, False)
        g.arc_del(v ^ 1, u ^ 1, False)
        v = u


def pop_bubble(g: Graph, max_dist: int,
               device: torch.device = torch.device("cpu")) -> tuple[Graph, int]:
    """reference asg_pop_bubble (asg.c:412-433); an unsymmetric graph is
    symmetrised first, its masks computed on `device`."""
    from .clean import symm

    if not g.is_symm:
        g = symm(g, device)
    n_vtx = g.n_vtx
    p_ = np.zeros(n_vtx, dtype=np.int64)
    d_ = np.zeros(n_vtx, dtype=np.int64)
    c_ = np.zeros(n_vtx, dtype=np.int64)
    r_ = np.zeros(n_vtx, dtype=np.int64)
    s_ = np.zeros(n_vtx, dtype=np.int8)
    binfo = (p_, d_, c_, r_, s_)
    n_pop = 0
    for v in range(n_vtx):
        nv = g.idx_cnt[v]
        if nv < 2 or g.sdel[v >> 1]:
            continue
        s = g.idx_start[v]
        n_arc = int(np.sum(~g.adel[s:s + nv]))
        if n_arc > 1:
            n_pop += _bub_pop1(g, v, max_dist, binfo)
    if n_pop:
        g = cleanup(g)
    log("pop_bubble", "popped %d bubbles and trimmed %d tips",
        n_pop & 0xFFFFFFFF, n_pop >> 32)
    return g, n_pop
