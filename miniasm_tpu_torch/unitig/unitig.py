"""Unitig generation: condense unambiguous chains of the cleaned string
graph (reference ma_ug_gen, asm.c:121-210).

The walk itself is inherently sequential (each unitig claims its vertices)
and runs on the host over the tiny cleaned graph; the heavy lifting
happened on device before this point.  Chain order, circular detection and
the unitig-level arc construction match the reference exactly, including
vertex scan order (which fixes utg numbering and GFA line order).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from ..graph.asg import Graph, cleanup

UINT32_MAX = 0xFFFFFFFF


@dataclasses.dataclass
class Unitig:
    len: int
    circ: bool
    start: int   # starting vertex in the string graph (UINT32_MAX if circular)
    end: int
    a: list      # [(vertex, l), ...] golden path
    s: str | None = None

    @property
    def n(self) -> int:
        return len(self.a)


@dataclasses.dataclass
class UnitigGraph:
    u: list[Unitig]
    g: Graph     # unitig-level graph (vertex = utg<<1|dir)


def ug_gen(g: Graph) -> UnitigGraph:
    n_vtx = g.n_vtx
    mark = np.zeros(n_vtx, dtype=np.int32)

    def arc_cnt(v):
        return int(g.idx_cnt[v])

    def arc_first_v(v):
        i = g.idx_start[v]
        return int(g.v[i]), int(g.l[i])

    units: list[Unitig] = []
    for v in range(n_vtx):
        if g.sdel[v >> 1] or arc_cnt(v) == 0 or mark[v]:
            continue
        mark[v] = 1
        q: deque = deque()
        start, end, length = v, v ^ 1, 0
        # forward walk (asm.c:140-151)
        w = v
        circ = False
        while True:
            if arc_cnt(w) != 1:
                break
            x, l = arc_first_v(w)
            if arc_cnt(x ^ 1) != 1:
                break
            mark[x] = mark[w ^ 1] = 1
            q.append((w, l))
            end = x ^ 1
            length += l
            w = x
            if x == v:
                break
        if start != (end ^ 1) or len(q) == 0:  # linear unitig
            l = int(g.slen[end >> 1])
            q.append((end ^ 1, l))
            length += l
            # backward walk (asm.c:161-171)
            x = v
            while True:
                if arc_cnt(x ^ 1) != 1:
                    break
                wv, _ = arc_first_v(x ^ 1)
                w = wv ^ 1
                if arc_cnt(w) != 1:
                    break
                mark[x] = mark[w ^ 1] = 1
                sw = g.idx_start[w]
                l = int(g.l[sw])
                q.appendleft((w, l))
                start = w
                length += l
                x = w
        else:  # circular unitig
            start = end = UINT32_MAX
            circ = True
        if start != UINT32_MAX:
            mark[start] = mark[end] = 1
        units.append(Unitig(len=length, circ=circ, start=start, end=end,
                            a=list(q)))

    # unitig-level arcs (asm.c:184-207), vectorized over the live arc list
    # (arc order preserved, so the utg-graph arc array matches the
    # reference's append order exactly)
    vmark = np.full(n_vtx, -1, dtype=np.int64)
    for i, ut in enumerate(units):
        if ut.circ:
            continue
        vmark[ut.start] = i << 1 | 0
        vmark[ut.end] = i << 1 | 1
    nu = len(units)
    ulens = np.asarray([ut.len for ut in units], dtype=np.int64)
    live = ~g.adel
    su = g.u[live].astype(np.int64)
    sv = g.v[live].astype(np.int64)
    aol = g.ol[live].astype(np.int64)
    m1 = vmark[su ^ 1]
    m2 = vmark[sv]
    sel = (m1 >= 0) & (m2 >= 0)
    u2 = m1[sel] ^ 1
    l2 = ulens[u2 >> 1] - aol[sel]
    l2 = np.where(l2 < 0, 1, l2)  # reference clamps only NEGATIVE to 1
    ug_g = Graph(
        u=u2.astype(np.int32),
        l=l2.astype(np.int32),
        v=m2[sel].astype(np.int32),
        ol=aol[sel].astype(np.int32),
        adel=np.zeros(int(sel.sum()), dtype=bool),
        slen=ulens.astype(np.uint32),
        sdel=np.zeros(nu, dtype=bool),
        idx_start=np.zeros(2 * nu, dtype=np.int64),
        idx_cnt=np.zeros(2 * nu, dtype=np.int32),
    )
    ug_g = cleanup(ug_g)
    return UnitigGraph(u=units, g=ug_g)
