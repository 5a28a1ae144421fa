"""String-graph store.

Re-designs the reference's asg_t (asg.h:13-23) as SoA columns + a CSR row
index:

  - vertex = read orientation: v = id<<1 | strand, complement v^1
    (reference convention);
  - arc columns (u, l, v, ol, del): the reference packs ul = u<<32|l; we
    keep u and l as separate int32 columns and sort with a stable two-key
    sort, which matches the reference's stable u64 radix order exactly
    (asg.c:8-9,22-25);
  - idx_start/idx_cnt = CSR over source vertices (asg_arc_index_core,
    asg.c:27-36) built by searchsorted on device or numpy on host;
  - soft deletion via bool masks, periodic compaction (asg_cleanup,
    asg.c:72-80).

The struct lives host-side (numpy); the detection passes move its arc
columns to the device (graph/devclean.py, graph/devbub.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import timers
from ..utils.timers import log


@dataclasses.dataclass
class Graph:
    # arc columns, sorted by (u, l) stable
    u: np.ndarray    # int32 source vertex
    l: np.ndarray    # int32 u-prefix length
    v: np.ndarray    # int32 sink vertex
    ol: np.ndarray   # int32 overlap length
    adel: np.ndarray  # bool arc tombstones
    # per-read sequence info
    slen: np.ndarray  # uint32 read (sub) length
    sdel: np.ndarray  # bool read tombstones
    # CSR index over 2*n_seq vertices
    idx_start: np.ndarray
    idx_cnt: np.ndarray
    is_symm: bool = False
    # like the reference's asg_t.is_srt (asg.h:18): the arc array is sorted
    # exactly once with the reference radix permutation; later cleanups only
    # compact, which preserves order (asg.c:72-80 never re-sorts)
    is_srt: bool = False

    @property
    def n_arc(self) -> int:
        return len(self.u)

    @property
    def n_seq(self) -> int:
        return len(self.slen)

    @property
    def n_vtx(self) -> int:
        return 2 * len(self.slen)

    def arcs_of(self, vtx: int):
        s = self.idx_start[vtx]
        return slice(s, s + self.idx_cnt[vtx])

    def arc_del(self, v: int, w: int, delete: bool = True) -> None:
        """Tombstone every arc v->w (reference asg_arc_del, asg.h:55-61)."""
        sl = self.arcs_of(v)
        sel = self.v[sl] == w
        self.adel[sl] = np.where(sel, delete, self.adel[sl])

    def seq_del(self, sid: int) -> None:
        """Delete read sid and all incident arcs in both directions
        (reference asg_seq_del, asg.h:63-77)."""
        self.sdel[sid] = True
        for k in (0, 1):
            vv = sid << 1 | k
            sl = self.arcs_of(vv)
            self.adel[sl] = True
            for w in self.v[sl]:
                self.arc_del(int(w) ^ 1, vv ^ 1, True)

    @classmethod
    def from_arrays(cls, other) -> "Graph":
        """Copy of any graph object with this class's fields (such as the
        JAX package's Graph): numpy arrays are copied, flags kept."""
        kw = {}
        for f in dataclasses.fields(cls):
            x = getattr(other, f.name)
            kw[f.name] = np.array(x) if isinstance(x, np.ndarray) else x
        return cls(**kw)

    def live_out(self, vtx: int) -> int:
        sl = self.arcs_of(vtx)
        return int(np.sum(~self.adel[sl]))


def arc_index(u_sorted: np.ndarray, n_vtx: int):
    """CSR index via searchsorted (replaces the scan of asg.c:27-36)."""
    start = np.searchsorted(u_sorted, np.arange(n_vtx, dtype=np.int64), side="left")
    end = np.searchsorted(u_sorted, np.arange(n_vtx, dtype=np.int64), side="right")
    return start.astype(np.int64), (end - start).astype(np.int32)


def cleanup(g: Graph) -> Graph:
    """Hard-remove tombstoned arcs and arcs touching deleted reads; sort by
    ul on the FIRST cleanup only (the reference's is_srt latch, asg.c:75-78,
    with the exact radix tie permutation); re-index (asg.c:57-80).  A
    span `cleanup` under whichever pass or stage calls it."""
    with timers.span("cleanup"):
        keep = ~g.adel & ~g.sdel[g.u >> 1] & ~g.sdel[g.v >> 1]
        u, l, v, ol = g.u[keep], g.l[keep], g.v[keep], g.ol[keep]
        if not g.is_srt:
            from ..utils.exact_sort import radix_argsort

            key = ((u.astype(np.uint64) << np.uint64(32))
                   | l.astype(np.uint64))
            order = radix_argsort(key)
            u, l, v, ol = u[order], l[order], v[order], ol[order]
        start, cnt = arc_index(u, g.n_vtx)
        return Graph(u, l, v, ol, np.zeros(len(u), dtype=bool),
                     g.slen, g.sdel, start, cnt, g.is_symm, True)


def graph_from_arcs(d, sub_s, sub_e, sub_del, cont, used, pal, arcs,
                    m_hits=None) -> Graph:
    """Device-resident graph-build path: consume the arc columns emitted by
    select_build (old read ids), perform the host half of containment
    removal (hit.c:237-256: dict deletions, unused-read drop, squeeze) and
    assemble the string graph (ma_sg_gen, asm.c:9-39) without ever
    materializing hit columns on the host.

    Returns (graph, sub_s', sub_e', sub_del') in new dense ids; mutates d.
    """
    sub_del = np.asarray(sub_del) | np.asarray(cont)
    d.mark_deleted(sub_del)
    d.mark_deleted(~np.asarray(used))
    mp = d.squeeze()
    keep_read = mp >= 0
    sub_s = np.asarray(sub_s)[keep_read]
    sub_e = np.asarray(sub_e)[keep_read]
    sub_del2 = sub_del[keep_read]
    slen = (sub_e.astype(np.int64) - sub_s.astype(np.int64)).astype(np.uint32)
    sdel = np.asarray(pal)[keep_read] | sub_del2

    mq = mp[arcs["u"] >> 1]
    mv = mp[arcs["v"] >> 1]
    keep = (mq >= 0) & (mv >= 0)
    u = ((mq[keep] << 1) | (arcs["u"][keep] & 1)).astype(np.int32)
    v = ((mv[keep] << 1) | (arcs["v"][keep] & 1)).astype(np.int32)
    l = arcs["l"][keep].astype(np.int32)
    ol = arcs["ol"][keep].astype(np.int32)
    n_seq = d.n_seq
    if m_hits is not None:
        log("hit_contained", "%d sequences and %d hits remain after "
            "containment removal", n_seq, m_hits)
    else:
        log("hit_contained", "%d sequences remain after containment removal",
            n_seq)
    g = Graph(u=u, l=l, v=v, ol=ol, adel=np.zeros(len(u), dtype=bool),
              slen=slen, sdel=sdel,
              idx_start=np.zeros(2 * n_seq, dtype=np.int64),
              idx_cnt=np.zeros(2 * n_seq, dtype=np.int32))
    g = cleanup(g)
    log("sg_gen", "read %d arcs", g.n_arc)
    return g, sub_s, sub_e, sub_del2


def graph_from_hits(opt, lens, dels, sub, hits) -> Graph:
    """Build the string graph from the staged path's surviving hits
    (reference ma_sg_gen, asm.c:9-39): hit2arc with final parameters and
    the marks in one launch (the hit_marks kernel, K18, "sg" mode), then
    the arcs compacted in hit order (K16); query-contained reads and exact
    reverse self-palindromes (PacBio chimera artifact, asm.c:27-30) delete
    their read.  `sub` is the (3, n_seq) [s, e, del] trim table on the
    hits' device, or None when no selection pass ran: the read lengths are
    then the raw `lens`."""
    import torch

    from ..core import hit2arc as h2a
    from ..utils import compact as kc

    n_seq = len(lens)
    if sub is not None:
        s, e, sd = sub.cpu().numpy()
        slen = (e.view(np.uint32).astype(np.int64)
                - s.view(np.uint32).astype(np.int64)).astype(np.uint32)
        sdel = (sd != 0) | np.asarray(dels, dtype=bool)
    else:
        slen = np.asarray(lens, dtype=np.uint32)
        sdel = np.asarray(dels, dtype=bool).copy()

    c = hits.cols
    lt = torch.from_numpy(slen.view(np.int32)).to(c.device)
    # the self reverse-palindrome artifact (asm.c:27-30) and the query
    # contained at final params (asm.c:34) mark their read; the arc rows
    # are the arcs that are not self matches
    mark, keep, arc = h2a.hit_marks(c, "sg", n_seq, lt, opt.max_hang,
                                    opt.int_frac, opt.min_ovlp)
    sdel |= mark.cpu().numpy() != 0
    u, v, l, ol = kc.compact(arc, keep).cpu().numpy()

    g = Graph(u=u, l=l, v=v, ol=ol, adel=np.zeros(len(u), dtype=bool),
              slen=slen, sdel=sdel,
              idx_start=np.zeros(2 * n_seq, dtype=np.int64),
              idx_cnt=np.zeros(2 * n_seq, dtype=np.int32))
    g = cleanup(g)
    log("sg_gen", "read %d arcs", g.n_arc)
    return g
