"""Text emitters, byte-identical to the reference.

  - ug_print    : unitig GFA with S/L/a/x lines (reference ma_ug_print,
                  asm.c:77-116) — note the non-standard a-lines (golden
                  path) and x-lines (unitig summary);
  - sg_print    : string-graph L-lines (ma_sg_print, asm.c:41-55);
  - print_subs  : BED of trimmed intervals (main.c:13-19);
  - print_hits  : filtered PAF re-based to trimmed coordinates
                  (main.c:21-30).
"""

from __future__ import annotations

import numpy as np


def _utg_name(i: int, circ: bool) -> str:
    return "utg%.6d%c" % (i + 1, "lc"[1 if circ else 0])


def ug_print(ug, d, sub_s, sub_e, out) -> None:
    w = out.write
    for i, p in enumerate(ug.u):
        name = _utg_name(i, p.circ)
        w("S\t%s\t%s\tLN:i:%d\n" % (name, p.s if p.s else "*", p.len))
        if p.circ:
            w("L\t%s\t+\t%s\t+\t0M\n" % (name, name))
            w("L\t%s\t-\t%s\t-\t0M\n" % (name, name))
        l = 0
        for (vtx, ll) in p.a:
            x = vtx >> 1
            ori = "+-"[vtx & 1]
            if sub_s is not None:
                w("a\t%s\t%d\t%s:%d-%d\t%c\t%d\n"
                  % (name, l, d.names[x], int(sub_s[x]) + 1, int(sub_e[x]), ori, ll))
            else:
                w("a\t%s\t%d\t%s\t%c\t%d\n" % (name, l, d.names[x], ori, ll))
            l += ll
    g = ug.g
    for i in range(g.n_arc):
        uu, vv = int(g.u[i]), int(g.v[i])
        w("L\t%s\t%c\t%s\t%c\t%dM\tSD:i:%d\n"
          % (_utg_name(uu >> 1, ug.u[uu >> 1].circ), "+-"[uu & 1],
             _utg_name(vv >> 1, ug.u[vv >> 1].circ), "+-"[vv & 1],
             int(g.ol[i]), int(g.l[i])))
    for i, p in enumerate(ug.u):
        if p.start == 0xFFFFFFFF:
            w("x\tutg%.6dc\t%d\t%d\n" % (i + 1, p.len, p.n))
        else:
            cnt = [int(g.idx_cnt[i << 1 | j]) for j in range(2)]
            sx, ex = p.start >> 1, p.end >> 1
            if sub_s is not None:
                w("x\tutg%.6dl\t%d\t%d\t%d\t%d\t%s:%d-%d\t%c\t%s:%d-%d\t%c\n"
                  % (i + 1, p.len, p.n, cnt[1], cnt[0],
                     d.names[sx], int(sub_s[sx]) + 1, int(sub_e[sx]), "+-"[p.start & 1],
                     d.names[ex], int(sub_s[ex]) + 1, int(sub_e[ex]), "+-"[p.end & 1]))
            else:
                w("x\tutg%.6dl\t%d\t%d\t%d\t%d\t%s\t%c\t%s\t%c\n"
                  % (i + 1, p.len, p.n, cnt[1], cnt[0],
                     d.names[sx], "+-"[p.start & 1], d.names[ex], "+-"[p.end & 1]))


def sg_print(g, d, sub_s, sub_e, out) -> None:
    w = out.write
    for i in range(g.n_arc):
        uu, vv = int(g.u[i]), int(g.v[i])
        qn, tn = uu >> 1, vv >> 1
        if sub_s is not None:
            w("L\t%s:%d-%d\t%c\t%s:%d-%d\t%c\t%d:\tL1:i:%d\n"
              % (d.names[qn], int(sub_s[qn]) + 1, int(sub_e[qn]), "+-"[uu & 1],
                 d.names[tn], int(sub_s[tn]) + 1, int(sub_e[tn]), "+-"[vv & 1],
                 int(g.ol[i]), int(g.l[i])))
        else:
            w("L\t%s\t%c\t%s\t%c\t%d:\tL1:i:%d\n"
              % (d.names[qn], "+-"[uu & 1], d.names[tn], "+-"[vv & 1],
                 int(g.ol[i]), int(g.l[i])))


def print_subs(d, sub_s, sub_e, out) -> None:
    dels = d.del_array()
    for i in range(d.n_seq):
        if not dels[i] and int(sub_s[i]) != int(sub_e[i]):
            out.write("%s\t%d\t%d\n" % (d.names[i], int(sub_s[i]), int(sub_e[i])))


def print_hits(hits, d, sub_s, sub_e, out) -> None:
    """-p paf of the staged path: `hits` (core.hits.Hits, any device) in
    hit order; sub_s/sub_e host uint32 trim tables."""
    from ..core.hits import COLS

    h = hits.numpy()
    ss, se = np.asarray(sub_s).tolist(), np.asarray(sub_e).tolist()
    names, w = d.names, out.write
    for q, qs, qe, t, ts, te, ml, bl, rev in zip(
            *(h[k].tolist() for k in COLS)):
        rqs, rqe, rts, rte = ss[q], se[q], ss[t], se[t]
        w("%s:%d-%d\t%d\t%d\t%d\t%c\t%s:%d-%d\t%d\t%d\t%d\t%d\t%d\t255\n"
          % (names[q], rqs + 1, rqe, rqe - rqs, qs, qe, "+-"[rev],
             names[t], rts + 1, rte, rte - rts, ts, te, ml, bl))
