"""minidot: PAF dot-plot renderer emitting EPS (reference dotter.c + eps.h).

Reproduces the reference byte-for-byte: natural-numeric target ordering
(mixed_numcompare, dotter.c:24-46), match-weighted barycenter query
ordering to diagonalize the plot (dotter.c:121-134, weight .01*ml^2,
disable with -d), grid + labels, forward hits red / reverse blue
(dotter.c:175-188).  All coordinates are cast to float32 before printing
with %g, like the C (float) casts in eps.h.

The port's copy of miniasm_tpu/dotter.py.
"""

from __future__ import annotations

import functools
import getopt
import sys

import numpy as np

from .io.paf import open_text
from .io.seqdict import SeqDict


def mixed_numcompare(a: str, b: str) -> int:
    """Natural name comparison (reference mixed_numcompare, dotter.c:24-46)."""
    pa, pb = 0, 0
    la, lb = len(a), len(b)
    while pa < la and pb < lb:
        ca, cb = a[pa], b[pb]
        if ca.isdigit() and cb.isdigit():
            sa, sb = pa, pb
            while pa < la and a[pa] == "0":
                pa += 1
            while pb < lb and b[pb] == "0":
                pb += 1
            while (pa < la and pb < lb and a[pa].isdigit() and b[pb].isdigit()
                   and a[pa] == b[pb]):
                pa += 1
                pb += 1
            da = pa < la and a[pa].isdigit()
            db = pb < lb and b[pb].isdigit()
            if da and db:
                i = 0
                while (pa + i < la and a[pa + i].isdigit()
                       and pb + i < lb and b[pb + i].isdigit()):
                    i += 1
                if pa + i < la and a[pa + i].isdigit():
                    return 1
                if pb + i < lb and b[pb + i].isdigit():
                    return -1
                return ord(a[pa]) - ord(b[pb])
            elif da:
                return 1
            elif db:
                return -1
            elif pa - sa != pb - sb:
                return 1 if pa - sa < pb - sb else -1
        else:
            if ca != cb:
                return ord(ca) - ord(cb)
            pa += 1
            pb += 1
    if pa < la:
        return 1
    if pb < lb:
        return -1
    return 0


def _g(x) -> str:
    """C's %g after a (float) cast (eps.h)."""
    return "%g" % float(np.float32(x))


_HEADER_DEFS = (
    "/C { dup 255 and 255 div exch dup -8 bitshift 255 and 255 div 3 1 roll"
    " -16 bitshift 255 and 255 div 3 1 roll setrgbcolor } bind def\n"
    "/L { 4 2 roll moveto lineto } bind def\n"
    "/LX { dup 4 -1 roll exch moveto lineto } bind def\n"
    "/LY { dup 4 -1 roll moveto exch lineto } bind def\n"
    "/LS { 3 1 roll moveto show } bind def\n"
    "/MS { dup stringwidth pop 2 div 4 -1 roll exch sub 3 -1 roll moveto show } bind def\n"
    "/RS { dup stringwidth pop 4 -1 roll exch sub 3 -1 roll moveto show } bind def\n"
    "/B { 4 copy 3 1 roll exch 6 2 roll 8 -2 roll moveto lineto lineto lineto"
    " closepath } bind def\n")


def render(paf_fn: str, out, *, min_span=1000, min_match=100, min_iden=0.1,
           width=600, font_size=11, line_width=3.0, no_label=False,
           diagonal=True) -> int:
    dq, dt = SeqDict(), SeqDict()  # query (y), target (x)
    hits = []  # (qn, qs, qe, tn, ts, te, ml) with ts/te swapped when rev
    with open_text(paf_fn) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 10:
                continue
            ql, qs, qe = int(t[1]), int(t[2]), int(t[3])
            rev = t[4] == "-"
            tl, ts, te = int(t[6]), int(t[7]), int(t[8])
            ml = int(t[9])
            bl = int(t[10]) if len(t) > 10 else 0
            if qe - qs < min_span or te - ts < min_span or ml < min_match:
                continue
            if ml < bl * np.float32(min_iden):
                continue
            hits.append((dq.put(t[0], ql), qs, qe, dt.put(t[5], tl),
                         te if rev else ts, ts if rev else te, ml))

    order = [None, None]   # [target(x), query(y)] permutations of local ids
    acclen = [None, None]
    totlen = [0, 0]
    for axis, dd in ((0, dt), (1, dq)):
        n = dd.n_seq
        if axis == 0 or not diagonal:
            perm = sorted(range(n), key=functools.cmp_to_key(
                lambda i, j, dd=dd: mixed_numcompare(dd.names[i], dd.names[j])))
        else:
            tot = np.zeros(n, dtype=np.float64)
            wsum = np.zeros(n, dtype=np.uint64)
            for (qn, qs, qe, tn, ts, te, ml) in hits:
                coor = acclen[0][tn] + (ts + te) // 2
                w = np.uint64(0.01 * ml * ml + 0.499)
                tot[qn] += float(coor) * float(w)
                wsum[qn] += w
            with np.errstate(invalid="ignore", divide="ignore"):
                tot = tot / wsum
            perm = list(np.argsort(tot, kind="stable"))
        acc = np.zeros(n, dtype=np.uint64)
        l = 0
        for j in perm:
            acc[j] = l
            l += dd.lens[j]
        order[axis] = perm
        acclen[axis] = acc
        totlen[axis] = l

    if totlen[0] == 0:
        sys.stderr.write("[E::minidot] no hits to plot\n")
        return 1
    height = int(float(width) / totlen[0] * totlen[1] + 0.499)
    sx = float(width) / totlen[0]
    sy = float(height) / totlen[1]

    w = out.write
    # eps_header (eps.h:11-24)
    w("%!PS-Adobe-3.0 EPSF-3.0\n")
    w("%%BoundingBox:")
    w(" 1 1 %g %g\n\n" % (float(np.float32(width)), float(np.float32(height))))
    w(_HEADER_DEFS)
    w("%g setlinewidth\n\n" % float(np.float32(0.2)))
    w("/FS %d def\n" % font_size)
    w("/FS4 FS 4 div def\n")
    w("/Helvetica-Narrow findfont FS scalefont setfont\n\n")
    w("%g setgray\n" % float(np.float32(0.8)))

    if not no_label:
        for j in order[0]:
            w("%s %s (%s) MS\n" % (_g((float(acclen[0][j]) + 0.5 * dt.lens[j]) * sx),
                                   _g(font_size * 0.5), dt.names[j]))
        w("stroke\n")
        w("gsave %g 0 translate 90 rotate\n" % float(np.float32(font_size * 1.25)))
        for j in order[1]:
            w("%s %s (%s) MS\n" % (_g((float(acclen[1][j]) + 0.5 * dq.lens[j]) * sx),
                                   _g(0), dq.names[j]))
        w("grestore\n")
        w("stroke\n")

    # grid (dotter.c:158-166)
    w("%g setlinewidth\n" % float(np.float32(0.1)))
    for i, j in enumerate(order[1]):
        w("%s %s %s LX\n" % (_g(1), _g(width),
                             _g(1 if i == 0 else float(acclen[1][j]) * sy)))
    w("%s %s %s LX\n" % (_g(1), _g(width), _g(float(totlen[1]) * sy)))
    for i, j in enumerate(order[0]):
        w("%s %s %s LY\n" % (_g(1), _g(height),
                             _g(1 if i == 0 else float(acclen[0][j]) * sx)))
    w("%s %s %s LY\n" % (_g(1), _g(height), _g(float(totlen[0]) * sx)))
    w("stroke\n")

    # hits: pass 0 forward (red), pass 1 reverse (blue) (dotter.c:169-189)
    w("%g setlinewidth\n" % float(np.float32(line_width)))
    w("1 setlinecap\n")
    for j, color in ((0, 0xFF0000), (1, 0x0080FF)):
        w("stroke %d C\n" % color)
        for (qn, qs, qe, tn, ts, te, ml) in hits:
            if j == 0 and ts > te:
                continue
            if j == 1 and ts < te:
                continue
            xo, yo = float(acclen[0][tn]), float(acclen[1][qn])
            w("%s %s %s %s L\n" % (_g((ts + xo) * sx), _g((qs + yo) * sy),
                                   _g((te + xo) * sx), _g((qe + yo) * sy)))
        w("stroke\n")
    w("stroke showpage\n")
    return 0


USAGE = """Usage: minidot [options] <in.paf>
Options:
  -m INT      min match length [100]
  -i FLOAT    min identity [0.10]
  -s INT      min span [1000]
  -w INT      image width [600]
  -f INT      font size [11]
  -t FLOAT    line width [3]
  -L          don't print labels
  -d          don't try to put hits onto the diagonal
"""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    kw = {}
    try:
        opts, args = getopt.getopt(argv, "m:i:s:w:f:Ldt:")
    except getopt.GetoptError as e:
        sys.stderr.write("ERROR: %s\n" % e)
        return 1
    for c, a in opts:
        if c == "-m":
            kw["min_match"] = int(a)
        elif c == "-i":
            kw["min_iden"] = float(a)
        elif c == "-s":
            kw["min_span"] = int(a)
        elif c == "-w":
            kw["width"] = int(a)
        elif c == "-f":
            kw["font_size"] = int(a)
        elif c == "-L":
            kw["no_label"] = True
        elif c == "-d":
            kw["diagonal"] = False
        elif c == "-t":
            kw["line_width"] = float(a)
    if not args:
        sys.stderr.write(USAGE)
        return 1
    try:
        return render(args[0], sys.stdout, **kw)
    except FileNotFoundError as e:
        sys.stderr.write("[E::minidot] could not open PAF file %s\n" % e.filename)
        return 1


if __name__ == "__main__":
    sys.exit(main())
