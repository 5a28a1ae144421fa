"""Per-query best-chain PAF filter (reference misc/paftop.js): sort hits by
matches, mask overlapping hits (mask_level), merge colinear hits (max_gap),
re-mask.

The port's copy of miniasm_tpu/interop/paftop.py."""

from __future__ import annotations

import getopt
import sys

from ..io.paf import open_text


def _mask(a, mask_level):
    k = 1
    for i in range(1, len(a)):
        ai = a[i]
        j = 0
        while j < k:
            aj = a[j]
            ol = 0
            if ai[2] < aj[2]:
                if ai[3] > aj[2]:
                    ol = ai[3] - aj[2]
            else:
                if aj[3] > ai[2]:
                    ol = aj[3] - ai[2]
            min_l = min(ai[3] - ai[2], aj[3] - aj[2])
            if ol > min_l * mask_level:
                break
            j += 1
        if j == k:
            a[k] = ai
            k += 1
    del a[k:]


def _merge(a, max_gap):
    for i in range(1, len(a)):
        ai = a[i]
        for j in range(i):
            aj = a[j]
            if not aj or aj[4] != ai[4] or aj[5] != ai[5]:
                continue
            ts = [ai[7], aj[7]]
            te = [ai[8], aj[8]]
            qs = [ai[2], aj[2]]
            qe = [ai[3], aj[3]]
            if qs[0] > qs[1]:
                qs = [aj[2], ai[2]]
                qe = [aj[3], ai[3]]
                ts = [aj[7], ai[7]]
                te = [aj[8], ai[8]]
                if ai[4] == "-":
                    ts = [aj[6] - aj[8], ai[6] - ai[8]]
                    te = [aj[6] - aj[7], ai[6] - ai[7]]
            else:
                if ai[4] == "-":
                    ts = [ai[6] - ai[8], aj[6] - aj[8]]
                    te = [ai[6] - ai[7], aj[6] - aj[7]]
            if qe[0] > qe[1]:
                continue  # contained
            if ts[0] > ts[1]:
                continue
            qg = qs[1] - qe[0]
            tg = ts[1] - te[0]
            if (qg < 0 and tg < 0) or abs(tg - qg) < max_gap:
                aj[2] = qs[0]
                aj[3] = qe[1]
                if aj[4] == "+":
                    aj[7] = ts[0]
                    aj[8] = te[1]
                else:
                    aj[7] = aj[6] - te[1]
                    aj[8] = aj[6] - ts[0]
                aj[9] += ai[9]
                aj[10] += ai[10]
                aj[11] = max(aj[11], ai[11])
                a[i] = None
                break
    a[:] = [x for x in a if x]


def _top(a, mask_level, max_gap, out):
    for row in a:
        for j in (1, 2, 3, 6, 7, 8, 9, 10, 11):
            row[j] = int(row[j])
    a.sort(key=lambda x: -x[9])
    _mask(a, mask_level)
    _merge(a, max_gap)
    _mask(a, mask_level)
    for row in a:
        if row:
            out.write("\t".join(str(x) for x in row) + "\n")


def run(inp, out, *, mask_level=0.5, max_gap=1000):
    last = None
    a = []
    for line in inp:
        t = line.rstrip("\n").split("\t")
        if t[0] != last:
            if a:
                _top(a, mask_level, max_gap, out)
            a = []
            last = t[0]
        a.append(t)
    if a:
        _top(a, mask_level, max_gap, out)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, args = getopt.getopt(argv, "m:g:")
    kw = {}
    for c, v in opts:
        if c == "-m":
            kw["mask_level"] = float(v)
        elif c == "-g":
            kw["max_gap"] = int(v)
    inp = open_text(args[0]) if args else sys.stdin
    run(inp, sys.stdout, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
