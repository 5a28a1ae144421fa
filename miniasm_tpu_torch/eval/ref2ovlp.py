"""Derive true overlap pairs from a ref-sorted PAF (reference
tex/ref2ovlp.js): sweep over target-sorted mappings, print each
sufficiently-overlapping read pair with its overlap length (-1 =
contained).

The port's copy of miniasm_tpu/eval/ref2ovlp.py."""

from __future__ import annotations

import sys

from ..io.paf import open_text

MIN_L = 2000
MIN_Q = 10


def run(inp, out):
    a = []
    for line in inp:
        t = line.rstrip("\n").split("\t")
        if len(t) < 12:
            continue
        row = [t[0]] + [int(x) for x in t[1:4]] + [t[4], t[5]] \
            + [int(x) for x in t[6:12]]
        if row[1] < MIN_L or row[11] < MIN_Q:
            continue
        for i, item in enumerate(a):
            if item is None:
                continue
            if row[7] + MIN_L >= item[8]:
                a[i] = None
            elif row[8] <= item[8]:
                out.write("%s %s -1\n" % (row[0], item[0]))
            else:
                out.write("%s %s %d\n" % (row[0], item[0], item[8] - row[7]))
        a = [x for x in a if x is not None]
        a.append(row)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    inp = open_text(argv[0]) if argv else sys.stdin
    run(inp, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
