"""Sensitivity from a true-pair list vs an overlap PAF (reference
tex/test-sen.pl): prints missed, found, and found/(found+missed).

The port's copy of miniasm_tpu/eval/testsen.py."""

from __future__ import annotations

import sys

from ..io.paf import open_text


def run(pairs_fn, paf_inp, out):
    h = {}
    with open_text(pairs_fn) as f:
        for line in f:
            t = line.split()
            if len(t) >= 2:
                h[t[0] + "\t" + t[1]] = 1
    for line in paf_inp:
        t = line.split()
        if len(t) < 6:
            continue
        k1 = t[0] + "\t" + t[5]
        k2 = t[5] + "\t" + t[0]
        if h.get(k1):
            h[k1] = 2
        if h.get(k2):
            h[k2] = 2
    cnt = [0, 0]
    for v in h.values():
        cnt[v - 1] += 1
    total = cnt[0] + cnt[1]
    out.write("%d\t%d\t%s\n" % (cnt[0], cnt[1],
                                cnt[1] / total if total else 0))
    return cnt


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        sys.stderr.write("Usage: test-sen <true-pairs.txt> [in.paf]\n")
        return 1
    inp = open_text(argv[1]) if len(argv) > 1 else sys.stdin
    run(argv[0], inp, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
