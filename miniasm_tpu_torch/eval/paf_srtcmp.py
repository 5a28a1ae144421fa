"""Mapping-accuracy comparison of two name-sorted PAFs (port of the
reference tex/paf_srtcmp.js).

The first file is the truth (e.g. BWA-MEM best hits), the second the
mapper under test (e.g. minimap).  For every truth query with EXACTLY one
record, the test group is scanned for a record on the same strand and
target whose interval overlaps; the first such record decides the query:
matched iff the reciprocal overlap ratio >= 1/3 (paf_srtcmp.js:60-71).
Unmatched truth lines are echoed; the summary line is "tot matched ratio".

Faithful to the JS control flow, including its quirks: truth queries with
more than one record are skipped entirely, and truth queries absent from
the test file count toward `tot` only when they are singletons.

The port's copy of miniasm_tpu/eval/paf_srtcmp.py.
"""

from __future__ import annotations

import sys

from ..io.paf import open_text


def _groups(fn):
    """Yield lists of field-split records sharing a query name, in file
    order (the files must be name-sorted)."""
    cur = []
    with open_text(fn) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            for j in (1, 2, 3, 6, 7, 8, 9, 10, 11):
                if j < len(t):
                    t[j] = int(t[j])
            if cur and cur[0][0] != t[0]:
                yield cur
                cur = []
            cur.append(t)
    if cur:
        yield cur


def srtcmp(fn_truth: str, fn_test: str, out=None):
    out = out or sys.stdout
    tot = matched = 0
    gb = _groups(fn_truth)
    gm = _groups(fn_test)
    sb = next(gb, None)
    sm = next(gm, None)
    while sb is not None:
        # sync on query name (string order, like the JS < on names)
        while sm is not None and sb is not None and sb[0][0] != sm[0][0]:
            if sb[0][0] < sm[0][0]:
                if len(sb) == 1:
                    tot += 1
                sb = next(gb, None)
            else:
                sm = next(gm, None)
        if sb is None:
            break
        if sm is None:
            while sb is not None:
                if len(sb) == 1:
                    tot += 1
                sb = next(gb, None)
            break
        if len(sb) == 1:
            b = sb[0]
            tot += 1
            hit = 0
            for m in sm:
                if b[4] != m[4] or b[5] != m[5]:
                    continue
                if b[8] > m[7] and m[8] > b[7]:
                    ol = b[8] - m[7]
                    ml = m[8] - b[7]
                    r = ol / ml if ol < ml else ml / ol
                    if r >= .3333:
                        matched += 1
                        hit = 1
                    break  # first overlapping record decides (JS break)
            if hit == 0:
                out.write("\t".join(str(x) for x in b) + "\n")
        sb = next(gb, None)
        sm = next(gm, None)
    out.write("%d %d %s\n" % (tot, matched,
                              matched / tot if tot else 0))
    return tot, matched


def main(argv):
    if len(argv) != 3:
        sys.stderr.write(
            "Usage: python -m miniasm_tpu_torch.eval.paf_srtcmp "
            "<truth.srt.paf> <test.srt.paf>\n")
        return 1
    srtcmp(argv[1], argv[2])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
