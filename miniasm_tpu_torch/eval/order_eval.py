"""Layout-accuracy harness (reference tex/order_eval.js): w-consistency of
read adjacency between assembly a-lines (as BED: read start end utg ori
offset) and a truth read-to-reference mapping (paftop output).

The port's copy of miniasm_tpu/eval/order_eval.py."""

from __future__ import annotations

import getopt
import math
import sys

from ..io.paf import open_text


def run(bed_fn, paf_fn, out, *, ws=5, min_span=2000):
    bed = []
    h = {}
    end = {}
    last_u = last_r = None
    to_end = 0
    with open_text(bed_fn) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 6:
                continue
            r = "%s:%d-%s" % (t[0], int(t[1]) + 1, t[2])
            h[r] = len(bed)
            if to_end > 0:
                end[r] = 1
                to_end -= 1
            if last_u is None or t[3] != last_u:
                end[r] = 1
                to_end = ws - 1
                if last_r is not None:
                    end[last_r] = 1
                    for j in range(len(bed) - 1, max(-1, len(bed) - ws - 1), -1):
                        end[bed[j][2]] = 1
            center = math.floor(int(t[5]) + (int(t[2]) - int(t[1])) / 2)
            bed.append([t[3], t[4], r, center])
            last_r, last_u = r, t[3]
    if last_r is not None:
        end[last_r] = 1
        for j in range(len(bed) - 1, max(-1, len(bed) - ws - 1), -1):
            end[bed[j][2]] = 1

    paf = []
    with open_text(paf_fn) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 10 or int(t[3]) - int(t[2]) < min_span:
                continue
            if paf and t[0] == paf[-1][0]:
                continue  # dup
            t1, t2, t3 = int(t[1]), int(t[2]), int(t[3])
            t7, t8 = int(t[7]), int(t[8])
            if t[4] == "+":
                center = math.floor(((t7 - t2) + (t8 + (t1 - t3))) / 2)
            else:
                center = math.floor(((t7 - (t1 - t3)) + (t8 + t2)) / 2)
            paf.append([t[0], t[5], t[4], t7, center])

    paf.sort(key=lambda x: (x[1], x[3]))
    chr_se = {}
    start = 0
    for i in range(1, len(paf) + 1):
        if i == len(paf) or paf[i][1] != paf[i - 1][1]:
            chr_se[paf[i - 1][1]] = (start, i)
            start = i

    cnt = 0
    for k, (st, en) in chr_se.items():
        for i in range(st + ws + 1, en - ws - 1):
            j = i - 1
            while j >= 0 and paf[i][0] == paf[j][0]:
                j -= 1
            if j < 0:
                continue
            if paf[i][1] != paf[j][1]:
                continue
            hi = h.get(paf[i][0])
            hj = h.get(paf[j][0])
            if hi is None or hj is None:
                continue
            paf_diff = paf[i][4] - paf[j][4]
            same_utg = bed[hi][0] == bed[hj][0]
            bed_diff = abs(bed[hi][3] - bed[hj][3]) if same_utg else None
            if hi - hj > ws or hj - hi > ws or not same_utg:
                if paf[i][0] in end and paf[j][0] in end:
                    continue
                if bed_diff is not None and abs(paf_diff - bed_diff) < min_span:
                    continue
                out.write("E %s %s %d %s %s %s %s %s\n" % (
                    paf[j][1], str(hi - hj) if same_utg else "*", paf_diff,
                    str(bed_diff) if bed_diff is not None else "*",
                    bed[hj][0], bed[hi][0], paf[j][0], paf[i][0]))
                cnt += 1
    out.write("C %d\n" % cnt)
    return cnt


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, args = getopt.getopt(argv, "w:s:")
    kw = {}
    for c, v in opts:
        if c == "-w":
            kw["ws"] = int(v)
        elif c == "-s":
            kw["min_span"] = int(v)
    if len(args) < 2:
        sys.stderr.write("Usage: order_eval <gfa-a-lines.bed> <paftop.paf>\n")
        return 1
    run(args[0], args[1], sys.stdout, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
