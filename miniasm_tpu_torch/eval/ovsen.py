"""Overlap sensitivity harness (reference misc/ov-sen.js): derive true
overlap pairs from a reads-vs-reference PAF sorted by target position, then
count how many an overlapper found.

The port's copy of miniasm_tpu/eval/ovsen.py."""

from __future__ import annotations

import getopt
import sys

from ..io.paf import open_text


def run(ref_paf, ovlp_paf, out, *, min_len=2000, min_mapq=10):
    h = {}
    a = []  # active window: (qname, tname, ts, te)
    with open_text(ref_paf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 12 or int(t[11]) < min_mapq or int(t[10]) < min_len:
                continue
            st, en = int(t[7]), int(t[8])
            n_shift = 0
            for item in a:
                if t[5] != item[1]:
                    n_shift += 1
                else:
                    if min(item[3], en) - st >= min_len:
                        break
                    n_shift += 1
            del a[:n_shift]
            for item in a:
                if t[5] != item[1]:
                    continue
                if min(item[3], en) - st < min_len:
                    continue
                h[item[0] + "\t" + t[0]] = 0
            a.append((t[0], t[5], st, en))
    with open_text(ovlp_paf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 6:
                continue
            key = t[0] + "\t" + t[5]
            if key in h:
                h[key] += 1
            else:
                key = t[5] + "\t" + t[0]
                if key in h:
                    h[key] += 1
    n_ovlp = len(h)
    n_missed = sum(1 for v in h.values() if v == 0)
    out.write("%d overlaps\n" % n_ovlp)
    out.write("%d missed\n" % n_missed)
    out.write("%.4f sensitivity\n" % (1 - n_missed / n_ovlp if n_ovlp else 0.0))
    return n_ovlp, n_missed


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, args = getopt.getopt(argv, "l:q:")
    kw = {}
    for c, v in opts:
        if c == "-l":
            kw["min_len"] = int(v)
        elif c == "-q":
            kw["min_mapq"] = int(v)
    if len(args) < 2:
        sys.stderr.write("Usage: ov-sen [-l min_len] [-q min_mapq] "
                         "<in.ref-sorted.paf> <in.ovlp.paf>\n")
        return 1
    run(args[0], args[1], sys.stdout, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
