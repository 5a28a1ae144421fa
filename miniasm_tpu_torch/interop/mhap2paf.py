"""MHAP -> PAF (reference misc/mhap2paf.pl).

MHAP cols: id1 id2 err sharedMinimizers strand1 start1 end1 len1 strand2
start2 end2 len2.  matches is estimated as blockLen * identity (the .pl's
`int(bl*r+.499)`); `-2` emits the mirrored record too; `-f` maps 1-based
ids to names from a list file.

The port's copy of miniasm_tpu/interop/mhap2paf.py.
"""

from __future__ import annotations

import getopt
import sys

from ..io.paf import open_text


def convert(inp, out, *, double=False, name_list=None, min_blen=0):
    names = []
    if name_list:
        with open_text(name_list) as f:
            for line in f:
                parts = line.split()
                if parts:
                    names.append(parts[0])
    for line in inp:
        t = line.split()
        if len(t) < 12:
            continue
        bl = max(int(t[6]) - int(t[5]), int(t[10]) - int(t[9]))
        r = float(t[2])
        ml = int(bl * (r if r <= 1.0 else 0.01 * r) + 0.499)
        cm = "cm:i:%d" % int(float(t[3]) + 0.499)
        rev = "+" if t[4] == t[8] else "-"
        if bl < min_blen:
            continue
        n0, n1 = t[0], t[1]
        if names:
            n0 = names[int(t[0]) - 1]
            n1 = names[int(t[1]) - 1]
        out.write("\t".join([n0, t[7], t[5], t[6], rev, n1, t[11], t[9],
                             t[10], str(ml), str(bl), "255", cm]) + "\n")
        if double:
            out.write("\t".join([n1, t[11], t[9], t[10], rev, n0, t[7], t[5],
                                 t[6], str(ml), str(bl), "255", cm]) + "\n")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, args = getopt.getopt(argv, "2f:l:")
    kw = {}
    for c, a in opts:
        if c == "-2":
            kw["double"] = True
        elif c == "-f":
            kw["name_list"] = a
        elif c == "-l":
            kw["min_blen"] = int(a)
    if not args and sys.stdin.isatty():
        sys.stderr.write("Usage: mhap2paf [-2] [-f name_list] [-l min_len] <in.mhap>\n")
        return 1
    inp = open_text(args[0]) if args else sys.stdin
    convert(inp, sys.stdout, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
