"""DALIGNER LAdump/DBdump -> PAF (reference misc/da2paf.pl).

First argument: DBdump -rh output (read lengths + well names); stdin (or
second arg): LAdump -cd records (P/C/D lines).  'c' strand flips target
coordinates; without -2, pairs with id0 > id1 are skipped.

The port's copy of miniasm_tpu/interop/da2paf.py.
"""

from __future__ import annotations

import getopt
import re
import sys

from ..io.paf import open_text


def convert(db_lines, la_lines, out, *, double=False, with_name=False):
    lens = {}
    names = {}
    rid, pre = None, None
    for line in db_lines:
        m = re.match(r"^R\s+(\d+)", line)
        if m:
            rid = int(m.group(1))
            continue
        m = re.match(r"^H\s+\S+\s+(\S+)", line)
        if m:
            pre = m.group(1)
            continue
        m = re.match(r"^L\s+(\S+)\s+(\d+)\s+(\d+)", line)
        if m:
            lens[rid] = int(m.group(3)) - int(m.group(2))
            names[rid] = "%s/%s/%s_%s" % (pre, m.group(1), m.group(2), m.group(3))

    id0 = id1 = None
    strand = "+"
    ab = ae = bb = be = 0
    skip = False
    for line in la_lines:
        m = re.match(r"^P\s+(\S+)\s+(\S+)\s+([nc])", line)
        if m:
            id0, id1 = int(m.group(1)), int(m.group(2))
            strand = "+" if m.group(3) == "n" else "-"
            skip = (not double) and id0 > id1
            continue
        if skip:
            continue
        m = re.match(r"^C\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)", line)
        if m:
            ab, ae, bb, be = (int(x) for x in m.groups())
            continue
        m = re.match(r"^D\s+(\d+)", line)
        if m:
            diffs = int(m.group(1))
            bl = max(ae - ab, be - bb)
            ml = bl - diffs
            n0 = names[id0] if with_name else str(id0)
            n1 = names[id1] if with_name else str(id1)
            if strand == "+":
                row = [n0, lens[id0], ab, ae, "+", n1, lens[id1], bb, be,
                       ml, bl, 255]
            else:
                l = lens[id1]
                row = [n0, lens[id0], ab, ae, "-", n1, l, l - be, l - bb,
                       ml, bl, 255]
            out.write("\t".join(str(x) for x in row) + "\n")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, args = getopt.getopt(argv, "2n")
    kw = {}
    for c, _ in opts:
        if c == "-2":
            kw["double"] = True
        elif c == "-n":
            kw["with_name"] = True
    if len(args) < 1:
        sys.stderr.write("Usage: LAdump -cd reads.db x.las | "
                         "python -m miniasm_tpu_torch.interop.da2paf [-2n] "
                         "<(DBdump -rh reads.db)\n")
        return 1
    with open_text(args[0]) as db:
        la = open_text(args[1]) if len(args) > 1 else sys.stdin
        convert(db, la, sys.stdout, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
