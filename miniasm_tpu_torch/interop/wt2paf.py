"""wtdbg overlap output -> PAF (reference misc/wt2paf.pl).

The port's copy of miniasm_tpu/interop/wt2paf.py."""

from __future__ import annotations

import sys

from ..io.paf import open_text


def _num(s: str) -> int:
    """Perl numeric coercion: non-numeric strings ('-') become 0."""
    try:
        return int(s)
    except ValueError:
        return 0


def convert(inp, out):
    for line in inp:
        t = line.rstrip("\n").split("\t")
        if len(t) < 16:
            continue
        if t[4] == "-":
            t[3], t[4] = str(_num(t[2]) - _num(t[4])), str(_num(t[2]) - _num(t[3]))
        if t[6] == "-":
            t[8], t[9] = str(_num(t[7]) - _num(t[9])), str(_num(t[7]) - _num(t[8]))
        bl = int(t[12]) + int(t[13]) + int(t[14]) + int(t[15])
        rev = "+" if t[1] == t[6] else "-"
        out.write("\t".join([t[0], t[2], t[3], t[4], rev, t[5], t[7], t[8],
                             t[9], t[12], str(bl), "255"]) + "\n")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    inp = open_text(argv[0]) if argv else sys.stdin
    convert(inp, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
