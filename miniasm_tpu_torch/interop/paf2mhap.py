"""PAF -> MHAP (reference misc/paf2mhap.pl): needs the FASTA for the
name -> 1-based id table; drops self matches; identity = ml/bl (4 decimals,
-p scales by 100).

The port's copy of miniasm_tpu/interop/paf2mhap.py."""

from __future__ import annotations

import getopt
import re
import sys

from ..io.paf import open_text


def convert(fasta_fn, inp, out, *, pct=False):
    ids = {}
    cnt = 0
    with open_text(fasta_fn) as f:
        for line in f:
            m = re.match(r"^>(\S+)", line)
            if m and m.group(1) not in ids:
                cnt += 1
                ids[m.group(1)] = cnt
    for line in inp:
        t = line.split()
        if len(t) < 11 or t[0] == t[5]:  # ignore self matches
            continue
        m = re.search(r"cm:i:(\d+)", line)
        cm = int(m.group(1)) if m else 0
        r = int(t[9]) / int(t[10])
        rs = "%.4f" % (100.0 * r if pct else r)
        if t[0] not in ids or t[5] not in ids:
            raise KeyError("read name not in FASTA: %s / %s" % (t[0], t[5]))
        out.write(" ".join(str(x) for x in [
            ids[t[0]], ids[t[5]], rs, cm, 0, t[2], t[3], t[1],
            0 if t[4] == "+" else 1, t[7], t[8], t[6]]) + "\n")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, args = getopt.getopt(argv, "p")
    pct = any(c == "-p" for c, _ in opts)
    if not args:
        sys.stderr.write("Usage: paf2mhap [-p] <in.fa> <in.paf>\n")
        return 1
    inp = open_text(args[1]) if len(args) > 1 else sys.stdin
    convert(args[0], inp, sys.stdout, pct=pct)
    return 0


if __name__ == "__main__":
    sys.exit(main())
