"""SAM -> PAF with full CIGAR accounting (reference misc/sam2paf.js):
M/I/D/N/S/H/=/X ops, NM reconciliation (+nn tag), mm/io/in/do/dn tags.

The port's copy of miniasm_tpu/interop/sam2paf.py.
"""

from __future__ import annotations

import getopt
import re
import sys

from ..io.paf import open_text

_CIG = re.compile(r"(\d+)([MIDSHNX=])")


def convert(inp, out, *, pri_only=False):
    lens = {}
    lineno = 0
    for line in inp:
        line = line.rstrip("\n")
        lineno += 1
        if line.startswith("@"):
            if line.startswith("@SQ"):
                mn = re.search(r"\tSN:(\S+)", line)
                ml_ = re.search(r"\tLN:(\d+)", line)
                if mn and ml_:
                    lens[mn.group(1)] = int(ml_.group(1))
            continue
        t = line.split("\t")
        if len(t) < 11:
            continue
        flag = int(t[1])
        if t[9] != "*" and t[10] != "*" and len(t[9]) != len(t[10]):
            raise ValueError("ERROR at line %d: inconsistent SEQ and QUAL lengths - %d != %d"
                             % (lineno, len(t[9]), len(t[10])))
        if t[2] == "*" or (flag & 4):
            continue
        if pri_only and (flag & 0x100):
            continue
        tlen = lens.get(t[2])
        if tlen is None:
            raise ValueError("ERROR at line %d: can't find the length of contig %s"
                             % (lineno, t[2]))
        m = re.search(r"\tnn:i:(\d+)", line)
        nn = int(m.group(1)) if m else 0
        m = re.search(r"\tNM:i:(\d+)", line)
        NM = int(m.group(1)) if m else None
        have_NM = NM is not None
        NM = (NM or 0) + nn
        clip = [0, 0]
        I = [0, 0]
        D = [0, 0]
        M = N = ql = tl = mm = 0
        ext_cigar = False
        n_cigar = 0
        for num, op in _CIG.findall(t[5]):
            l = int(num)
            if op == "M":
                M += l; ql += l; tl += l; ext_cigar = False
            elif op == "I":
                I[0] += 1; I[1] += l; ql += l
            elif op == "D":
                D[0] += 1; D[1] += l; tl += l
            elif op == "N":
                N += l; tl += l
            elif op == "S":
                clip[0 if M == 0 else 1] = l; ql += l
            elif op == "H":
                clip[0 if M == 0 else 1] = l
            elif op == "=":
                M += l; ql += l; tl += l; ext_cigar = True
            elif op == "X":
                M += l; ql += l; tl += l; mm += l; ext_cigar = True
            n_cigar += 1
        if n_cigar > 65535:
            sys.stderr.write("WARNING at line %d: %d CIGAR operations\n"
                             % (lineno, n_cigar))
        if tl + int(t[3]) - 1 > tlen:
            sys.stderr.write("WARNING at line %d: alignment end position "
                             "larger than ref length; skipped\n" % lineno)
            continue
        if t[9] != "*" and len(t[9]) != ql:
            sys.stderr.write("WARNING at line %d: SEQ length inconsistent "
                             "with CIGAR (%d != %d); skipped\n"
                             % (lineno, len(t[9]), ql))
            continue
        if not have_NM or ext_cigar:
            NM = I[1] + D[1] + mm
        if NM < I[1] + D[1] + mm:
            sys.stderr.write("WARNING at line %d: NM is less than the total "
                             "number of gaps (%d < %d)\n"
                             % (lineno, NM, I[1] + D[1] + mm))
            NM = I[1] + D[1] + mm
        extra = ["mm:i:%d" % (NM - I[1] - D[1]), "io:i:%d" % I[0],
                 "in:i:%d" % I[1], "do:i:%d" % D[0], "dn:i:%d" % D[1]]
        match = M - (NM - I[1] - D[1])
        blen = M + I[1] + D[1]
        qlen = M + I[1] + clip[0] + clip[1]
        if flag & 16:
            qs, qe = clip[1], qlen - clip[0]
        else:
            qs, qe = clip[0], qlen - clip[1]
        ts = int(t[3]) - 1
        te = ts + M + D[1] + N
        row = [t[0], qlen, qs, qe, "-" if flag & 16 else "+", t[2], tlen,
               ts, te, match, blen, t[4]]
        out.write("\t".join(str(x) for x in row) + "\t"
                  + "\t".join(extra) + "\n")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, args = getopt.getopt(argv, "p")
    kw = {"pri_only": any(c == "-p" for c, _ in opts)}
    inp = open_text(args[0]) if args else sys.stdin
    convert(inp, sys.stdout, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
