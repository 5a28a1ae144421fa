"""Minimal FASTA/FASTQ streaming reader (reference kseq.h:193-239
semantics: record name = text up to first whitespace; sequence lines
concatenated; FASTQ quality skipped).

The port's copy of miniasm_tpu/io/fastx.py."""

from __future__ import annotations

from .paf import open_text


def read_fastx(fn: str):
    """Yield (name, seq) for each record."""
    name = None
    seq_parts: list[str] = []
    with open_text(fn) as f:
        it = iter(f)
        line = next(it, None)
        while line is not None:
            line = line.rstrip("\n")
            if not line:
                line = next(it, None)
                continue
            if line[0] in ">@":
                hdr = line[1:]
                name = hdr.split()[0] if hdr else ""
                seq_parts = []
                is_fastq = line[0] == "@"
                line = next(it, None)
                while line is not None and (not line or line[0] not in ">@+"):
                    seq_parts.append(line.rstrip("\n"))
                    line = next(it, None)
                seq = "".join(seq_parts)
                if is_fastq and line is not None and line and line[0] == "+":
                    # skip quality: read until qual length >= seq length
                    qlen = 0
                    line = next(it, None)
                    while line is not None and qlen < len(seq):
                        qlen += len(line.rstrip("\n"))
                        line = next(it, None)
                yield name, seq
            else:
                line = next(it, None)
