"""The unitig and print layer's seconds per assembly: the self times of
the program's `unitig`, `seq` and `print` stages (unitig/, gfa/writer.py),
the mean over the window's assemblies."""

LAYER = "unitig and print"
UNIT = "s"
MOVES = "paf_lines_per_s"


def read(run):
    return run.stage_mean(("unitig", "seq", "print"))
