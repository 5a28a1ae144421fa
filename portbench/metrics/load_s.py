"""The PAF loader's seconds per assembly: the self time of the program's
`load+upload` stage (io/native/pafload.py, pafmt.cpp, K9 decode3, K10
unpack4), the mean over the window's assemblies."""

LAYER = "io loader"
UNIT = "s"
MOVES = "paf_lines_per_s"


def read(run):
    return run.stage_mean(("load+upload",))
