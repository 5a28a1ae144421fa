"""The clean layer's seconds per assembly: the self time of the program's
`clean` stage (graph/hybrid.py, devclean.py, devbub.py: K3, K14, K4 and
the host's ordered commits), the mean over the window's assemblies."""

LAYER = "clean"
UNIT = "s"
MOVES = "paf_lines_per_s"


def read(run):
    return run.stage_mean(("clean",))
