"""The select layer's seconds per assembly: the self time of the
program's `select+fetch` stage (select/fused2.py: K2, K1, K13 and the
fetch of the arcs), the mean over the window's assemblies."""

LAYER = "select"
UNIT = "s"
MOVES = "paf_lines_per_s"


def read(run):
    return run.stage_mean(("select+fetch",))
