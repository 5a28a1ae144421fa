"""The graph layer's seconds per assembly: the self times of the
program's `order` and `graph_build` stages (the arc order, graph/asg.py),
the mean over the window's assemblies."""

LAYER = "graph"
UNIT = "s"
MOVES = "paf_lines_per_s"


def read(run):
    return run.stage_mean(("order", "graph_build"))
