"""The 95th percentile of the window's assembly walls (host clock, each
ending in a synchronize), in seconds: the tail that the entry layer
(cli, pipeline) shows a worker's queue."""

LAYER = "entry"
UNIT = "s"
MOVES = "paf_lines_per_s"


def read(run):
    if not run.walls:
        return None
    w = sorted(run.walls)
    # nearest rank
    return w[min(len(w) - 1, max(0, -(-95 * len(w) // 100) - 1))]
