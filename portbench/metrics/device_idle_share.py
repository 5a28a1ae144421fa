"""The device's idle share of the profiled assemblies, in percent: one
minus the union of the kernel, memcpy and memset intervals over each
assembly's stage window (from its first stage's start to its last
stage's end), summed over the assemblies."""

LAYER = "device"
UNIT = "%"
MOVES = "paf_lines_per_s"


def read(run):
    if not run.trace:
        return None
    busy = sum(b["busy_s"] for b in run.busy)
    window = sum(b["window_s"] for b in run.busy)
    if window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
