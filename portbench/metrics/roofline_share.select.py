"""The select kernels' share of their roofline, in percent: the least
time the card could take for the layer's bytes, over the device time of
the kernels that start inside the `select+fetch` stage of the profiled
assemblies.

The bytes are counted from sizes that the plain reference works out, not
from any kernel's launch arguments, so that the count stays the same
whatever implements the layer.  The layer's work, read once and written
once: the loaded hit columns, seven 32-bit words a kept PAF record (qid
qs qe tid ts te rev; the loader's (7, n) columns), the per-read length
(4 bytes), and out, the arcs, four 32-bit words each (u v l ol), and the
per-read trim table and marks, 3 words and 3 bytes a read.  The layer is
bandwidth-bound: its arithmetic is a few integer operations a byte, far
under the card's 33.5 TOP/s int32, so the bound is the bytes over the
HBM's peak, from the table of peaks."""

LAYER = "select kernels"
UNIT = "%"
MOVES = "paf_lines_per_s"


def layer_bytes(counts) -> int:
    n_rec, n_seq, n_arc = counts["records"], counts["reads"], counts["arcs"]
    return 7 * 4 * n_rec + 4 * n_seq + 4 * 4 * n_arc + (3 * 4 + 3) * n_seq


def read(run):
    if not run.trace or run.peak_bytes_per_s is None:
        return None
    dev, n = 0.0, 0
    for asm in run.trace:
        st = asm.stage("select+fetch")
        if st is None:
            continue
        dev += sum(b - a for a, b, _, _ in asm.kernels_in(*st)) / 1e6
        n += 1
    if dev <= 0:
        return None
    least = n * layer_bytes(run.counts) / run.peak_bytes_per_s
    return 100.0 * least / dev
