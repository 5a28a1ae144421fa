"""The graft entry's forward step on the card, kernel by kernel, for one or
more checkouts of the repository side by side (a commit and its parent,
say).

The step is `fwd` of miniasm_tpu_torch/eval/dryrun.py:entry, over the
4,096 padded hit columns: the glue in front of K2, K2 `sweep` (hit_sub),
K5 `hit_cut`, then the tail after K5.  A checkout whose K6 wrapper is
`hit2arc_tail` runs that tail as K6 alone; an older one runs torch ops
around `hit2arc_rows` (the lengths, a stack of nine rows, `good`,
`sub_del`).  For each checkout, in a process of its own, the script
prints:

  - the step's device events in the order they start, each with its mean
    device ms from torch.profiler over `--reps` calls, each after the
    128 MB L2 flush of chip_smoke.py (`flushed`) and without it: the
    kernels of the whole step, the events after K5 (the tail) and their
    sum, K6's own time;
  - the step's host time (the enqueue, the card busy) and its wall time
    from an idle card to its end;
  - where the checkout has it, K6's latency floor (staged.cu's
    ma_hit2arc_floor: an empty plain launch of K6's grid) and K6's call
    alone.

    python scripts/entry_tail.py [--reps 50] [--json OUT]
        [--variant staged] [--variant one_block] CHECKOUT [...]

--variant adds, after each checkout whose K6 is `hit2arc_tail`'s, a
scratch copy of it under build/variants/ with that K6 design: `staged`,
blocks that first stage every read's length in shared memory (4 T bytes
a block) behind a barrier and read them there; `one_block`, blocks of
1,024 threads with four columns a thread (one block at the entry's 4,096
columns).  The checkouts are not changed.

The timing helpers are chip_smoke.py's, from this checkout, run by
scripts/checkout_harness.py, whose lines are JSON between two of the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys

from checkout_harness import HERE, run, scratch_copy

# the edits of staged.cu that make each variant's K6
VARIANTS = {
    # the lengths staged before the columns, read from shared memory
    "staged": [
        ("    const int64_t first = static_cast<int64_t>(blockIdx.x)",
         "    extern __shared__ int32_t slen[];\n"
         "    for (int64_t r = threadIdx.x; r < T; r += blockDim.x)\n"
         "        slen[r] = wsub(sub[T + r], sub[r]);\n"
         "    __syncthreads();\n"
         "    const int64_t first = static_cast<int64_t>(blockIdx.x)"),
        ("ql = wsub(sub[T + qi], sub[qi]);\n"
         "        const int32_t tl = wsub(sub[T + ti], sub[ti]);\n"
         "        const Arc a = hit2arc(q, coords[i],",
         "ql = slen[qi];\n"
         "        const int32_t tl = slen[ti];\n"
         "        const Arc a = hit2arc(q, coords[i],"),
        ("hit2arc_kernel<<<blocks, H2A_THREADS, 0, stream>>>",
         "hit2arc_kernel<<<blocks, H2A_THREADS, 4 * T, stream>>>")],
    "one_block": [
        ("constexpr int H2A_THREADS = 256, H2A_PER = 1;",
         "constexpr int H2A_THREADS = 1024, H2A_PER = 4;")]}

# one checkout's measurements, after checkout_harness.PRELUDE
_CHILD = r"""
import contextlib, io
from miniasm_tpu_torch.core import hit2arc as h2a
from miniasm_tpu_torch.eval import dryrun

with contextlib.redirect_stderr(io.StringIO()):
    fwd, (cm,) = dryrun.entry(device="cuda")
new = hasattr(h2a, "hit2arc_tail")
rec = {}
orig = hook(h2a, "hit2arc_tail" if new else "hit2arc_rows", rec)
out = fwd(cm)
torch.cuda.synchronize()
n, T = cm.shape[1], out[5].shape[0]
step = lambda: fwd(cm)  # noqa: E731
for flush in (True, False):
    seq = cs._device_sequence(step, reps, flush)
    k5 = [i for i, (name, _ms) in enumerate(seq) if "hit_cut_kernel" in name]
    tail = seq[k5[0] + 1:]
    say(piece="fwd", flushed=flush, columns=n, reads=T,
        events=[[name[:160], ms] for name, ms in seq],
        kernels=sum(1 for name, _ms in seq
                    if not name.startswith(("Memset", "Memcpy"))),
        device_ms=sum(ms for _n, ms in seq), tail_events=len(tail),
        tail_device_ms=sum(ms for _n, ms in tail),
        k6_device_ms=sum(ms for name, ms in seq if "hit2arc_kernel" in name))
say(piece="fwd", host_us=cs._host_us(step, reps),
    wall_us=cs._wall_us(step, reps))
try:
    cuda._lib("staged.cu").ma_hit2arc_floor
except AttributeError:
    sys.exit(0)
f = cs._hit2arc_floor(n, T)
say(piece="floor", device_ms=cs._device_ms(f, reps), ms=cs._time_ms(f, reps),
    device_ms_unflushed=cs._device_ms(f, reps, flush=False))
a, k = rec[orig.__name__][0]
pieces("k6", lambda: orig(*a, **k))
"""


def variant(tree: str, name: str) -> str | None:
    """A scratch copy of tree's package with the K6 design `name`, or None
    where tree's K6 is not `hit2arc_tail`'s."""
    cu = os.path.join("miniasm_tpu_torch", "csrc", "staged.cu")
    with open(os.path.join(tree, cu)) as f:
        text = f.read()
    if any(text.count(old) != 1 for old, _new in VARIANTS[name]):
        return None
    for old, new in VARIANTS[name]:
        text = text.replace(old, new)
    base = os.path.basename(os.path.normpath(os.path.abspath(tree)))
    work = scratch_copy(tree, os.path.join(HERE, "build", "variants",
                                           "%s_%s" % (base or "tree", name)))
    with open(os.path.join(work, cu), "w") as f:
        f.write(text)
    return work


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json", default=None)
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    a = ap.parse_args(argv)
    trees = []
    for tree in a.checkouts:
        trees.append(tree)
        trees += [w for w in (variant(tree, v) for v in a.variant) if w]
    return run(_CHILD, trees, os.devnull, a.reps, a.json)


if __name__ == "__main__":
    sys.exit(main())
