"""K18's containment pass and K10's unpack of one load on the card, call by
call, for one or more checkouts of the repository side by side (a commit
and its parent, say).

K18 `hit_marks` (miniasm_tpu_torch/csrc/staged.cu) makes the staged
path's per-read marks; K10 `unpack4` (csrc/loader.cu) writes the main
path's loaded pieces into the (7, n) colmat.  For each checkout, in a
process of its own, the script

  - runs the staged `-1 -p ug` CLI run on the clean PAF with the
    `hit_marks` wrapper recorded (the containment's calls and the string
    graph's), then times each recorded call by its mode;
  - loads the clean PAF on the card (`load_hits_mt`, the main path's
    loader) with the `unpack4` wrapper recorded, then times all of the
    load's calls together, replayed in order;

each timing by scripts/checkout_harness.py (`pieces`: the device time by
event name, after the 128 MB L2 flush and without it, the CUDA-event
time both ways and the host time).  It also times K18's library call for
the used marks: one index_fill_ of ones over the concatenated qid and
tid rows, made before the timing.

    python scripts/marks_unpack.py --paf build/smoke/ecoli_4600000.paf \\
        [--reps 50] [--json OUT] [--cut-targets] CHECKOUT [CHECKOUT ...]

--cut-targets adds, after each checkout whose staged.cu has the "used"
mode of the kernel (the trees before the containment's one launch), a
scratch copy of it under build/variants/ whose used mode stores no
target mark: the used call's time without its scattered target stores.
The checkouts are not changed.
"""

from __future__ import annotations

import argparse
import os
import sys

from checkout_harness import HERE, run, scratch_copy

# the used mode's target store in the kernel of the trees that have it
USED_TARGET = ("        mark[qi] = 1;\n        mark[ti] = 1;\n"
               "        return;\n")

# one checkout's measurements, after checkout_harness.PRELUDE
_CHILD = r"""
import contextlib, io
from miniasm_tpu_torch import cli
from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.core import hit2arc as h2a
from miniasm_tpu_torch.io.native import pafload

# K18: the staged -1 run's calls, by mode
rec = {}
orig = hook(h2a, "hit_marks", rec)
try:
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["-1", "-p", "ug", paf])
except Exception as e:
    # a --cut-targets copy drops the reads seen only as targets, which
    # may leave its run nothing to finish with: the calls it made are
    # timed all the same
    rc = repr(e)
torch.cuda.synchronize()
if rc and "hit_marks" not in rec:
    sys.exit("the staged -1 run failed: %s" % rc)
setattr(h2a, "hit_marks", orig)
for a, k in rec["hit_marks"]:
    cols, mode, T = a[0], a[1], a[2]
    if not T:
        continue
    pieces("hit_marks_" + mode, lambda a=a, k=k: orig(*a, **k),
           hits=cols.shape[1], reads=T)
    if mode == "contained":
        # the used half's library call: one index_fill_ of ones
        idx = torch.cat([cols[0], cols[3]]).clamp(0, T - 1).long()
        lib = torch.zeros(T, dtype=torch.uint8, device=cols.device)
        say(piece="used_library", ms=cs._time_ms(
            lambda: lib.index_fill_(0, idx, 1), reps), hits=cols.shape[1],
            reads=T)
# K10: one load's calls, replayed in order
uorig = hook(pafload, "unpack4", rec)
opt = Opt()
colmat, d, h = pafload.load_hits_mt(paf, opt.min_span, opt.min_match,
                                    bi_dir=True,
                                    min_iden=float(opt.min_iden),
                                    device=torch.device("cuda"))
torch.cuda.synchronize()
setattr(pafload, "unpack4", uorig)
h.free()


def load_all():
    for a, k in rec["unpack4"]:
        uorig(*a, **k)


pieces("unpack4_load", load_all, calls=len(rec["unpack4"]),
       records=colmat.shape[1])
"""


def cut_targets(tree: str) -> str | None:
    """A scratch copy of tree's package whose used mode stores no target
    mark, or None where staged.cu has no used mode."""
    cu = os.path.join("miniasm_tpu_torch", "csrc", "staged.cu")
    with open(os.path.join(tree, cu)) as f:
        text = f.read()
    if text.count(USED_TARGET) != 1:
        return None
    name = os.path.basename(os.path.normpath(tree)) or "tree"
    work = scratch_copy(tree, os.path.join(HERE, "build", "variants",
                                           name + "_cut_targets"))
    with open(os.path.join(work, cu), "w") as f:
        f.write(text.replace(USED_TARGET,
                             "        mark[qi] = 1;\n        return;\n"))
    return work


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--paf", required=True)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json", default=None)
    ap.add_argument("--cut-targets", action="store_true")
    a = ap.parse_args(argv)
    trees = []
    for tree in map(os.path.abspath, a.checkouts):
        first = tree not in trees
        trees.append(tree)
        if first and a.cut_targets:
            trees += [t for t in [cut_targets(tree)] if t]
    return run(_CHILD, trees, a.paf, a.reps, a.json)


if __name__ == "__main__":
    sys.exit(main())
