"""The main path's select tail on the card, piece by piece, for one or more
checkouts of the repository side by side (a commit and its parent, say).

The tail is what select_build2 (miniasm_tpu_torch/select/fused2.py) runs
after the final cut pass: the per-read marks (K12 `read_marks`), the
flags row built from them, and the arcs compacted and ordered by hit key
(K13 `arc_order`).  A checkout whose `arc_order` takes `n_seq` runs the
marks, the flags row and the arcs in one launch; an older one runs K12,
torch ops for the flags row ("glue") and K13.  For each checkout, in a
process of its own, the script loads the clean PAF on the card, runs
select_build2 twice with the tail's wrappers recorded, then times each
recorded call:

  - the device time by event name (kernels, memsets), from torch.profiler
    over `--reps` calls, each after the 128 MB L2 flush of chip_smoke.py
    (`flushed`) and without it (`unflushed`), with CUDA-event times of the
    wrapper both ways and its host time (the enqueue, the card busy);
  - the arcs per read (the tiers of the sort: the reads sorted by a warp,
    by a block in shared memory, by a block in device memory);
  - a fused launch's grid, and the empty cooperative launch of that grid
    with 0, 1 and as many grid syncs as the launch makes (its floor);
  - K12 on the sharded step's call (run_sharded on a one-rank NCCL
    group), and one torch scatter_reduce_("amax") over the concatenated
    query and target indices of the main path's call, K12's library call.

    python scripts/select_tail.py --paf build/smoke/ecoli_4600000.paf \\
        [--reps 50] [--json OUT] CHECKOUT [CHECKOUT ...]
    python scripts/select_tail.py --simulate build/smoke

--floors-only stops after the fused launch's grid and floors.
--simulate writes the PAFs chip_smoke.py simulates (the E. coli-scale
clean set and its noisy twin) and exits.  The timing helpers are
chip_smoke.py's, from this checkout, run by scripts/checkout_harness.py,
whose lines are JSON between two of the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys

from checkout_harness import HERE, run

# one checkout's measurements, after checkout_harness.PRELUDE
_CHILD = r"""
import inspect, io, tempfile
from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.io.native.pafload import load_hits_mt
from miniasm_tpu_torch.parallel import full, group
from miniasm_tpu_torch.select import fused2

floors_only = args[0] == "1"
fused = "n_seq" in inspect.signature(fused2.arc_order).parameters
rec = {}
opt = Opt()
orig = {k: hook(fused2, k, rec) for k in ("read_marks", "arc_order")}
colmat, d, h = load_hits_mt(paf, opt.min_span, opt.min_match, bi_dir=True,
                            min_iden=float(opt.min_iden),
                            device=torch.device("cuda"))
for _ in range(2):
    fused2.select_build2(colmat, d, opt, bi_dir=True)
torch.cuda.synchronize()
a, k = rec["arc_order"][0]
if fused:
    grid = [0] * 4
    orig["arc_order"](*a, **dict(k, grid=grid))
    say(piece="grid", blocks=grid[0], reads_a_block=grid[1],
        most_blocks=grid[2], syncs=grid[3])
    for syncs in sorted({0, 1, grid[3]}):
        f = cs._coop_floor(grid[0], syncs)
        say(piece="floor", syncs=syncs, device_ms=cs._device_ms(f, reps),
            ms=cs._time_ms(f, reps),
            device_ms_unflushed=cs._device_ms(f, reps, flush=False))
    if floors_only:
        sys.exit(0)
    pieces("arc_order", lambda: orig["arc_order"](*a, **k))
    res, tiers = fused2.arc_order_tiers(*a, **k)
    head, _flags, arcs = fused2.arc_live(res, a[3], k.get("meta", 3))
    row = arcs[4].long()
    T = a[2].shape[0]
else:
    ta, tk = rec["read_marks"][0]
    pieces("read_marks", lambda: orig["read_marks"](*ta, **tk))
    pieces("arc_order", lambda: orig["arc_order"](*a, **k))
    tab, mdel = a[2], a[3]
    i32 = torch.int32

    def glue():
        used = (tab & 1) != 0
        cont = (tab & 2) != 0
        pal = (tab & 4) != 0
        return (mdel.to(i32) | (cont.to(i32) << 1) | (used.to(i32) << 2)
                | (pal.to(i32) << 3))
    pieces("glue", glue)
    res, tiers = fused2.arc_order_tiers(*a)
    n = a[0].shape[1]
    head = res[:3]
    row = res[3 + 8 * n:3 + 8 * n + int(res[1])].long()
    T = tab.shape[0]
read = torch.cat([a[0][0], a[0][3]])[row].clamp(0, T - 1).long()
c = torch.bincount(read, minlength=T)
say(piece="tiers", rows=a[0].shape[1], arcs=int(head[1]),
    m_contained=int(head[0]), dup_hit=int(head[2]),
    most_arcs_a_read=int(c.max()), reads_with_arcs=int((c > 0).sum()),
    reads_over_256=int((c > 256).sum()), block_reads=int(tiers[0]),
    device_memory_reads=int(tiers[1]))
# K12's library call: one scatter_reduce_ amax of the mark words over the
# concatenated query and target indices of the main path's call
colmat_t, out_t = (rec["read_marks"][0][0][:2] if "read_marks" in rec
                   else a[:2])
bits = out_t[4]
vq, vm = (bits & 1) != 0, (bits & 2) != 0
rq = torch.where(vq, out_t[5], 0)
rm = torch.where(vm, out_t[10], 0)
qb = ((vq | vm).to(torch.int32)
      | (((rq == -2) | (rm == -3)).to(torch.int32) << 1))
tb = ((vq | vm).to(torch.int32)
      | (((rq == -3) | (rm == -2)).to(torch.int32) << 1))
idx = torch.cat([colmat_t[0], colmat_t[3]]).clamp(0, T - 1).long()
val = torch.cat([qb, tb])
lib = torch.zeros(T, dtype=torch.int32, device="cuda")
say(piece="read_marks_library", ms=cs._time_ms(
    lambda: lib.scatter_reduce_(0, idx, val, "amax"), reps))
h.free()
rec.pop("read_marks", None)
with tempfile.TemporaryDirectory() as rdv:
    group.init(0, 1, "file://" + os.path.join(rdv, "rdv"), device="cuda")
    try:
        full.run_sharded(paf, opt, out=io.StringIO())
    finally:
        group.destroy()
ta, tk = rec["read_marks"][0]
pieces("read_marks_sharded", lambda: orig["read_marks"](*ta, **tk))
"""


def simulate(ddir: str) -> None:
    """chip_smoke.py's clean and noisy E. coli-scale PAFs, into ddir."""
    import random

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from miniasm_tpu_torch.eval.simulate import simulate as sim, write_paf

    os.makedirs(ddir, exist_ok=True)
    paf = os.path.join(ddir, "ecoli_%d.paf" % cs.ECOLI_BP)
    write_paf(sim(genome_len=cs.ECOLI_BP, coverage=cs.COVERAGE,
                  mean_read=cs.MEAN_READ, sd_read=cs.SD_READ,
                  seed=cs.SEED), paf)
    rng = random.Random(36)
    with open(paf) as f, open(paf[:-4] + "_noisy.paf", "w") as g:
        for line in f:
            if rng.random() > 0.50:
                g.write(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--paf")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json", default=None)
    ap.add_argument("--simulate", default=None)
    ap.add_argument("--floors-only", action="store_true",
                    help="a fused launch's grid and floors, no other "
                    "timing")
    a = ap.parse_args(argv)
    if a.simulate:
        simulate(a.simulate)
        return 0
    if not a.paf or not a.checkouts:
        ap.error("--paf and at least one checkout are needed")
    return run(_CHILD, a.checkouts, a.paf, a.reps, a.json,
               ["1" if a.floors_only else "0"])


if __name__ == "__main__":
    sys.exit(main())
