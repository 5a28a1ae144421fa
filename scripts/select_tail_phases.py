"""The phases of the select tail's one launch (K13 `arc_order`,
miniasm_tpu_torch/csrc/select.cu) timed apart on the card.

The card's machine has no ncu, so the script copies the checkout's
package into a scratch directory, adds a timestamp to the copy of the
kernel at each phase boundary (thread 0 of every block takes
%globaltimer there and keeps the latest of the blocks by an atomic max,
so a boundary is the moment the last block reaches it, grid sync
included), builds the copy, loads the clean PAF on the card, runs
select_build2 once to record the tail's call, and times that call `--reps`
times after the 128 MB L2 flush of chip_smoke.py and as many times
without it.  It prints the mean microseconds of the six phases (zero,
marks, count, offsets, scatter, sort) and their sum, beside the card's
name and power limit.  The checkout itself is not changed.

    python scripts/select_tail_phases.py --paf build/smoke/ecoli_4600000.paf \\
        [--reps 30] [--work build/phases] [CHECKOUT]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from checkout_harness import HERE, scratch_copy, smi

# (marker in select.cu, stamp index): a stamp goes before each marker
MARKERS = [("    // ---- 1. zero", 0), ("    // ---- 2. marks", 1),
           ("    // ---- 3. count", 2), ("    // ---- 4. offsets", 3),
           ("    // ---- 5. scatter", 4), ("    // ---- 6. sort", 5),
           ("    // dup_hit: one atomic a block", 6)]
PHASES = ("zero", "marks", "count", "offsets", "scatter", "sort")

_STAMP = '''
__device__ unsigned long long* tail_stamps;

__device__ __forceinline__ void tail_stamp(int k) {
    if (tail_stamps && threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        atomicMax(tail_stamps + k, t);
    }
}
'''
# appended at the end of the file, outside its unnamed namespace
_ENTRY = '''
extern "C" int ma_tail_stamps(unsigned long long* p) {
    return static_cast<int>(cudaMemcpyToSymbol(tail_stamps, &p, sizeof(p)));
}
'''

_RUN = r"""
import ctypes, sys
import numpy as np
import torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import chip_smoke as cs
from miniasm_tpu_torch import cuda
from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.io.native.pafload import load_hits_mt
from miniasm_tpu_torch.select import fused2

cuda.build()
rec = {}
orig = fused2.arc_order


def hook(*a, **k):
    rec.setdefault("call", (a, k))
    return orig(*a, **k)


fused2.arc_order = hook
opt = Opt()
col, d, h = load_hits_mt(sys.argv[3], opt.min_span, opt.min_match,
                         bi_dir=True, min_iden=float(opt.min_iden),
                         device=torch.device("cuda"))
fused2.select_build2(col, d, opt, bi_dir=True)
a, k = rec["call"]
st = torch.zeros(8, dtype=torch.int64, device="cuda")
f = cuda._lib("select.cu").ma_tail_stamps
f.argtypes = [ctypes.c_void_p]
if f(st.data_ptr()):
    raise SystemExit("ma_tail_stamps failed")
reps = int(sys.argv[4])
for flush in (True, False):
    acc = np.zeros(6)
    for _ in range(reps):
        if flush:
            cs._flush()
        torch.cuda.synchronize()
        st.zero_()
        orig(*a, **k)
        torch.cuda.synchronize()
        acc += np.diff(st.cpu().numpy().astype(np.int64)[:7])
    print("%s us: %s; sum %.3f" % (
        "flushed" if flush else "unflushed",
        ", ".join("%s %.3f" % (p, x / reps / 1e3)
                  for p, x in zip(sys.argv[5].split(","), acc)),
        acc.sum() / reps / 1e3), flush=True)
h.free()
"""


def stamped(src: str) -> str:
    """select.cu with a timestamp before each phase marker."""
    i = src.index("\nstruct SelectTail {")
    src = src[:i] + _STAMP + src[i:]
    for marker, k in MARKERS:
        if src.count(marker) != 1:
            raise SystemExit("select.cu: marker %r not found once" % marker)
        src = src.replace(marker, "    tail_stamp(%d);\n%s" % (k, marker))
    return src + _ENTRY


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout", nargs="?", default=HERE)
    ap.add_argument("--paf", required=True)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--work", default=os.path.join(HERE, "build", "phases"))
    a = ap.parse_args(argv)
    work = scratch_copy(os.path.abspath(a.checkout), os.path.abspath(a.work))
    cu = os.path.join(work, "miniasm_tpu_torch", "csrc", "select.cu")
    with open(cu) as f:
        src = stamped(f.read())
    with open(cu, "w") as f:
        f.write(src)
    card = smi()
    print(card, flush=True)
    rc = subprocess.run([sys.executable, "-c", _RUN, work, HERE,
                         os.path.abspath(a.paf), str(a.reps),
                         ",".join(PHASES)], cwd=work).returncode
    print(card, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
