"""The control of the benchmark's check, at a cell's own size.

The check compares each assembly's GFA with the plain reference's bytes
(limit: 0 assemblies differ).  The control puts the reference in the
program's place, inside a run of the harness, with one of the
configuration's guarantees broken: the reads numbered in another order
than the order their names first appear in the PAF (the second half of
the file's names first), as a loader that parses two halves on two
threads and interns each on its own would.  The run's own comparison
has to find it not correct: a check that could not tell that control
from the reference would pass a program that broke the guarantee.

    python portbench/control.py --workload ecoli_exact --seeds 1,2,3 \
        --seconds 5

runs the harness once a seed, on the card, with the control in the
program's place, and prints one JSON line a seed: `correct` and the
numbers compared beside their limits.  The benchmark's runs do not run
it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_hook(asm):
    """Swaps the program's CLI in `asm` (a run.Assembler) for the
    reference with the reads numbered in the split order."""
    from portbench.ref.miniasm_ref import assemble

    made = {}

    def main(argv):
        paf = argv[-1]
        if paf not in made:
            made[paf] = assemble(paf, argv[:-1], intern="split")
        sys.stdout.write(made[paf].decode("latin-1"))
        return 0

    asm.cli = types.SimpleNamespace(main=main)
    return asm


def readings(workload, seeds, seconds, device_check=True, sizes=None):
    """One harness run a seed with the control in the program's place."""
    from portbench import run as R

    rows = []
    for seed in seeds:
        args = types.SimpleNamespace(workload=workload, seed=seed,
                                     seconds=seconds, trace=0)
        result, _ = R.run(args, device_check=device_check,
                          assembler_hook=control_hook, sizes=sizes)
        rows.append({"workload": workload, "seed": seed,
                     "correct": result["correct"],
                     "attempted": result["attempted"],
                     **{k: v["value"] for k, v in result["check"].items()}})
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path[:] = [ROOT] + [d for d in sys.path
                            if os.path.abspath(d or ".") != HERE]
    from portbench.run import Failed

    try:
        for row in readings(args.workload,
                            [int(s) for s in args.seeds.split(",")],
                            args.seconds):
            print(json.dumps(row), flush=True)
    except Failed as e:
        sys.stderr.write("[portbench] %s\n" % e)
        return e.code
    return 0


if __name__ == "__main__":
    sys.exit(main())
