"""Random-config byte-parity fuzz of the port: the counterpart of the JAX
package's scripts/fuzz.py.

Each case draws a synthetic dataset (genome length, coverage, read
length, dropout, circularity; fuzz.py:48-62) and a flag set from the
reference's surface: every numeric option (-m -i -s -c -o -h -I -g -d -e
-n -r -F) and the structural ones (-R -b -1 -2 -S -p).  `run_case` runs
the port's CLI on a device and byte-compares its stdout and exit code
with an oracle's: by default the port on the CPU.  The tests pass the
JAX package's CLI as the oracle; this module imports no JAX.

    python -m miniasm_tpu_torch.eval.fuzz [N_CASES] [--seed S]
        [--out FUZZ.json]

runs on the card (MINIASM_TPU_TORCH_DEVICE=cpu: on the CPU), prints one
JSON line per case and a summary line, writes every case to --out, and
exits 1 when a case differs.
"""

from __future__ import annotations

import io
import json
import os
import random
import sys
import tempfile
import time
from contextlib import redirect_stderr, redirect_stdout

# the values each numeric option draws (a reference default among them
# where it is a round number): -c 0 keeps every read, -s 1000 and -m 50
# admit more overlaps, -i 0.5 drops weak ones
NUMERIC = {"-m": ["50", "100", "200", "500"],
           "-i": ["0.02", "0.2", "0.5"],
           "-s": ["1000", "2000", "3000"],
           "-c": ["0", "2", "3", "4"],
           "-o": ["500", "2000", "4000"],
           "-h": ["200", "500", "2000"],
           "-I": ["0.5", "0.8", "0.9"],
           "-g": ["200", "500", "2000"],
           "-d": ["5000", "20000", "50000"],
           "-e": ["2", "4", "8"],
           "-n": ["1", "2", "4"],
           "-F": ["0.6", "0.8", "0.95"]}


def draw_case(rng: random.Random) -> dict:
    """One case: the dataset as fuzz.py:48-62 draws it, then the
    structural flags with fuzz.py's odds, -r and each other numeric
    option with odds 0.25 and 0.15, and the output format."""
    case = {"gl": rng.choice([150_000, 300_000, 500_000, 800_000]),
            "cov": rng.choice([8.0, 12.0, 20.0, 35.0, 40.0]),
            "mean_read": rng.choice([3000, 6000, 8000, 12000]),
            "circular": rng.random() < 0.25,
            "drop": rng.choice([0.0, 0.0, 0.2, 0.4, 0.55]),
            "seed": rng.randrange(10000)}
    args = []
    if rng.random() < 0.3:
        args += ["-R"]
    if rng.random() < 0.2:
        args += ["-b"]
    if rng.random() < 0.2:
        args += ["-1"] if rng.random() < 0.5 else ["-2"]
    if rng.random() < 0.25:
        args += ["-S", str(rng.choice([2, 3, 4, 5, 6, 7, 9, 10]))]
    if rng.random() < 0.25:
        args += ["-r", "%.1f,%.1f" % (rng.uniform(0.5, 0.9),
                                      rng.uniform(0.1, 0.5))]
    for flag, values in NUMERIC.items():
        if rng.random() < 0.15:
            args += [flag, rng.choice(values)]
    args += ["-p", rng.choice(["ug", "ug", "sg", "bed", "paf"])]
    case["args"] = args
    return case


def write_case(case: dict, out_dir: str) -> str:
    """Simulate the case's reads and write its PAF, its lines dropped
    with random.Random(seed) (fuzz.py:64-70); returns the path."""
    from .simulate import simulate, write_paf

    sim = simulate(genome_len=case["gl"], coverage=case["cov"],
                   mean_read=case["mean_read"], seed=case["seed"],
                   circular=case["circular"])
    paf = os.path.join(out_dir, "case%d.paf" % case["seed"])
    write_paf(sim, paf)
    if case["drop"]:
        drng = random.Random(case["seed"])
        with open(paf) as f:
            kept = [ln for ln in f if drng.random() > case["drop"]]
        with open(paf, "w") as f:
            f.writelines(kept)
    return paf


def port_cli(args, device) -> tuple[int, str]:
    """The port's CLI in this process on `device`; (exit code, stdout)."""
    from .. import cli
    from ..device import ENV

    old = os.environ.get(ENV)
    os.environ[ENV] = str(device)
    buf = io.StringIO()
    try:
        with redirect_stdout(buf), redirect_stderr(io.StringIO()):
            rc = cli.main(list(args))
    finally:
        if old is None:
            os.environ.pop(ENV, None)
        else:
            os.environ[ENV] = old
    return rc, buf.getvalue()


def run_case(case: dict, device="cuda", oracle=None) -> dict:
    """Run the case's flags on its data with the port on `device` and
    with `oracle` (a callable: args -> (exit code, stdout); by default
    the port on the CPU).  Returns the case with ok (equal exit codes and
    stdout), the stdout bytes and the port's seconds."""
    oracle = oracle or (lambda args: port_cli(args, "cpu"))
    with tempfile.TemporaryDirectory(prefix="fuzz_") as td:
        paf = write_case(case, td)
        args = case["args"] + [paf]
        t0 = time.time()
        try:
            rc, out = port_cli(args, device)
        except Exception as e:  # noqa: BLE001 -- recorded, the case fails
            return dict(case, ok=False, err=repr(e)[:300])
        dt = time.time() - t0
        want_rc, want = oracle(args)
    rec = dict(case, ok=rc == want_rc and out == want, rc=rc,
               bytes=len(out), seconds=dt)
    if not rec["ok"]:
        rec["oracle"] = {"rc": want_rc, "bytes": len(want)}
    return rec


def main(argv=None) -> int:
    import argparse

    from ..device import ENV

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_cases", nargs="?", type=int, default=30)
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    device = os.environ.get(ENV) or "cuda"
    rng = random.Random(a.seed)
    results = []
    for c in range(a.n_cases):
        rec = dict(run_case(draw_case(rng), device), case=c)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    fails = sum(not r["ok"] for r in results)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"cases": a.n_cases, "fails": fails, "device": device,
                       "seed": a.seed, "results": results}, f, indent=1)
    print(json.dumps({"cases": a.n_cases, "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
