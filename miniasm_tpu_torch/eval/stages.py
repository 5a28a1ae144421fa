"""Select and clean stage times of the port, for several checkouts of the
repository side by side (a commit and its parent, say).

Each checkout runs in processes of its own, in the order given, the whole
order `--rounds` times, the second round reversed (A B, B A, ...), so that
two checkouts are compared on one card within one call.  Before its first
round a checkout runs the CLI once in a process of its own, untimed, after
building every kernel source of its own (on a card), so that its kernels
and host loader are built.  The runs are `-p ug` on the
clean PAF, `-p paf` on it and `-p ug` on the noisy PAF; `--runs` names
others of RUN_ARGS: the staged path's `-1`, `-2` and `-S 4 -p bed`, and
run_sharded on a one-rank group (NCCL on the card, gloo on the CPU; its
stages are full.LAST_TIMING's).  By default each
run is the first and only run of a fresh process, as a user's one-shot
CLI run is (CUDA context, module loads, pinned host memory all paid in
it); with --warm one process runs the CLI once to warm up, then the three.
Each run prints one JSON line: its stage ticks (pipeline.LAST_TIMING,
cumulative), the select stage's own seconds (`select_s`: its tick less
the tick before it), and, with the recorder on (utils/timers.py
`tracing`), its spans' seconds summed by path (`spans`:
select+fetch/enqueue, select+fetch/fetch, clean/.../detect, ...) and its
counters (`counters`: clean.detects, load.records, ...; the sharded runs'
from full.LAST_TRACE), both empty for a checkout without the recorder.
The card's name and power limit come first, as nvidia-smi gives them.
With --trace DIR the runs named by --trace-runs run under the CLI's
MINIASM_TPU_PROFILE (their times then include the profiler's cost), and
for each the script prints the host calls that take the most time inside
the select stage (`stage:select+fetch`): torch ops and CUDA runtime
calls, summed by name.

    python -m miniasm_tpu_torch.eval.stages --paf CLEAN.paf \\
        --noisy NOISY.paf [--warm] [--rounds 2] [--json OUT] \\
        [--runs ecoli_s1_ug,sharded_ug] [--trace DIR --trace-runs noisy_ug]
        CHECKOUT [CHECKOUT ...]

The PAFs are those chip_smoke.py simulates (build/smoke/ecoli_4600000.paf
and its _noisy twin).  `--device cpu` runs the port on the CPU; without
it every run, the sharded ones too, asks for the card, and a process that
finds none raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUNS = ("ecoli_ug", "ecoli_paf", "noisy_ug")
# every run by name: the CLI's arguments ("PAF" the clean PAF, "NOISY" the
# noisy one), or "sharded" and the PAF for run_sharded
RUN_ARGS = {"warmup": ["-p", "ug", "PAF"], "ecoli_ug": ["-p", "ug", "PAF"],
            "ecoli_paf": ["-p", "paf", "PAF"],
            "noisy_ug": ["-p", "ug", "NOISY"],
            "ecoli_s1_ug": ["-1", "-p", "ug", "PAF"],
            "noisy_s2_ug": ["-2", "-p", "ug", "NOISY"],
            "ecoli_S4_bed": ["-S", "4", "-p", "bed", "PAF"],
            "sharded_ug": ["sharded", "PAF"],
            "sharded_noisy_ug": ["sharded", "NOISY"]}

# one process: the runs named in argv[5] (a warm-up among them when asked),
# their arguments in argv[6]; each run's stdout is discarded, its stage
# ticks and extras printed as a JSON line
_PROC = r"""
import contextlib, io, json, os, sys, tempfile, time
import torch
from miniasm_tpu_torch import cli, pipeline
from miniasm_tpu_torch.device import ENV, get_device
from miniasm_tpu_torch.utils import timers
# the device every run takes, as the CLI resolves it: the card unless
# MINIASM_TPU_TORCH_DEVICE (--device) asks for the CPU; no card raises
card = get_device(os.environ.get(ENV)).type == "cuda"
if hasattr(timers, "tracing"):
    timers.tracing(True)
paf, noisy, trace = sys.argv[1], sys.argv[2], sys.argv[3]
traced = set(sys.argv[4].split(",")) if trace else set()
paths = {"PAF": paf, "NOISY": noisy}
args = {k: [paths.get(x, x) for x in v]
        for k, v in json.loads(sys.argv[6]).items()}


def sharded(path, out):
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.parallel import full, group

    with tempfile.TemporaryDirectory() as rdv:
        group.init(0, 1, "file://" + os.path.join(rdv, "rdv"),
                   device="cuda" if card else "cpu")
        try:
            full.run_sharded(path, Opt(), out=out)
        finally:
            group.destroy()
    return 0, dict(full.LAST_TIMING), getattr(full, "LAST_TRACE", None)


for tag in sys.argv[5].split(","):
    if tag == "warmup" and card:
        from miniasm_tpu_torch import cuda
        cuda.build()
    buf, err = io.StringIO(), io.StringIO()
    if tag in traced:
        os.environ["MINIASM_TPU_PROFILE"] = os.path.join(trace, tag)
    t0 = time.time()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        if args[tag][0] == "sharded":
            rc, ticks, rec = sharded(args[tag][1], buf)
        else:
            rc = cli.main(args[tag])
            ticks = dict(pipeline.LAST_TIMING)
            rec = getattr(pipeline, "LAST_TRACE", None)
    if card:
        torch.cuda.synchronize()
    dt = time.time() - t0
    os.environ.pop("MINIASM_TPU_PROFILE", None)
    if rc != 0:
        sys.stderr.write(err.getvalue()[-2000:])
        sys.exit(rc)
    names = list(ticks)
    sel = [k for k in names if k.startswith("select")]
    select_s = None
    if sel:
        i = names.index(sel[0])
        select_s = ticks[sel[0]] - (ticks[names[i - 1]] if i else 0.0)
    print(json.dumps({"run": tag, "wall_s": dt, "bytes": len(buf.getvalue()),
                      "stages": ticks, "select_s": select_s,
                      "spans": rec.totals() if rec else {},
                      "counters": dict(rec.counters) if rec else {},
                      "traced": tag in traced}), flush=True)
"""


def _smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except OSError:
        return "no nvidia-smi"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def _select_calls(trace_json: str, top: int = 12) -> list:
    """The host calls inside the trace's select stage, summed by name (a
    torch op's time includes the ops it calls), the longest first:
    [(name, category, calls, total ms)]."""
    with open(trace_json) as f:
        ev = json.load(f)["traceEvents"]
    win = [e for e in ev if e.get("name") == "stage:select+fetch"
           and "dur" in e]
    if not win:
        return []
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    tot: dict = {}
    for e in ev:
        if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver") \
                and "dur" in e and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1:
            k = (e["name"], e["cat"])
            n, d = tot.get(k, (0, 0.0))
            tot[k] = (n + 1, d + e["dur"] / 1e3)
    rows = sorted(((k[0], k[1], n, d) for k, (n, d) in tot.items()),
                  key=lambda r: -r[3])
    return [("stage:select+fetch", "window", 1, win[0]["dur"] / 1e3)] \
        + rows[:top]


def _process(tree, runs, a, paf, noisy, trace) -> list:
    """Run `runs` in one fresh process of checkout `tree`: its JSON rows."""
    env = dict(os.environ)
    env.pop("MINIASM_TPU_TORCH_DEVICE", None)
    if a.device != "cuda":
        env["MINIASM_TPU_TORCH_DEVICE"] = a.device
    env["PYTHONPATH"] = tree
    r = subprocess.run([sys.executable, "-c", _PROC, paf, noisy, trace,
                        a.trace_runs, ",".join(runs), json.dumps(RUN_ARGS)],
                       cwd=tree, env=env, capture_output=True, text=True,
                       timeout=1200)
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-3000:])
        raise RuntimeError("stages: %s exited %d" % (tree, r.returncode))
    return [dict(json.loads(line), checkout=tree)
            for line in r.stdout.splitlines()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--paf", required=True)
    ap.add_argument("--noisy", required=True)
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", default=",".join(RUNS),
                    help="comma-separated names of RUN_ARGS")
    ap.add_argument("--json", default=None)
    ap.add_argument("--trace", default="")
    ap.add_argument("--trace-runs", default="noisy_ug")
    a = ap.parse_args(argv)
    runs = a.runs.split(",")
    bad = [r for r in runs if r not in RUN_ARGS or r == "warmup"]
    if bad:
        ap.error("unknown runs %s (choose among %s)"
                 % (bad, ", ".join(k for k in RUN_ARGS if k != "warmup")))
    card = _smi()
    print(card, flush=True)
    paf, noisy = os.path.abspath(a.paf), os.path.abspath(a.noisy)
    order = []
    for k in range(a.rounds):
        order += a.checkouts if k % 2 == 0 else a.checkouts[::-1]
    rows, built = [], set()
    for k, tree in enumerate(order):
        tree = os.path.abspath(tree)
        trace = (os.path.join(os.path.abspath(a.trace), "%d_%s" % (
            k, os.path.basename(tree) or "root")) if a.trace else "")
        if tree not in built:
            _process(tree, ["warmup"], a, paf, noisy, "")
            built.add(tree)
        if a.warm:
            got = _process(tree, ["warmup", *runs], a, paf, noisy, trace)[1:]
        else:
            got = [row for run in runs
                   for row in _process(tree, [run], a, paf, noisy, trace)]
        for row in got:
            row["round"] = k
            rows.append(row)
            x = row["spans"]
            detect = sum(v for k, v in x.items() if k.startswith("clean/")
                         and k.endswith("/detect"))
            print("%s %s: wall %.4f s, select %s s, select enqueue %s s, "
                  "fetch %s s, clean detect %.4f s, clean.detects %s"
                  % (tree, row["run"], row["wall_s"], row["select_s"],
                     x.get("select+fetch/enqueue"),
                     x.get("select+fetch/fetch"), detect,
                     row["counters"].get("clean.detects")), flush=True)
            if row["traced"]:
                row["select_calls"] = _select_calls(os.path.join(
                    trace, row["run"], "trace.json"))
                for name, cat, n, ms in row["select_calls"]:
                    print("    [trace] %s %s: %d calls, %.3f ms"
                          % (cat, name[:70], n, ms), flush=True)
    if a.json:
        os.makedirs(os.path.dirname(os.path.abspath(a.json)), exist_ok=True)
        with open(a.json, "w") as f:
            json.dump({"card": card, "warm": a.warm, "runs": rows}, f,
                      indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
