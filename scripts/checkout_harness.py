"""The harness shared by the scripts that time kernels on the card for one
or more checkouts of the repository side by side (scripts/select_tail.py,
scripts/marks_unpack.py, scripts/select_tail_phases.py).

`run` gives each checkout a process of its own, running a child program
that starts with PRELUDE.  The prelude reads the child's arguments (the
checkout, this checkout, the PAF, the repetitions, then the script's own
in `args`), puts the checkout's package first on sys.path, loads this
checkout's chip_smoke.py (not the checkout's), builds the kernels and
defines:

  say(**kw)                 one JSON line, tagged with the checkout;
  hook(mod, name, calls)    wraps mod.name so that each call's (args,
                            kwargs) is appended to calls[name]; returns
                            the wrapper it replaced;
  pieces(tag, fn, **extra)  fn's device time by event name from
                            torch.profiler over `reps` calls, each after
                            chip_smoke.py's 128 MB L2 flush (`flushed`)
                            and without it, the CUDA-event time both ways
                            and the host time (the enqueue, the card busy).

Each line is printed as JSON, the card's name and power limit first and
last, as nvidia-smi gives them.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r"""
import json, os, sys
tree, here, paf, reps = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
args = sys.argv[5:]
sys.path[:0] = [tree]
import importlib.util
import torch
# this checkout's chip_smoke.py, whatever the checkout holds
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(here, "chip_smoke.py"))
cs = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from miniasm_tpu_torch import cuda

cuda.build()


def say(**kw):
    print(json.dumps(dict(kw, checkout=tree)), flush=True)


def hook(mod, name, calls):
    orig = getattr(mod, name)

    def wrapped(*a, **k):
        calls.setdefault(name, []).append((a, dict(k)))
        return orig(*a, **k)
    setattr(mod, name, wrapped)
    return orig


def pieces(tag, fn, **extra):
    for flush in (True, False):
        split = cs._device_split(fn, reps, flush)
        say(piece=tag, flushed=flush, device_ms=sum(split.values()),
            split={cs._short(k): v for k, v in split.items()},
            ms=cs._time_ms(fn, reps, flush), **extra)
    say(piece=tag, host_us=cs._host_us(fn, reps), **extra)
"""


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def scratch_copy(tree: str, work: str) -> str:
    """A fresh copy of tree's package (without its build) under work."""
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "miniasm_tpu_torch"),
                    os.path.join(work, "miniasm_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__",
                                                  "*.so"))
    return work


def run(body: str, trees, paf: str, reps: int, json_out=None,
        args=()) -> int:
    """PRELUDE + body for each checkout in trees, in order; prints every
    line, writes the JSON lines to json_out (with the card) when given,
    and returns the first child's failing exit code, else 0."""
    card = smi()
    print(card, flush=True)
    rows = []
    for tree in map(os.path.abspath, trees):
        r = subprocess.run([sys.executable, "-c", PRELUDE + body, tree, HERE,
                            os.path.abspath(paf), str(reps), *args],
                           cwd=tree, capture_output=True, text=True,
                           timeout=1500)
        for line in r.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                rows.append(json.loads(line))
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-3000:])
            return r.returncode
    if json_out:
        os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                    exist_ok=True)
        with open(json_out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card, flush=True)
    return 0
