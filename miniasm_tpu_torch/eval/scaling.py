"""Multi-rank scaling harness: overlaps/s at 1..N ranks.

The port's counterpart of miniasm_tpu/eval/scaling.py, over run_sharded
and `group.launch`.  Each sharded configuration is one group, launched
once (in a thread of the caller) and kept for the whole measurement: its
ranks run one untimed warm run, then one run per round when the caller
asks, timed on rank 0 around run_sharded alone (spawn, group init and the
warm run are never timed).  The single-card run is timed in the calling
process after its own warm run.  Rounds interleave the configurations
(1, 1s, 2, .., N, 1, 1s, ...), as the JAX harness does, so host drift
hits every configuration of a round alike.  Every run's GFA must be the
single-card run's bytes.

NCCL refuses two ranks on one card, so a configuration with more ranks
than cards runs over gloo on the card(s) unless `backend` names another;
ranks that share one card measure the protocol (exchange, combines,
follow), not scaling.

Usage: python -m miniasm_tpu_torch.eval.scaling [n_ranks ...]
(default 1 2; MINIASM_TPU_TORCH_DEVICE=cpu for gloo on the CPU;
SCALING_PAF names the input, else a 1 Mb set at 30x is simulated).
Prints one JSON line.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import queue
import sys
import tempfile
import threading
import time

import numpy as np
import torch


def _serve_rank(paf_fn: str, opt, cmds, results) -> None:
    """One rank of a sharded configuration: one run_sharded per command
    taken from `cmds` ("warm" or "run"; None ends), every rank taking one
    (each run needs all of them, so no rank takes two); rank 0 puts each
    run's wall and GFA sha256 on `results`."""
    from ..parallel import group as grp
    from ..parallel.full import run_sharded

    g = grp.current()
    with contextlib.redirect_stderr(io.StringIO()):
        while True:
            cmd = cmds.get()
            if cmd is None:
                return
            buf = io.StringIO()
            # every rank starts together: rank 0 times no straggler
            g.all_reduce(torch.zeros(1, device=g.device))
            if g.device.type == "cuda":
                torch.cuda.synchronize(g.device)
            t0 = time.time()
            run_sharded(paf_fn, opt, outfmt="ug", out=buf)
            wall = time.time() - t0
            if g.rank == 0:
                results.put({"cmd": cmd, "wall": wall, "sha256":
                             hashlib.sha256(
                                 buf.getvalue().encode()).hexdigest()})


class _Config:
    """A launched n-rank group serving run_sharded (see `_serve_rank`)."""

    def __init__(self, n, paf_fn, opt, backend, dev):
        ctx = torch.multiprocessing.get_context("spawn")
        self.n, self.cmds, self.results = n, ctx.Queue(), ctx.Queue()
        self.error = None

        def body():
            from ..parallel import group as grp

            try:
                grp.launch(n, _serve_rank, paf_fn, opt, self.cmds,
                           self.results, backend=backend, device=dev.type)
            except Exception as e:  # raised again by the caller's get
                self.error = e

        self.thread = threading.Thread(target=body, daemon=True)
        self.thread.start()

    def ask(self, cmd) -> None:
        for _ in range(self.n):
            self.cmds.put(cmd)

    def get(self) -> dict:
        while True:
            try:
                return self.results.get(timeout=1)
            except queue.Empty:
                if not self.thread.is_alive():
                    raise RuntimeError("scaling: the %d-rank group ended "
                                       "early" % self.n) from self.error

    def close(self) -> None:
        if self.thread.is_alive():
            self.ask(None)
            self.thread.join()


def _backend(n: int, backend, dev: torch.device):
    """The backend of an n-rank group: the caller's, else the group's own
    choice (NCCL on cards, gloo on the CPU), gloo where NCCL would need
    more cards than there are."""
    if backend or dev.type != "cuda" or n <= torch.cuda.device_count():
        return backend
    return "gloo"


def measure(paf_fn: str, n_list, *, repeats: int = 3, backend=None,
            device=None) -> dict:
    from ..config import Opt
    from ..device import get_device
    from ..io.paf import load_paf
    from ..pipeline import run as run_single

    opt = Opt()
    dev = get_device(device)
    shas = set()
    # the JAX harness's rounds: every configuration warmed, then the timed
    # rounds INTERLEAVED (1, 1s, 2, .., N, 1, 1s, 2, .., N, ...), so host
    # drift hits all configs of a round equally and the per-round PAIRED
    # ratio wall_1/wall_n is far tighter than comparing block medians.
    # "1s" is the SHARDED program on one rank: sharded@N vs sharded@1
    # isolates the exchange overhead from the structure cost of the
    # sharded program vs the single-card path.
    configs = [(n, False) for n in n_list]
    if 1 in n_list:
        configs.insert(1, (1, True))
    groups = {}

    def one(n, sharded1=False):
        if n == 1 and not sharded1:
            buf = io.StringIO()
            with contextlib.redirect_stderr(io.StringIO()):
                t0 = time.time()
                run_single(paf_fn, opt, outfmt="ug", out=buf, device=dev)
                wall = time.time() - t0
            shas.add(hashlib.sha256(buf.getvalue().encode()).hexdigest())
            return wall
        groups[n].ask("run")
        res = groups[n].get()
        shas.add(res["sha256"])
        return res["wall"]

    try:
        for n, s1 in configs:
            if n > 1 or s1:
                groups[n] = _Config(n, paf_fn, opt,
                                    _backend(n, backend, dev), dev)
                groups[n].ask("warm")
        if 1 in n_list:
            one(1)
        for g in groups.values():
            shas.add(g.get()["sha256"])
        walls: dict = {cfg: [] for cfg in configs}
        for _ in range(repeats):
            for cfg in configs:
                walls[cfg].append(one(*cfg))
    finally:
        for g in groups.values():
            g.close()
    if len(shas) != 1:
        raise AssertionError("sharded GFA differs from single-device GFA")
    walls1s = walls.pop((1, True), None)
    walls = {n: ws for (n, s1), ws in walls.items()}

    # overlaps processed = mirrored hit count (the reference's unit)
    load = load_paf(paf_fn, opt.min_span, opt.min_match)
    n_mirror = len(load.qid) + int(np.sum(load.qid != load.tid))
    rates = {n: n_mirror / min(ws) for n, ws in walls.items()}
    base = rates.get(1)
    # raw efficiency r/(base*n) is bounded by 1/n where the ranks share one
    # card or the CPU's cores; the total-work ratio single/sharded is what
    # n cards of their own would project to
    eff = {n: (r / (base * n) if base else 0.0) for n, r in rates.items()}
    proj = {n: (r / base if base else 0.0) for n, r in rates.items()}
    paired = {}
    if 1 in walls:
        for n, ws in walls.items():
            rs = [w1 / wn for w1, wn in zip(walls[1], ws)]
            paired[str(n)] = {
                "per_round": [round(x, 3) for x in rs],
                "median": round(sorted(rs)[len(rs) // 2], 3),
                "min": round(min(rs), 3), "max": round(max(rs), 3)}
    self_eff = {}
    structure_cost = None
    if walls1s is not None:
        # sharded-program self efficiency: wall(sharded@1)/wall(sharded@n)
        # -- prices ONLY the exchange and combines added by n>1
        for n, ws in walls.items():
            if n == 1:
                continue
            rs = [w1 / wn for w1, wn in zip(walls1s, ws)]
            self_eff[str(n)] = {
                "per_round": [round(x, 3) for x in rs],
                "median": round(sorted(rs)[len(rs) // 2], 3),
                "min": round(min(rs), 3), "max": round(max(rs), 3)}
        if 1 in walls:
            structure_cost = round(
                sorted(w1s / w1 for w1s, w1 in zip(walls1s, walls[1]))
                [len(walls1s) // 2], 3)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backends = {str(n): _backend(n, backend, dev) or (
        "nccl" if dev.type == "cuda" else "gloo") for n in n_list}
    return {"overlaps": n_mirror,
            "sharded_self_efficiency": self_eff,
            "sharded_structure_cost_vs_fused_single": structure_cost,
            "overlaps_per_s": {str(n): round(r) for n, r in rates.items()},
            "efficiency_timesliced": {str(n): round(e, 3)
                                      for n, e in eff.items()},
            "projected_efficiency": {str(n): round(e, 3)
                                     for n, e in proj.items()},
            "paired_projected_efficiency": paired,
            "note": "%s, %d card(s); sharded backends by rank count %s. "
                    "Each sharded wall is rank 0's run_sharded alone, in a "
                    "group launched once and warmed by one run (spawn and "
                    "group init untimed); the single wall is pipeline.run "
                    "in the calling process.  Ranks that share one card (or the "
                    "CPU's cores) measure the protocol -- the exchange, "
                    "the owner-masked combines, the sharded clean's "
                    "follow -- not scaling: sharded_self_efficiency "
                    "(sharded@1 / sharded@N) prices that protocol, and "
                    "projected_efficiency divides by the single-card "
                    "path (structure_cost field).  paired_* uses "
                    "interleaved rounds so host drift cancels; scaling "
                    "itself needs one card per rank."
                    % (dev.type, cards, json.dumps(backends))}


def main(argv=None) -> int:
    from ..device import ENV

    argv = list(sys.argv if argv is None else argv)
    ns = [int(a) for a in argv[1:]] or [1, 2]
    paf = os.environ.get("SCALING_PAF")
    tmp = None
    try:
        if not paf:
            from .simulate import simulate, write_paf

            sim = simulate(genome_len=1_000_000, coverage=30.0, seed=11)
            fd, tmp = tempfile.mkstemp(suffix=".paf")
            os.close(fd)
            paf = tmp
            write_paf(sim, paf)
        print(json.dumps(measure(paf, ns,
                                 device=os.environ.get(ENV) or None)))
    finally:
        if tmp:
            os.unlink(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
