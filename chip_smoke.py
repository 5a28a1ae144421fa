#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (miniasm_tpu_torch) on one GPU.

What it does, in order:
  1. prints the card (nvidia-smi name and power limit) and the versions,
     builds the host loader and the hand-written CUDA kernels of csrc/
     (one nvcc per source, all started together);
  2. simulates an E. coli-scale read set with the port's simulator
     (4.6 Mb genome, 40x, seed 11, reads of 8000 +- 2000 bp: 911,422 PAF
     lines, and the reads FASTA for -f) and its noisy variant (half of
     the PAF lines dropped, random.Random(36)), so that tips, bubbles,
     internal cuts and bi-loops all fire;
  3. drives the port's main path on the card through its CLI (PAF -> GFA,
     -p ug) on both inputs, then -p sg (noisy) and -p bed (clean) once,
     then the staged selection path (-1, -2, -S 4) at the same size in
     five runs that reach -p ug, sg, bed and paf, then the oracle clean
     modes (MINIASM_TPU_CLEAN=native -p ug, =py -p sg, each byte-equal to
     its hybrid run) and -f and -R on both paths, then the main path's
     -p paf on both inputs, -p ug twice with MINIASM_TPU_SNAPSHOT (the
     second run restores and prints the first's bytes), and the loader's
     format switches: the clean PAF shuffled (random.Random(36); every
     piece rides the 4-row layout) and with one 90 kb overlap appended
     (the stream ends in the 7-row layout); then the sharded path,
     run_sharded on a one-rank NCCL group on both inputs (each must print
     the bytes of its -p ug run), and the multi-process worker, two
     processes on the one card over gloo on the noisy input (rank 0's GFA
     must be noisy_ug's bytes);
     every kernel launch counter is set to 0 just before each run and read
     just after it, and the run fails unless each kernel launched as that
     run requires (EXPECT, and MH_EXPECT for each worker process): K1-K4,
     K9, K10 and K13 (with K12's marks: K12 alone never) on the noisy
     main-path runs, K2, K5, K16, K17
     and K18 on the staged runs (K6 never: only the graft entry's forward
     step, phase 6, launches it), K3, K7 and K8 on the oracle runs, K11 (its layout
     pass once per Layout, its scatter once per payload), K1-K4, K12 and
     K19 on the sharded runs, and K14 (stage B) once per detection of
     every run's hybrid clean (the run's clean.detects counter);
  4. holds each kernel against its plain PyTorch version on the card, on
     the inputs the runs gave it (the largest call of each variant on
     each path), bit for bit, and times both with CUDA events, the
     wrapper also by torch.profiler's device time, each timed call alone
     after a write of 128 MB that evicts the 50 MB L2 (the main path's
     caller finds a kernel's inputs cold), K14 also without the flush
     (as the path finds its inputs, right after K3) and beside an empty
     cooperative launch of its grid (its latency floor, with one grid
     sync and without), K13 each call by launch, also without the flush,
     with its host time, and beside an empty cooperative launch of its
     grid with 0, 1 and as many grid syncs as it makes (its floor); beside
     K12 it times one scatter_reduce_ amax, the same function in one
     PyTorch call, beside K13 and K14
     the PyTorch calls that do their costly part (a stable int64
     torch.sort; a torch.sort and searchsorted), beside K16 a boolean-mask
     index of the same columns (each of its five kinds of call on a line
     of its own), beside K19 a torch.nonzero and its seven gathers, each
     compaction also by launch, with its wrapper's wall time and beside
     an empty cooperative launch of its grid (its floor, with one grid
     sync and without), and runs K13's largest call again with every read
     sorted in device memory; every device time comes from a profiling
     session that holds each launch of every timed call, or the smoke
     fails; K9 also on seeded
     pieces with edge-case run tables; K7 and K8 also on seeded keys
     with duplicates, with (-1, -1) (all ones, as the hash table's empty
     slots) and pads, and on 4,194,304 keys (a table past L2); K11 also on an 8-way routing of
     the clean rows, a skewed 1,024-way routing and each worker process's
     own repartition call (its inputs, saved by the process), and its
     layout pass against layout_plain on every call's Layout; the shapes of
     every K3 and K4 call of noisy_ug, read from the recorded calls (the
     runs themselves carry no hook that syncs, reduces or copies);
  5. runs the same commands, and the sharded runs on a one-rank gloo
     group, with MINIASM_TPU_TORCH_DEVICE=cpu (the plain versions only)
     and requires byte-identical stdout;
  6. the graft entry's forward step (eval/dryrun.py `entry`: K2, K5, K6
     over 4,096 padded columns, one launch each, no other kernel; run
     after the sharded runs of 3, so that its calls join the kernel phase
     of 4 as cases), bit-equal to its CPU run;
  7. the panel (eval/panel.py `run_one`, all 11 members, 10Mb-drop40
     included) on the card and on the CPU: equal result dicts and GFA
     bytes, tests/test_panel.py's assertions on its three members, and the
     10 Mb member's launches held to the noisy main path's;
  8. the dry run (`dryrun_multichip`) on a one-rank NCCL group and on two
     gloo ranks on the card, each GFA the CPU single run's bytes; the
     scaling harness (eval/scaling.py `measure`) on the clean PAF at 1 and
     2 ranks, on the card and, for its keys and overlap count, on the CPU;
     minidot, paftop, paf2mhap and ref2ovlp on the clean PAF or the
     simulator's truth;
  9. the run switches: the v2 loader (MINIASM_TPU_LOADER=v2) on -p ug, sg,
     bed and paf, each byte-equal to its default-loader twin of 3 and to
     the CPU, launching no K9 or K10 (-p paf takes the staged path of
     both passes); MINIASM_TPU_TIMING on ecoli_ug (its [T::] lines are
     LAST_TIMING's stages); MINIASM_TPU_PROFILE on noisy_ug and a warm
     ecoli_ug (each the second run of a process of its own), whose
     traces must hold the kernels by name, and from which it prints the
     device's busy and idle share of each run and its three longest idle
     gaps with the span (else the stage) that holds each; and 8 seeded
     cases of the port's fuzz (eval/fuzz.py), the card against the CPU.

It prints one JSON line per kernel and one {"kernels": [...]} line, and as
its last line {"ok": true, "device": {"platform": "gpu", ...}}.  Any
failed phase exits non-zero without that line, as does a run without a
CUDA device or outside a checkout of the repository.

    python3 chip_smoke.py [--genome BP] [--json PATH]

--genome below E. coli's 4.6 Mb gives a quick check, not the measured
size.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import inspect
import io
import json
import os
import random
import re
import shutil
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
INT32_OPS_S = 33.5e12   # 64 INT32 lanes per SM: half the 67 TFLOP/s float32
ECOLI_BP = 4_600_000
COVERAGE, SEED, MEAN_READ, SD_READ = 40.0, 11, 8000, 2000
# launches each run must show, counted in that run alone: a number is
# exact, ">0" at least one, "any" not checked.  The clean set's perfect
# overlaps leave no vertex with two live out-arcs, so it has no bubble
# source and K4 is held on the noisy set, where every main-path kernel
# must launch.  The main path never launches the staged kernels K5, K6,
# K16-K18 or the sharded step's K19, and only the oracle clean modes
# launch K7 and K8.
# The loader launches K9 once per FMT3 piece and K10 once per load on the
# card (its 4-row pieces unpacked, its 7-row pieces copied); the
# staged path's loader is another (pafread.cpp) and launches neither.  The main path's select
# launches K13 once, the marks of K12 inside it, and K12 alone never (the
# sharded step launches it once a rank); every detection of the hybrid
# clean launches K14 once (each run is also held to its clean.detects,
# _check_detects).
_MAIN = {"hit_cut": 0, "hit2arc": 0, "key_member": 0, "dup_mark": 0,
         "decode3": ">0", "unpack4": 1, "route": 0,
         "route_layout": 0, "read_marks": 0, "arc_order": 1,
         "clean_stage_b": "any", "compact": 0,
         "hit_flt": 0, "hit_marks": 0, "shard_arcs": 0}
_CLEAN = dict(_MAIN, cut_hit2arc=2, sweep=2, trans_multi=">0",
              bubble_bfs="any")
_NOISY = dict(_MAIN, cut_hit2arc=2, sweep=2, trans_multi=">0",
              bubble_bfs=">0")
_PAF = dict(_MAIN, cut_hit2arc=2, sweep=2, trans_multi=0, bubble_bfs=0)


def _staged(cut_passes, flt, contained, graph):
    # pipeline._select_staged and graph_from_hits: per cut pass K2
    # (hit_sub), K5 and K16 (apply_cut); the filter K17 and K16 (the take);
    # the containment K18 once (its contained and used marks) and K16
    # twice (the trim table, the remapped hits); the graph build K18 (the
    # sg marks and arc rows) and K16 (the arcs), then clean with K3 (and
    # K4 where it finds a bubble source).  K6 no longer launches here.
    return {"cut_hit2arc": 0, "sweep": cut_passes, "hit_cut": cut_passes,
            "hit2arc": 0,
            "compact": cut_passes + flt + 2 * contained + graph,
            "hit_flt": flt, "hit_marks": contained + graph,
            "trans_multi": ">0" if graph else 0,
            "bubble_bfs": "any" if graph else 0, "key_member": 0,
            "dup_mark": 0, "decode3": 0, "unpack4": 0, "route": 0,
            "route_layout": 0, "read_marks": 0, "arc_order": 0,
            "shard_arcs": 0,
            "clean_stage_b": ">0" if graph else 0}


def _oracle(symm_calls):
    # the main path's select, then del_trans (one K3 launch) and one K8
    # and one K7 launch per symm: after del_trans, and in py mode after
    # each del_short that drops arcs; the oracles never run K4
    return dict(_MAIN, cut_hit2arc=2, sweep=2, trans_multi=1, bubble_bfs=0,
                key_member=symm_calls, dup_mark=symm_calls, clean_stage_b=0)


EXPECT = {"ecoli_ug_cold": _CLEAN, "ecoli_ug": _CLEAN, "ecoli_ug_2": _CLEAN,
          "ecoli_ug_3": _CLEAN, "noisy_ug": _NOISY, "noisy_sg": _NOISY,
          "ecoli_bed": dict(_MAIN, cut_hit2arc=2, sweep=2, trans_multi=0,
                            bubble_bfs=0),
          # -1: the fine pass and the containment; -2: the crude pass and
          # the filter; -1 -2: no selection; -S 4: both passes, no
          # containment, no graph
          "ecoli_s1_ug": _staged(1, 0, 1, 1),
          "noisy_s2_ug": _staged(1, 1, 0, 1),
          "noisy_s12_sg": _staged(0, 0, 0, 1),
          "ecoli_S4_bed": _staged(2, 1, 0, 0),
          "noisy_s1_paf": _staged(1, 0, 1, 0),
          "noisy_native_ug": _oracle(1),
          "noisy_py_sg": _oracle(">0"),
          "ecoli_f_ug": dict(_CLEAN, trans_multi=1),
          "noisy_R_ug": dict(_NOISY),
          "noisy_s1_R_f_ug": _staged(1, 0, 1, 1),
          "ecoli_paf": _PAF, "noisy_paf": _PAF,
          "ecoli_snap_ug": _CLEAN,
          # the restore skips Steps 1-3: no loader or select kernel
          "ecoli_snap_ug_restore": dict(_CLEAN, cut_hit2arc=0, sweep=0,
                                        decode3=0, unpack4=0, read_marks=0,
                                        arc_order=0),
          # the sideband overflows in the first piece: no FMT3 piece,
          # 4-row pieces
          "shuffled_ug": dict(_CLEAN, decode3=0),
          # below E. coli size the switch can come in the first piece,
          # leaving no FMT3 piece
          "long_ug": dict(_CLEAN, decode3="any"),
          # the sharded runs: rank 0 loads on the host (7-row pieces,
          # nothing to decode, and K10's plain version on the host: no
          # K9/K10 launch); K11's layout pass once for the
          # select step's one Layout and its scatter once per sweep pass,
          # then K1, K2, K12 alone (its marks are OR-ed across the ranks)
          # and, for the arc tail, K19 (once; full.py select_step) where
          # the main path runs K13; then the clean kernels
          "sharded_ug": dict(_CLEAN, route=2, route_layout=1, decode3=0,
                             unpack4=0, read_marks=1, arc_order=0,
                             shard_arcs=1),
          "sharded_ug_2": dict(_CLEAN, route=2, route_layout=1, decode3=0,
                               unpack4=0, read_marks=1, arc_order=0,
                               shard_arcs=1),
          "sharded_ug_3": dict(_CLEAN, route=2, route_layout=1, decode3=0,
                               unpack4=0, read_marks=1, arc_order=0,
                               shard_arcs=1),
          "sharded_noisy_ug": dict(_NOISY, route=2, route_layout=1,
                                   decode3=0, unpack4=0, read_marks=1,
                                   arc_order=0, shard_arcs=1),
          # the v2 loader: one copy of the colmat, no K9 or K10; -p paf
          # runs the staged path of both passes and the containment
          # (_run_staged), without a graph
          "ecoli_v2_ug": dict(_CLEAN, decode3=0, unpack4=0),
          "noisy_v2_ug": dict(_NOISY, decode3=0, unpack4=0),
          "noisy_v2_sg": dict(_NOISY, decode3=0, unpack4=0),
          "ecoli_v2_bed": dict(_MAIN, cut_hit2arc=2, sweep=2,
                               trans_multi=0, bubble_bfs=0, decode3=0,
                               unpack4=0),
          "noisy_v2_paf": _staged(2, 1, 1, 0)}
EXPECT = {tag: dict(want) for tag, want in EXPECT.items()}  # one per run
# the exact counts of the E. coli sets where the count depends on the
# data: the hybrid cleaner's K3 detects, the py oracle's symm calls, the
# loader's FMT3 pieces of 131,072 records (the clean set's 691,396
# filtered records in 6 pieces, the noisy set's about 345,700 in 3; the
# long set's last piece switches to 7 rows, leaving 5 FMT3 pieces); a
# smaller --genome holds them to ">0" only
AT_ECOLI = {("noisy_py_sg", "key_member"): 5,
            ("noisy_py_sg", "dup_mark"): 5,
            ("long_ug", "decode3"): 5}
# every run that cleans the noisy set's graph with the hybrid cleaner: 19
# K3 detections and 11 K4 launches (6 dispatches, 5 of which overflow K =
# 64 and run again at 128)
for _tag in ("noisy_ug", "noisy_sg", "noisy_s2_ug", "noisy_s12_sg",
             "noisy_R_ug", "noisy_s1_R_f_ug", "sharded_noisy_ug",
             "noisy_v2_ug", "noisy_v2_sg"):
    for _k in ("trans_multi", "clean_stage_b"):
        AT_ECOLI[(_tag, _k)] = 19
    AT_ECOLI[(_tag, "bubble_bfs")] = 11
for _tag, _want in EXPECT.items():
    if _want["decode3"] == ">0" and _tag != "noisy_R_ug":
        AT_ECOLI[(_tag, "decode3")] = 3 if _tag.startswith("noisy") else 6
# the run whose counts the kernels line reports for each kernel: the main
# path's run in which K1-K4 all launch (and K14 once per detection),
# the staged -1 run for K5, K16, K18, the staged -S 4 run for K17, the
# graft entry's forward step for K6, the py oracle run for K7, K8, the
# clean set's warm run for K9, K10, K13, and its sharded run for K11, K12
# and K19
RUN_OF_RECORD = {"cut_hit2arc": "noisy_ug", "sweep": "noisy_ug",
                 "trans_multi": "noisy_ug", "bubble_bfs": "noisy_ug",
                 "hit_cut": "ecoli_s1_ug", "hit2arc": "dryrun_entry",
                 "compact": "ecoli_s1_ug", "hit_flt": "ecoli_S4_bed",
                 "hit_marks": "ecoli_s1_ug", "shard_arcs": "sharded_ug",
                 "key_member": "noisy_py_sg", "dup_mark": "noisy_py_sg",
                 "decode3": "ecoli_ug", "unpack4": "ecoli_ug",
                 "route": "sharded_ug", "read_marks": "sharded_ug",
                 "arc_order": "ecoli_ug", "clean_stage_b": "noisy_ug"}
# the path whose calls each kernel's row times (K6: the graft entry's
# forward step, the one caller left); a kernel reused on another path gets
# a sub-row of its own there, with the launches of a run that makes those
# calls: K2 in the staged hit_sub (crude and fine, both of which -S 4
# runs), K3 in the oracles' del_trans
ROW_PATH = {"cut_hit2arc": "main", "sweep": "main", "trans_multi": "main",
            "bubble_bfs": "main", "hit_cut": "staged", "hit2arc": "dryrun",
            "compact": "staged", "hit_flt": "staged", "hit_marks": "staged",
            "shard_arcs": "sharded",
            "key_member": "oracle", "dup_mark": "oracle", "decode3": "main",
            "unpack4": "main", "route": "sharded",
            "read_marks": "sharded",
            "arc_order": "main", "clean_stage_b": "main"}
# a kernel whose row times one call, not the sum of its path's variants:
# K11's largest call of the run of record (its other calls are listed as
# cases beside it)
ROW_CALL = {"route": ("sharded", "sharded_ug")}
# each worker process of the multi-process run (rank -> launches): K11's
# scatter for the repartition and both sweep passes, its layout pass for
# the repartition's and the select step's Layout, K1 and K2 twice, K12
# once, K19 once; rank 0 alone cleans (without the group, as the JAX worker
# does)
_MH = {"hit_cut": 0, "hit2arc": 0, "key_member": 0, "dup_mark": 0,
       "decode3": 0, "unpack4": 0, "route": 3, "route_layout": 2,
       "cut_hit2arc": 2, "sweep": 2, "read_marks": 1, "arc_order": 0,
       "compact": 0, "hit_flt": 0, "hit_marks": 0, "shard_arcs": 1}
MH_EXPECT = {0: dict(_MH, trans_multi=">0", bubble_bfs=">0",
                     clean_stage_b=">0"),
             1: dict(_MH, trans_multi=0, bubble_bfs=0, clean_stage_b=0)}
MH_PROCS = len(MH_EXPECT)
REUSE = {"sweep": ("hit_sub", "staged", "ecoli_S4_bed"),
         "trans_multi": ("del_trans", "oracle", "noisy_native_ug")}
# the path and tag of the run being driven; the recorders key each call
# by them
PATH = {"now": "main", "tag": ""}


def _say(msg: str) -> None:
    print(msg, flush=True)


def _fail(msg: str) -> None:
    sys.stderr.write("chip_smoke: FAILED: %s\n" % msg)
    sys.exit(1)


def _smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        _fail("nvidia-smi failed: %s" % r.stderr.strip())
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# recording the kernels' inputs on the main path

class Recorder:
    """Wraps a module-level kernel wrapper so the runs' calls keep the
    largest input each variant saw (key_fn names the variant; size_fn
    measures an input, by default its tensors' elements), and the largest
    value of stat_fn (a number from the arguments) since the last reset,
    and with `log_tag` every call of the run so tagged in `log`.  It
    keeps the arguments themselves, no copies (the
    port writes no kernel input in place), so the hook adds no device work
    and no sync to the timed runs.  `kernel` names the kernel when the
    wrapper's name is not its name.  A call for which `when` is false
    (by default none) is not recorded.  The wrapped call itself is
    unchanged."""

    def __init__(self, mod, name: str, key_fn, stat_fn=None, kernel=None,
                 size_fn=None, log_tag=None, when=None):
        self.mod, self.name, self.key_fn = mod, name, key_fn
        self.when = when
        self.kernel = kernel or name
        self.stat_fn, self.stat = stat_fn, 0
        self.size_fn = size_fn or (lambda a, k: sum(
            x.numel() for x in a if isinstance(x, torch.Tensor)))
        self.log_tag = log_tag
        self.orig = getattr(mod, name)
        self.calls: dict = {}
        self.log: list = []

    def __enter__(self):
        def wrapped(*a, **k):
            if self.when is not None and not self.when(a, k):
                return self.orig(*a, **k)
            size = self.size_fn(a, k)
            if self.stat_fn is not None:
                self.stat = max(self.stat, self.stat_fn(a, k))
            key = self.key_fn(a, k)
            if key not in self.calls or self.calls[key][0] < size:
                self.calls[key] = (size, a, dict(k))
            if PATH["tag"] == self.log_tag:
                self.log.append((a, dict(k)))
            return self.orig(*a, **k)

        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def _cli(args, device: str, clean: str = "hybrid", snapshot=None, env=None
         ) -> tuple[str, str, float, dict, dict]:
    """One CLI run with stdout and stderr captured, MINIASM_TPU_CLEAN=
    `clean`, MINIASM_TPU_SNAPSHOT=`snapshot` (when given) and the
    variables of `env`, its launch counts set to 0 just before it and read
    just after it, and its spans and counters recorded; returns (stdout,
    stderr, seconds, stage timing with the record's counters and span
    sums under `trace.`, launches)."""
    from miniasm_tpu_torch import cli, cuda, pipeline
    from miniasm_tpu_torch.device import ENV
    from miniasm_tpu_torch.utils import timers

    os.environ[ENV] = device
    os.environ["MINIASM_TPU_CLEAN"] = clean
    if snapshot:
        os.environ["MINIASM_TPU_SNAPSHOT"] = snapshot
    os.environ.update(env or {})
    buf, err = io.StringIO(), io.StringIO()
    cuda.reset_launches()
    was = timers.tracing(True)
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli.main(list(args))
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        timers.tracing(was)
        os.environ.pop("MINIASM_TPU_CLEAN")
        os.environ.pop("MINIASM_TPU_SNAPSHOT", None)
        for k in env or {}:
            os.environ.pop(k)
    dt = time.time() - t0
    launches = cuda.launch_counts()
    if rc != 0:
        sys.stderr.write(err.getvalue()[-3000:])
        _fail("cli %s on %s exited %d" % (" ".join(args), device, rc))
    stages = dict(pipeline.LAST_TIMING)
    stages.update(_traced(pipeline.LAST_TRACE))
    return buf.getvalue(), err.getvalue(), dt, stages, launches


def _traced(rec) -> dict:
    """A run's counters and its span seconds summed by path, as
    `trace.<name>` keys beside its stages."""
    out = {"trace." + k: v for k, v in rec.counters.items()}
    out.update({"trace." + k: v for k, v in rec.totals().items()})
    return out


def _check_launches(tag: str, launches: dict, expect=None) -> None:
    for name, want in (expect or EXPECT[tag]).items():
        got = launches[name]
        if want == "any":
            continue
        if (got <= 0) if want == ">0" else (got != want):
            _fail("%s: kernel %s launched %d times, this run needs %s"
                  % (tag, name, got, want))


def _check_detects(tag: str, launches: dict, stages: dict) -> None:
    """K14 (stage B) launches once per detection of the run (clean.detects,
    counted by devclean.detect)."""
    n = int(stages.get("trace.clean.detects", 0))
    if launches["clean_stage_b"] != n:
        _fail("%s: clean_stage_b launched %d times, the run detected %d "
              "times" % (tag, launches["clean_stage_b"], n))


def _gfa_summary(gfa: str) -> dict:
    lens = [int(x.split("\t")[3][5:]) for x in gfa.splitlines()
            if x.startswith("S\t")]
    return {"unitigs": len(lens), "total_bp": sum(lens),
            "longest_bp": max(lens) if lens else 0,
            "bytes": len(gfa.encode())}


def _check_sequences(tag: str, gfa: str) -> None:
    """-f: every S line carries a sequence of its LN:i: length, not '*'."""
    s = [x.split("\t") for x in gfa.splitlines() if x.startswith("S\t")]
    bad = [x[1] for x in s if x[2] == "*" or len(x[2]) != int(x[3][5:])]
    if not s or bad:
        _fail("%s: %d S lines, %d without their sequence (%s)"
              % (tag, len(s), len(bad), ", ".join(bad[:5])))


# ---------------------------------------------------------------------------
# per-kernel comparison, timing and bound

# the L2 flush between timed calls: the main path's caller finds a
# kernel's inputs cold (written by other kernels, megabytes earlier), and a
# call repeated on the same inputs would read them from the 50 MB L2.  One
# negation of a 128 MB int32 buffer evicts it; its device events are known
# by name (FLUSH["names"], read from a profile of the flush alone) and left
# out of _device_ms, and _time_ms times each call alone, after its flush.
FLUSH: dict = {"buf": None, "names": None}


def _flush() -> None:
    if FLUSH["buf"] is None:
        FLUSH["buf"] = torch.zeros(32 << 20, dtype=torch.int32,
                                   device="cuda")
    FLUSH["buf"].neg_()


def _flush_names() -> set:
    if FLUSH["names"] is None:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        _flush()
        torch.cuda.synchronize()
        # the first profiling session of a process can come back without
        # device events (seen once in a smoke run, at this call): three
        # sessions at most
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _flush()
                torch.cuda.synchronize()
            FLUSH["names"] = {e.name for e in prof.events()
                              if e.device_type == DeviceType.CUDA}
            if FLUSH["names"]:
                break
        if not FLUSH["names"]:
            _fail("the profiler recorded no event of the L2 flush in "
                  "three sessions")
    return FLUSH["names"]


def _time_ms(fn, reps: int, flush: bool = True) -> float:
    """Mean CUDA-event time of fn, each call alone after an L2 flush (with
    flush=False, after the call before it)."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        if flush:
            _flush()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def _device_profile(fn, calls: int, flush: set) -> dict:
    """{device event name: [durations in us]} of one profiling session
    over `calls` calls of fn, each after an L2 flush when `flush` holds
    the flush's event names (whose events are left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush:
                _flush()
            fn()
        torch.cuda.synchronize()
    us: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in flush:
            us.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return us


def _device_split(fn, reps: int, flush: bool = True) -> dict:
    """Device time per call of what fn launches, by event name (ms): each
    name's mean duration times its events per call, from torch.profiler
    over reps calls, each after an L2 flush (with flush=False, none).  A
    session of one call first counts each name's events per call; the
    session of reps calls must show every name of it reps times as often,
    and no other.  A session that records no event, or misses or adds
    some, is made again, three times at most; then the smoke fails, naming
    the counts of the last pair: it never reports a partial sum."""
    names = _flush_names() if flush else set()
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        one = _device_profile(fn, 1, names)
        many = _device_profile(fn, reps, names)
        per = {k: len(v) for k, v in one.items()}
        got = {k: len(v) for k, v in many.items()}
        if per and got == {k: c * reps for k, c in per.items()}:
            return {k: sum(d) / len(d) * per[k] / 1e3
                    for k, d in many.items()}
    _fail("the profiler recorded an incomplete session of %r three times "
          "(last: one call %s, %d calls %s)"
          % (getattr(fn, "__name__", fn), per, reps, got))


def _device_ms(fn, reps: int, flush: bool = True) -> float:
    """The sum of _device_split: the device ms of one call of fn."""
    return sum(_device_split(fn, reps, flush).values())


def _device_sequence(fn, reps: int, flush: bool = True) -> list:
    """The device events of one call of fn in the order they start, each
    (name, mean ms), from torch.profiler over reps calls, each after an L2
    flush (with flush=False, none).  Every call of the session must show
    the names of a one-call session in the same order; a session that
    does not is made again, three times at most, then the smoke fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = _flush_names() if flush else set()

    def session(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush:
                    _flush()
                fn()
            torch.cuda.synchronize()
        return [(e.name, e.time_range.elapsed_us()) for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA
             and e.name not in names), key=lambda e: e.time_range.start)]

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        one = [name for name, _us in session(1)]
        many = session(reps)
        k = len(one)
        if k and len(many) == k * reps and all(
                name == one[i % k] for i, (name, _us) in enumerate(many)):
            return [(one[j], sum(us for _n, us in many[j::k]) / reps / 1e3)
                    for j in range(k)]
    _fail("the profiler recorded an uneven session of %r three times"
          % getattr(fn, "__name__", fn))


def _short(name: str) -> str:
    """A device event's name without its namespaces and arguments."""
    m = re.search(r"(\w+(?:<[^>]*>)?)\(", name)
    return m.group(1) if m else name


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _max_abs_err(got, want) -> float:
    err = 0.0
    for x, y in zip(_as_tuple(got), _as_tuple(want)):
        if x.shape != y.shape or x.dtype != y.dtype:
            return float("inf")
        if x.numel():
            d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
            err = max(err, float(d))
    return err


def _cost(name, args, kw, out):
    """(bytes, ops) the function needs on these inputs: every input read
    once, every output written once; ops counted from this run's data."""
    from miniasm_tpu_torch.select import fused2

    if name == "cut_hit2arc":
        colmat, coords, lanes, tab = args
        n = colmat.shape[1]
        b = 3 * 4 * n + _nbytes(coords, lanes, tab) + _nbytes(out)
        return b, 110 * n   # ~30 ops of cut, ~35 per hit2arc lane, filter
    if name == "sweep":
        seg, key, T = args[0], args[1], args[2]
        # per event: its count, scatter and sweep step (about 12 integer
        # ops); per read of n valid events a comparison sort's n log2 n
        n = _read_events(seg, key, T).to(torch.float64)
        sort = float((n * torch.log2(n.clamp(min=1))).sum())
        return _nbytes(seg, key) + _nbytes(out), 12 * seg.numel() + sort
    if name == "trans_multi":
        first, av, al, sdel_v = args[:4]
        deg = first[1:] - first[:-1]
        # one length test and target compare per arc of each neighbour's
        # row, plus the pairwise multi-arc compare of each row
        ops = int(deg[av.long()].sum()) * 2 + int((deg * deg).sum())
        return _nbytes(first, av, al, sdel_v) + _nbytes(out), ops
    if name == "hit_cut":
        cols, sub = args[0], args[1]
        n = cols.shape[1]
        # 7 hit rows in, 3 table words gathered per read, 4 rows + keep out
        return 7 * 4 * n + _nbytes(sub) + _nbytes(*out), 40 * n
    if name == "hit2arc":
        # qid, tid, rev and valid, the 4 coordinates and keep in a column,
        # the trim table read once; the 5 rows and good a column, sub_del a
        # read out; per column two lengths, hit2arc (~35 ops) and good
        colmat, sub = args[0], args[3]
        n = colmat.shape[1]
        return 33 * n + _nbytes(sub) + _nbytes(*out), 40 * n
    if name == "compact":
        # what the call needs on these inputs, not every row of every
        # column: each column's keep byte, with a remap also its two ids
        # and the map once, the k words of each survivor read (with a
        # remap k - 2 more) and written, the count; per column its test,
        # per survivor its place (about 12 integer ops a column)
        rows, keep, mp = _compact_args(args, kw)
        k, n, m = len(rows), rows[0].numel(), out.shape[1]
        return ((0 if keep is None else n)
                + (0 if mp is None else 8 * n + _nbytes(mp) - 8 * m)
                + 8 * k * m + 8, 12 * n)
    if name == "hit_flt":
        # 7 hit rows in, the trim table read once; keep, dp, the sum and
        # the present bytes out; per hit hit2arc (~35 ops), the tests, dp
        # and its share of the block sum
        cols, sub = args[0], args[1]
        n = cols.shape[1]
        return 7 * 4 * n + _nbytes(sub) + _nbytes(*out), 45 * n
    if name == "hit_marks":
        # 7 hit rows and the lengths in, hit2arc (~35 ops) a hit, the
        # marks out ("contained": both tables, 2T bytes) and, "sg", the
        # keep byte and 4 arc rows
        cols, mode, T = args[:3]
        n = cols.shape[1]
        return 7 * 4 * n + 4 * T + _nbytes(*_as_tuple(out)), 40 * n
    if name == "shard_arcs":
        # every row's lane bits; a row with a valid lane also its reads and
        # both codes, the used and contained marks and mdel (read once);
        # each arc's u, v, l, ol, gid and start read, its seven words
        # written, and the two counts; per lane about 20 integer ops
        rows, o, marks, mdel = args[:4]
        n = rows.shape[1]
        act = int(((o[4] & 3) != 0).sum())
        n_arc = out[0].shape[1]
        return (4 * n + 16 * act + _nbytes(marks[:2], mdel) + 24 * n_arc
                + 28 * n_arc + 16, 40 * n)
    if name == "key_member":
        # the int32 columns of the hay rows below hay_n (one more for the
        # pads) and of the live needles read once, the mask written once;
        # per key its packing, fmix64 hash and slot compare (about 20
        # integer ops)
        hay, hay_n, needles, needle_n = args[:4]
        mh, mq = hay[0].numel(), needles[0].numel()
        rows = max(min(hay_n, mh), 0)
        rows += rows < mh
        live = max(min(needle_n, mq), 0)
        return 4 * len(hay) * (rows + live) + _nbytes(out), 20 * (rows + live)
    if name == "dup_mark":
        # u and v read once, the mask written once; each arc packed,
        # hashed and compared in both passes
        u, v = args
        return _nbytes(u, v) + _nbytes(out), 40 * u.numel()
    if name == "decode3":
        flat = args[0]
        n = out.shape[1]
        # per record: its run mark and the max scan, the nibble shift and
        # mask, the or
        return _nbytes(flat) + _nbytes(out), 6 * n
    if name == "unpack4":
        # each piece's real records read once (4 or 7 words a record), the
        # colmat's 7 written; shifts and masks
        read = sum(4 * d.shape[0] * n for d, n in args[0])
        return read + _nbytes(out), 8 * out.shape[1]
    if name == "route":
        dest, payload = args[0].dest, args[1]
        # per row: the destination's match and popcount rank (about 10
        # integer ops) and R stores
        return (_nbytes(dest, payload) + _nbytes(out),
                (10 + payload.shape[0]) * dest.numel())
    if name == "route_layout":
        # K11's layout pass: dest read once, the bins and offsets written;
        # per row its bin, match and popcount (about 6 integer ops)
        dest = args[0]
        return _nbytes(dest) + 8 * (2 * args[1] + 4), 6 * dest.numel()
    if name == "read_marks":
        # every row's lane bits; a row with a valid lane also its reads
        # and both hit2arc codes (its mark words: about 12 integer ops
        # and two atomics), a self row also its flags and coordinates; the
        # per-read words written once
        colmat, o = args[0], args[1]
        act = (o[4] & 3) != 0
        n_act = int(act.sum())
        n_self = int((act & (colmat[0] == colmat[3])).sum())
        return (4 * o.shape[1] + 16 * n_act + 20 * n_self + _nbytes(out),
                12 * n_act)
    if name == "arc_order":
        # K13 with K12's marks: every row's lane bits; a row with a valid
        # lane also its reads and both codes, a self row also its flags
        # and coordinates (K12's part); mdel read once; each arc's start
        # and its u, v, l, ol read; the head, the flags row and the arc's
        # five words written.  The per-read marks, counts and cursors are
        # scratch inside the launch, not inputs or outputs: their bytes
        # count nowhere.  Per row about 32 integer ops (its mark words,
        # its arc lanes, their counts and places), per read of c arcs a
        # comparison sort's c log2 c
        colmat, o, mdel, n_seq = args[:4]
        n = o.shape[1]
        act = (o[4] & 3) != 0
        n_act = int(act.sum())
        n_self = int((act & (colmat[0] == colmat[3])).sum())
        arcs = fused2.arc_live(out, n_seq, kw.get("meta", 3))[2]
        n_arc = arcs.shape[1]
        c = _arcs_per_read(arcs, colmat, mdel.numel()).to(torch.float64)
        sort = float((c * torch.log2(c.clamp(min=1))).sum())
        return (4 * n + 16 * n_act + 20 * n_self + mdel.numel()
                + 20 * n_arc + 4 * 3 + 4 * n_seq + 20 * n_arc,
                32 * n + sort)
    if name == "clean_stage_b":
        # what the function moves: the CSR columns, K3's bits and sdel_v
        # read once, the complement rows' targets and bits as far as each
        # live arc scans them (to its match), the counters, the arc words
        # and the vertex bytes written once.  Each row's (live arcs, first
        # live target) pair passes from the arc half to the vertex half
        # inside the launch (scratch, not an input or an output): its
        # reads count as ops of the walk only.  Ops: a compare per scanned
        # arc, about 10 per arc and 6 per ratio of a weak-test arc; per
        # vertex its start code and each step of its walk (about 8)
        first, av, aol, bits, sdel_v, ratios = args[:6]
        max_ext = args[8]
        _res, rows = _stage_b_rows(args)
        scanned, tested = _clean_scan(first, av, bits, rows[0])
        V = sdel_v.numel()
        steps = _walk_steps(rows[0], rows[1], int(max_ext))
        return (_nbytes(first, av, aol, bits, sdel_v) + 5 * scanned
                + 4 * (3 + len(ratios) + av.numel()) + V,
                2 * scanned + 10 * av.numel() + 6 * len(ratios) * tested
                + 8 * (steps + V))
    if name == "bubble_bfs":
        first, av, al, adel, live_out, sources = args[:6]
        res, vis, par = out
        deg = first[1:] - first[:-1]
        nb = res[1].long()
        kk = torch.arange(vis.shape[1], device=vis.device)
        seen = (kk[None, :] < nb[:, None]) & (vis >= 0)
        ops = int(deg[vis.clamp(min=0).long()][seen].sum()) * 8
        return (_nbytes(first, av, al, adel, live_out, sources)
                + _nbytes(*out)), ops
    raise KeyError(name)


def _compact_args(args, kw):
    """K16's (rows, keep, mp) from a recorded call."""
    rows = args[0]
    rows = list(rows.unbind(0)) if isinstance(rows, torch.Tensor) \
        else list(rows)
    keep = args[1] if len(args) > 1 else kw.get("keep")
    mp = args[2] if len(args) > 2 else kw.get("mp")
    return rows, keep, mp


def _compact_kind(args, kw):
    """K16's five kinds of call: the cut (apply_cut's nine rows from two
    tensors), the take (Hits.take: the hit matrix by a keep), the trim
    table (apply_contained's three rows), the remapped hits (its id remap)
    and the graph's arcs (graph_from_hits: four rows)."""
    rows, keep, mp = _compact_args(args, kw)
    if mp is not None:
        return "remap"
    if isinstance(args[0], torch.Tensor):
        return {9: "take", 4: "arcs"}.get(len(rows), "%dr" % len(rows))
    return {9: "cut", 3: "trim"}.get(len(rows), "%dr_list" % len(rows))


def _arcs_per_read(arcs, colmat, T):
    """K13's arcs per read (the bucket sizes its sorts take), from the row
    column of its (5, n_arc) arcs."""
    read = torch.cat([colmat[0], colmat[3]])[arcs[4].long()]
    return torch.bincount(read.clamp(0, T - 1).long(), minlength=T)


def _stage_b_rows(args):
    """K14's recorded call through the twin's arc half: (res, rows), rows
    (2, V) the live arcs and first live target of each row."""
    from miniasm_tpu_torch.graph.devclean import clean_arcs_plain

    return clean_arcs_plain(*args[:4], *args[5:7])


def _clean_scan(first, av, bits, nlive):
    """K14's complement scans on this call: the arcs read in the rows
    v^1 (each live1 arc's scan stops at its match), and the arcs that
    take the weak-overlap test (live, not their row's first, in a row of
    two or more live arcs; nlive: each row's live arcs)."""
    from miniasm_tpu_torch.graph.devclean import comp_keys

    i64 = torch.int64
    A = av.numel()
    if A == 0:
        return 0, 0
    deg = first[1:] - first[:-1]
    _au, live1, key, q = comp_keys(first, av, bits)
    w = av.long() ^ 1
    # the first live1 arc w -> u^1 of each live1 arc u -> v, by row order
    skey, sidx = torch.sort(key, stable=True)
    pos = torch.searchsorted(skey, q).clamp(max=A - 1)
    hit = skey[pos] == q
    scanned = torch.where(hit, sidx[pos] - first[w] + 1, deg[w])
    # in a row of nl >= 2 live arcs, the nl - 1 after its first
    nl = nlive.long()
    tested = int((nl - 1)[nl >= 2].sum())
    return int(scanned[live1].to(i64).sum()), tested


def _walk_steps(nlive, fl_v, max_ext):
    """The walk steps of K14's vertex half over all vertices: each walk
    reads codes until a non-zero one, at most max_ext."""
    nl = nlive.long()
    fl = fl_v.long()
    code = torch.where(nl == 0, 1, torch.where(
        nl > 1, 2, torch.where(nl[fl ^ 1] != 1, 3, 0)))
    cur = torch.arange(nl.numel(), device=nl.device)
    going = torch.ones_like(cur, dtype=torch.bool)
    steps = 0
    for _ in range(max_ext):
        steps += int(going.sum())
        going = going & (code[cur] == 0)
        cur = torch.where(going, fl[cur], cur)
    return steps


def _measure_layout(lay, reps):
    """K11's layout pass on one call's destinations: a new Layout against
    layout_plain on the same card tensor (bins, sizes, offsets and total
    equal), both timed (each ends in its read-back), the pass's device
    time (memset, kernel, read-back) and its bytes and operations."""
    from miniasm_tpu_torch.parallel import route as rt

    dest, n_sh = lay.dest, lay.n_sh
    new = rt.Layout(dest, n_sh)
    h, off = rt.layout_plain(dest, n_sh)
    if new.sizes != h[1:n_sh + 1] or new.total != int(off[-1]) \
            or not torch.equal(new.off, off):
        _fail("route's layout pass disagrees with layout_plain")
    b, o = _cost("route_layout", (dest, n_sh), {}, None)
    return {"ms": _time_ms(lambda: rt.Layout(dest, n_sh), reps),
            "device_ms": _device_ms(lambda: rt.Layout(dest, n_sh), reps),
            "plain_ms": _time_ms(lambda: rt.layout_plain(dest, n_sh), reps),
            "bytes": b, "ops": o, "library_ms": None}


def _read_events(seg, key, T):
    """K2's valid events per read: the bucket sizes its sorts take."""
    from miniasm_tpu_torch.select import fused2

    ok = (seg >= 0) & (seg < T) & (key != fused2.SKIP)
    return torch.bincount(seg[ok].long(), minlength=T)


def _measure(name, fn, plain, args, kw, reps, own=True):
    """Kernel vs plain version on one recorded call: bit-equal, both timed
    (the wrapper by CUDA events and by torch.profiler's device time), the
    call's bytes and operations; K7 also beside torch.isin, the one
    PyTorch call that computes its function when every needle is live.
    own: the call is on the path the kernel's row times (K10's and K18's
    extra timings are taken on that path only)."""
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    if name == "arc_order":
        # the part both write: the head, the flags row and the arcs
        from miniasm_tpu_torch.select.fused2 import arc_live

        live = (args[3], kw.get("meta", 3))
        err = _max_abs_err(arc_live(got, *live), arc_live(want, *live))
    else:
        err = _max_abs_err(got, want)
    b, o = _cost(name, args, kw, got)
    split = _device_split(lambda: fn(*args, **kw), reps)
    m = {"err": err, "ms": _time_ms(lambda: fn(*args, **kw), reps),
         "device_ms": sum(split.values()),
         "plain_ms": _time_ms(lambda: plain(*args, **kw), 2),
         "bytes": b, "ops": o, "library_ms": None,
         "shapes": [list(x.shape) for a in args
                    for x in (a if isinstance(a, list) else [a])
                    if hasattr(x, "shape")]}
    if name == "key_member" and args[3] >= args[2][0].numel():
        # every needle live: torch.isin on the packed keys (the hay's pads
        # masked, the needles xor-ed), packed before the timing
        from miniasm_tpu_torch.utils import arrays

        hay, hay_n, needles = args[:3]
        xr = args[4] if len(args) > 4 else kw.get("needle_xor", 0)
        live = torch.arange(hay[0].numel(), device=hay[0].device) < hay_n
        hk = arrays.pack_keys([torch.where(live, c, 2**31 - 1) for c in hay])
        qk = arrays.pack_keys([c ^ xr for c in needles])
        if not torch.equal(torch.isin(qk, hk), got):
            _fail("key_member disagrees with torch.isin")
        m["library_ms"] = _time_ms(lambda: torch.isin(qk, hk), reps)
    if name == "arc_order":
        # the costly part as one PyTorch call: the stable torch.sort of the
        # compacted arcs' int64 hit keys (in row order, as the twin sorts)
        from miniasm_tpu_torch.select.fused2 import arc_live

        colmat = args[0]
        arcs = arc_live(got, args[3], kw.get("meta", 3))[2]
        row = arcs[4].long().sort().values
        hkey = ((torch.cat([colmat[0], colmat[3]])[row].long() << 32)
                | ((torch.cat([colmat[1], colmat[4]])[row].long() + 2**31)
                   & 0xFFFFFFFF))
        m["library_ms"] = _time_ms(
            lambda: torch.sort(hkey, stable=True), reps)
        m.update(_tail_extras(fn, args, kw, split, reps))
    if name == "read_marks":
        # the function as one PyTorch call: a scatter_reduce_ amax of the
        # rows' mark words over the concatenated query and target indices
        # (both made before the timing) into a zeroed word a read
        from miniasm_tpu_torch.select.fused2 import mark_words

        qi, qb, ti, tb = mark_words(*args[:3])
        idx, val = torch.cat([qi, ti]), torch.cat([qb, tb])
        lib = torch.zeros(args[2], dtype=torch.int32, device=idx.device)
        if not torch.equal(lib.scatter_reduce_(0, idx, val, "amax"), got):
            _fail("read_marks disagrees with its scatter_reduce_")
        m["library_ms"] = _time_ms(
            lambda: lib.scatter_reduce_(0, idx, val, "amax"), reps)
        m["device_split"] = {_short(k): v for k, v in split.items()}
        m["device_ms_unflushed"] = _device_ms(
            lambda: fn(*args, **kw), reps, flush=False)
    if name == "hit2arc" and own:
        m.update(_hit2arc_extras(fn, args, kw, reps))
    if name in ("hit_marks", "unpack4") and own:
        # the device time by launch (memset, kernel), without the flush,
        # and the wrapper's host time; K18's containment call also beside
        # its used half's library call, one index_fill_ of ones over the
        # concatenated qid and tid rows (made before the timing): no
        # PyTorch call computes the contained half
        m["device_split"] = {_short(k): v for k, v in split.items()}
        m["device_ms_unflushed"] = _device_ms(
            lambda: fn(*args, **kw), reps, flush=False)
        m["host_us"] = _host_us(lambda: fn(*args, **kw), reps)
        if name == "unpack4":
            m["pieces"] = [[d.shape[0], d.shape[1], n] for d, n in args[0]]
        elif args[1] == "contained":
            cols, T = args[0], args[2]
            idx = torch.cat([cols[0], cols[3]]).clamp(0, T - 1).long()
            lib = torch.zeros(T, dtype=torch.uint8, device=cols.device)
            if not torch.equal(lib.index_fill_(0, idx, 1), got[1]):
                _fail("hit_marks: the used marks disagree with index_fill_")
            m["used_library_ms"] = _time_ms(
                lambda: lib.index_fill_(0, idx, 1), reps)
    if name == "compact":
        # one boolean-mask index of the same columns, as one matrix, by the
        # survivors' mask (with a remap: of the survivors of both ids)
        rows, keep, mp = _compact_args(args, kw)
        mat = torch.stack(rows)
        ok = torch.ones(mat.shape[1], dtype=torch.bool, device=mat.device) \
            if keep is None else keep.to(torch.bool)
        if mp is not None:
            T = mp.shape[0]
            ok = ok & (mp[mat[0].clamp(0, T - 1).long()] >= 0) \
                & (mp[mat[3].clamp(0, T - 1).long()] >= 0)
        m["library_ms"] = _time_ms(lambda: mat[:, ok], reps)
        m.update(_compaction_extras(fn, args, kw, split, reps))
    if name == "shard_arcs":
        # torch.nonzero of the arc lanes and the seven gathers, from the
        # concatenated lanes (made before the timing)
        rows, o, marks, mdel = args[:4]
        T = marks.shape[1]
        alive = (marks[0] != 0) & ~mdel & (marks[1] == 0)
        both = alive[rows[0].clamp(0, T - 1).long()] \
            & alive[rows[3].clamp(0, T - 1).long()] & (rows[0] != rows[3])
        lanes = torch.cat([((o[4] & 1) != 0) & (o[5] >= 0) & both,
                           ((o[4] & 2) != 0) & (o[10] >= 0) & both])
        srcs = [torch.cat([o[6], o[11]]), torch.cat([o[8], o[13]]),
                torch.cat([o[7], o[12]]), torch.cat([o[9], o[14]]),
                torch.cat([rows[7], rows[7] | 1]),
                torch.cat([rows[0], rows[3]]), torch.cat([rows[1], rows[4]])]

        def lib():
            idx = torch.nonzero(lanes).flatten()
            return torch.stack([s[idx] for s in srcs])

        if not torch.equal(lib(), got[0]):
            _fail("shard_arcs disagrees with torch.nonzero and its gathers")
        m["library_ms"] = _time_ms(lib, reps)
        m.update(_compaction_extras(fn, args, kw, split, reps))
    if name == "clean_stage_b":
        # the complement test as the twin does it: one int64 torch.sort of
        # the live arcs' keys and one searchsorted of the complements
        from miniasm_tpu_torch.graph import devclean

        _au, _live1, key, q = devclean.comp_keys(args[0], args[1], args[3])
        m["library_ms"] = _time_ms(
            lambda: torch.searchsorted(torch.sort(key).values, q), reps)
        m.update(_stage_b_floor(fn, args, kw, reps))
    return m


def _hit2arc_extras(fn, args, kw, reps) -> dict:
    """K6's call without the L2 flush and its wrapper's host time, beside
    its latency floor, an empty plain launch of its grid, after the flush
    and without it."""
    call = lambda: fn(*args, **kw)  # noqa: E731
    f = _hit2arc_floor(args[0].shape[1], args[3].shape[1])
    return {"device_ms_unflushed": _device_ms(call, reps, flush=False),
            "host_us": _host_us(call, reps),
            "floor_device_ms": _device_ms(f, reps),
            "floor_device_ms_unflushed": _device_ms(f, reps, flush=False)}


def _compaction_extras(fn, args, kw, split, reps) -> dict:
    """K16's or K19's call: its device time by launch (split: by event
    name), its wrapper's wall time, and, where the wrapper takes a `grid`
    argument (a wrapper of a design without a cooperative grid takes
    none), the grid and its latency floor: an empty cooperative launch of
    as many blocks of 256 threads, with one grid sync and without, each
    timed after a flush."""
    by: dict = {}
    for k, v in split.items():
        by[_short(k)] = by.get(_short(k), 0.0) + v
    out = {"device_split": by, "wall_us": _wall_us(
        lambda: fn(*args, **kw), reps)}
    if "grid" in inspect.signature(fn).parameters:
        grid = [0, 0, 0, 0]
        fn(*args, **dict(kw, grid=grid))
        out["grid"] = {"blocks": grid[0], "items_a_block": grid[1],
                       "most_blocks": grid[2], "spill_words": grid[3]}
        for sync in (1, 0):
            f = _coop_floor(grid[0], sync)
            out["floor" if sync else "floor_nosync"] = {
                "ms": _time_ms(f, reps), "device_ms": _device_ms(f, reps)}
    return out


def _tail_extras(fn, args, kw, split, reps) -> dict:
    """K13's call: its device time by launch (split: by event name), and
    without the L2 flush, its wrapper's host time, the grid it launched
    and its latency floor: an empty cooperative launch of as many blocks
    of 256 threads with 0, 1 and as many grid syncs as K13 makes, each
    timed after a flush and without."""
    grid = [0, 0, 0, 0]
    call = lambda: fn(*args, **dict(kw, grid=grid))  # noqa: E731
    call()
    out = {"device_split": {_short(k): v for k, v in split.items()},
           "grid": {"blocks": grid[0], "reads_a_block": grid[1],
                    "most_blocks": grid[2], "syncs": grid[3]},
           "ms_unflushed": _time_ms(call, reps, flush=False),
           "device_ms_unflushed": _device_ms(call, reps, flush=False),
           "host_us": _host_us(call, reps)}
    for syncs in sorted({0, 1, grid[3]}):
        f = _coop_floor(grid[0], syncs)
        out["floor_%d" % syncs] = {
            "ms": _time_ms(f, reps), "device_ms": _device_ms(f, reps),
            "device_ms_unflushed": _device_ms(f, reps, flush=False)}
    return out


def _wall_us(fn, reps: int) -> float:
    """Mean wall time, in us, of one call of fn that ends in a sync (a
    compaction's wrapper reads its count back), each started on an idle
    card: the host's work, the device's and the read-back's."""
    fn()
    tot = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        tot += time.perf_counter() - t0
    return tot / reps * 1e6


def _read_us(reps: int) -> dict:
    """Host time, in us, of reading one int64 count back from an idle
    card: int() of the device tensor (a pageable copy) and int() of
    device.to_host's pinned copy, the two ways a compaction's wrapper can
    learn its survivor count."""
    from miniasm_tpu_torch.device import to_host

    t = torch.zeros(1, dtype=torch.int64, device="cuda")
    out = {}
    for key, read in (("item", lambda: int(t)),
                      ("to_host", lambda: int(to_host(t)))):
        read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            read()
        out[key] = (time.perf_counter() - t0) / reps * 1e6
    return out


def _host_us(fn, reps: int) -> float:
    """Mean host time of one call of fn (its enqueue: the card is busy
    with an L2 flush meanwhile, so no call waits on it), in us."""
    fn()
    torch.cuda.synchronize()
    tot = 0.0
    for _ in range(reps):
        _flush()
        t0 = time.perf_counter()
        fn()
        tot += time.perf_counter() - t0
        torch.cuda.synchronize()
    return tot / reps * 1e6


def _coop_floor(blocks: int, syncs: int):
    """A launcher of clean.cu's ma_coop_floor: an empty cooperative launch
    of `blocks` blocks of 256 threads that makes `syncs` grid syncs (a
    measurement's entry, called through the library, counted nowhere)."""
    from miniasm_tpu_torch import cuda

    f = cuda._lib("clean.cu").ma_coop_floor
    f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int

    def launch():
        err = f(blocks, syncs, torch.cuda.current_stream().cuda_stream)
        if err:
            _fail("coop_floor: launch failed (cudaError %d)" % err)
    return launch


def _hit2arc_floor(n: int, T: int):
    """A launcher of staged.cu's ma_hit2arc_floor: an empty plain launch of
    the grid K6 takes for n columns and T reads (a measurement's entry,
    called through the library, counted nowhere)."""
    from miniasm_tpu_torch import cuda

    f = cuda._lib("staged.cu").ma_hit2arc_floor
    f.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    f.restype = ctypes.c_int

    def launch():
        err = f(n, T, torch.cuda.current_stream().cuda_stream)
        if err:
            _fail("hit2arc_floor: launch failed (cudaError %d)" % err)
    return launch


def _stage_b_floor(fn, args, kw, reps) -> dict:
    """K14 as the path finds its inputs (right after K3 wrote the bits,
    so in L2: no flush between calls), its wrapper's host time, and its
    latency floor: an empty cooperative launch of the grid K14 chose on
    this call, with one grid sync and without, each timed as K14 is
    (after a flush, and without)."""
    grid = [0, 0]
    call = lambda: fn(*args, **dict(kw, grid=grid))  # noqa: E731
    call()
    blocks = grid[0]
    out = {"grid": {"blocks": blocks, "lanes": grid[1],
                    "vertices": int(args[4].numel())},
           "ms_unflushed": _time_ms(call, reps, flush=False),
           "device_ms_unflushed": _device_ms(call, reps, flush=False),
           "host_us": _host_us(call, reps)}
    for sync in (1, 0):
        f = _coop_floor(blocks, sync) if blocks else None
        key = "floor" if sync else "floor_nosync"
        out[key] = None if f is None else {
            "ms": _time_ms(f, reps),
            "device_ms": _device_ms(f, reps),
            "ms_unflushed": _time_ms(f, reps, flush=False),
            "device_ms_unflushed": _device_ms(f, reps, flush=False),
            "host_us": _host_us(f, reps)}
    return out


def _sweep_tiers(row, calls, cases):
    """K2's branches, as the kernel counts them: on the row's largest call
    and on each extra case, the reads sorted by a block and those of them
    sorted in device memory (every other read by a warp in registers).  An
    extra case at the default cap must take both large-read branches, one
    with smem_cap=0 must send every read that holds an event to device
    memory."""
    from miniasm_tpu_torch.select import fused2

    def tiers(args, kw):
        n = _read_events(*args[:3])
        block, dev = fused2.sweep_events_tiers(*args, **kw)[1].tolist()
        return {"events": args[0].numel(), "reads": args[2],
                "most_events_a_read": int(n.max()),
                "reads_with_events": int((n > 0).sum()),
                "block_reads": block, "device_memory_reads": dev}

    _size, args, kw = max((calls[k] for k in calls if k[0] == ROW_PATH[
        "sweep"]), key=lambda c: c[0])
    row["largest_call"] = tiers(args, kw)
    _say("[sweep] largest call: %s" % json.dumps(row["largest_call"]))
    for key, (args, kw) in sorted(cases.items()):
        t = tiers(args, kw)
        row["cases"]["/".join(key)].update(t)
        _say("[sweep] %s %s: %s" % ("/".join(key), json.dumps(kw),
                                     json.dumps(t)))
        if kw.get("smem_cap") == 0:
            ok = t["block_reads"] == t["device_memory_reads"] \
                == t["reads_with_events"]
        else:
            ok = t["block_reads"] > t["device_memory_reads"] > 0
        if not ok:
            _fail("sweep[%s] took other branches than it was built for"
                  % "/".join(key))


def _arc_tiers(row, calls):
    """K13's branches on the row's largest call, as the kernel counts
    them: the reads sorted by a block and those of them sorted in device
    memory (every other read by a warp in registers); again with
    smem_cap=0, which must send every read that holds an arc to device
    memory, bit-equal to the twin."""
    from miniasm_tpu_torch.select import fused2

    _size, args, kw = max((calls[k] for k in calls
                           if k[0] == ROW_PATH["arc_order"]),
                          key=lambda c: c[0])
    live = (args[3], kw.get("meta", 3))
    res, t = fused2.arc_order_tiers(*args, meta=live[1])
    head, _flags, arcs = fused2.arc_live(res, *live)
    c = _arcs_per_read(arcs, args[0], args[2].numel())
    row["largest_call"] = {
        "rows": args[0].shape[1], "arcs": int(head[1]),
        "most_arcs_a_read": int(c.max()),
        "reads_with_arcs": int((c > 0).sum()), "dup_hit": int(head[2]),
        "block_reads": int(t[0]), "device_memory_reads": int(t[1])}
    res0, t0 = fused2.arc_order_tiers(*args, meta=live[1], smem_cap=0)
    row["largest_call_smem0"] = {"block_reads": int(t0[0]),
                                 "device_memory_reads": int(t0[1])}
    _say("[arc_order] largest call: %s; smem_cap=0: %s"
         % (json.dumps(row["largest_call"]),
            json.dumps(row["largest_call_smem0"])))
    same = all(torch.equal(x, y) for x, y in zip(
        fused2.arc_live(res0, *live), fused2.arc_live(res, *live)))
    if not same or not int(t0[0]) == int(t0[1]) == int((c > 0).sum()):
        _fail("arc_order with smem_cap=0 took other branches than it was "
              "built for, or disagrees with the default cap")


def _calls(name, rec) -> list:
    """Every call of the run rec.log_tag, read from the recorded calls
    after the runs: K3 [V, A, D, do_trans]; K4 [S, K, the largest visited
    set], the call replayed on its inputs."""
    rows = []
    for args, kw in rec.log:
        if name == "trans_multi":
            rows.append([args[0].shape[0] - 1, args[1].shape[0],
                         int(args[4]), int(bool(args[6]))])
        else:
            S = args[5].shape[0]
            nb = int(rec.orig(*args, **kw)[0][1].max()) if S else 0
            rows.append([S, int(args[6]), nb])
    return rows


def _sum(parts) -> dict:
    """Times, bound and library time of a set of measured calls."""
    ms = sum(p["ms"] for p in parts)
    t_bytes = sum(p["bytes"] for p in parts) / HBM_BYTES_S * 1e3
    t_ops = sum(p["ops"] for p in parts) / INT32_OPS_S * 1e3
    lib = [p["library_ms"] for p in parts]
    return {"ms": ms, "device_ms": sum(p["device_ms"] for p in parts),
            "plain_ms": sum(p["plain_ms"] for p in parts),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if None in lib else sum(lib)}


def _symm_cases(n: int) -> dict:
    """K7's and K8's calls beyond the recorded ones (n: the largest
    recorded call's arcs), seeded int32 columns: K8 on n arcs drawn from
    about n / 3 (u, v) pairs (the E. coli graphs have no duplicate), on
    (-1, -1) arcs among others ((-1, -1) packs to all ones, the pattern of
    the table's empty slots) and on 4,194,304 arcs (a table of 128 MB, past
    the 50 MB L2); K7 on n keys with (-1, -1) among hay and needles,
    INT32_MAX pads (hay_n < mh) and dead needles (needle_n < mq), and on
    4,194,304 keys (a table of 128 MB) whose needles are half the hay xor
    1, as del_asymm_mask asks."""
    import numpy as np

    rng = np.random.default_rng(SEED)

    def cols(*cs):
        return [torch.from_numpy(np.asarray(c).astype(np.int32)).cuda()
                for c in cs]

    big = 1 << 22
    dups = cols(rng.integers(0, max(n // 300, 1), n), rng.integers(0, 100, n))
    marker = cols(rng.integers(-1, 2, n), rng.integers(-1, 1, n))
    wide = cols(rng.integers(0, 1024, big), rng.integers(0, 1024, big))
    h = cols(np.concatenate([rng.integers(-1, 200, n), [-1]]),
             np.concatenate([rng.integers(-1, 200, n), [-1]]))
    q = cols(np.concatenate([[2**31 - 1, -1], rng.integers(-1, 220, n)]),
             np.concatenate([[2**31 - 1, -1], rng.integers(-1, 200, n)]))
    hb = cols(rng.integers(-2**31, 2**31, big), rng.integers(-2**31, 2**31, big))
    qb = [torch.cat([c[:big // 2] ^ 1, x]) for c, x in zip(hb, cols(
        rng.integers(-2**31, 2**31, big // 2),
        rng.integers(-2**31, 2**31, big // 2)))]
    return {"dup_mark": {("seeded", "dups"): (tuple(dups), {}),
                         ("seeded", "marker"): (tuple(marker), {}),
                         ("seeded", "beyond_l2"): (tuple(wide), {})},
            "key_member": {("seeded", "marker_pads"): (
                               (h, n - 100, q, n - 50, 0), {}),
                           ("seeded", "beyond_l2"): (
                               (hb, big, qb, big, 1), {})}}


def _kernel_phase(recs, runs, cases):
    """Kernel vs plain version on the recorded inputs of the runs, and on
    the extra calls `cases` ({kernel: {key: (args, kw)}}).  Each kernel's
    row times the calls of its own path (ROW_PATH), or one call
    (ROW_CALL); a kernel reused on another path gets a sub-row there
    (REUSE)."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.core import hit2arc as h2a
    from miniasm_tpu_torch.graph import clean, devbub, devclean
    from miniasm_tpu_torch.io.native import pafload
    from miniasm_tpu_torch.parallel import full as pfull, route as rt
    from miniasm_tpu_torch.select import cut, filter as flt, fused2
    from miniasm_tpu_torch.utils import arrays, compact as kc

    plain = {"decode3": pafload.decode3_plain,
             "unpack4": pafload.unpack4_pieces_plain,
             "cut_hit2arc": fused2.cut_hit2arc_plain,
             "sweep": lambda *a, smem_cap=None: fused2.sweep_events_plain(*a),
             "trans_multi": devclean.trans_multi_plain,
             "bubble_bfs": devbub.bubble_bfs_plain,
             "hit_cut": cut.hit_cut_plain,
             "hit2arc": h2a.hit2arc_tail_plain,
             "key_member": arrays.key_member_plain,
             "dup_mark": clean.dup_mark_plain,
             "route": rt.route_plain,
             # the recorded calls pass the main path's fetch buffer (res,
             # out), which the twins do not take
             "read_marks": fused2.read_marks_plain,
             "arc_order": lambda *a, smem_cap=None, res=None, meta=3,
                 grid=None: fused2.arc_order_plain(*a, meta=meta),
             "clean_stage_b": lambda *a, out=None:
                 devclean.clean_stage_b_plain(*a[:7], a[8]),
             "compact": kc.compact_plain,
             "hit_flt": flt.hit_flt_plain,
             "hit_marks": h2a.hit_marks_plain,
             "shard_arcs": pfull.shard_arcs_plain}
    reps = {"cut_hit2arc": 50, "sweep": 20, "trans_multi": 20,
            "bubble_bfs": 10, "hit_cut": 50, "hit2arc": 50,
            "key_member": 50, "dup_mark": 50, "decode3": 50, "unpack4": 50,
            "route": 50, "read_marks": 50, "arc_order": 20,
            "clean_stage_b": 20, "compact": 50,
            "hit_flt": 50, "hit_marks": 50, "shard_arcs": 50}
    by_name = {k.name: k for k in cuda.KERNELS}
    rows = []
    for rec in recs:
        name = rec.kernel
        calls = dict(rec.calls)
        for key, (args, kw) in cases.get(name, {}).items():
            calls[key] = (0, args, kw)
        fn = rec.orig
        measured = {}
        for key, (_size, args, kw) in sorted(calls.items(),
                                             key=lambda x: str(x[0])):
            if name == "unpack4":
                # the load's pieces: the kernel into a new colmat
                args = args[:1]
            m = _measure(name, fn, plain[name], args, kw, reps[name],
                         own=key[0] == ROW_PATH[name])
            if name == "route":
                # the call's Layout: K11's layout pass and the read-back,
                # paid once per destination vector
                m["layout"] = _measure_layout(args[0], reps[name])
            if m["err"] != 0.0:
                _fail("kernel %s[%s] disagrees with its plain version "
                      "(max abs err %r)" % (name, key, m["err"]))
            if name == "dup_mark" and key[0] == "seeded" \
                    and not rec.orig(*args).any():
                _fail("dup_mark: the seeded input has no duplicate")
            measured[key] = m
        own = [m for k, m in measured.items() if k[0] == ROW_PATH[name]]
        if name in ROW_CALL:
            own = [measured[ROW_CALL[name]]] if ROW_CALL[name] in measured \
                else []
        if not own:
            _fail("kernel %s: the %s runs recorded no call"
                  % (name, ROW_PATH[name]))
        K = by_name[name]
        row = {"name": name, "route": "cuda",
               "source": "miniasm_tpu_torch/csrc/" + K.source,
               "replaces": K.replaces,
               "launches": runs[RUN_OF_RECORD[name]]["launches"][name],
               "launches_run": RUN_OF_RECORD[name],
               "launches_ecoli_ug": runs["ecoli_ug"]["launches"][name],
               "max_abs_err": max(m["err"] for m in measured.values())}
        row.update(_sum(own))
        row["calls_timed"] = len(own)
        if name == "route":
            row["layout"] = dict(
                _sum([own[0]["layout"]]),
                launches=runs[RUN_OF_RECORD[name]]["launches"]["route_layout"])
        if name in REUSE:
            sub, path, run = REUSE[name]
            parts = [m for k, m in measured.items() if k[0] == path]
            if not parts:
                _fail("kernel %s: the %s runs recorded no call"
                      % (name, path))
            row[sub] = dict(_sum(parts), launches=runs[run]["launches"][name],
                            launches_run=run, calls_timed=len(parts))
        # every timed call on its own: times, bound and shapes
        row["cases"] = {"/".join(k): dict(m, **_sum([m]))
                        for k, m in measured.items()}
        if name == "clean_stage_b":
            # the largest detection: its grid, its times without the
            # flush, its latency floor
            row["note"] = ("carries K15 clean_ends: the vertex half runs "
                           "in the same launch, behind a grid-wide sync")
            for k in ("grid", "ms_unflushed", "device_ms_unflushed",
                      "host_us", "floor", "floor_nosync"):
                row[k] = own[0][k]
        if name in ("read_marks", "arc_order"):
            # each call on a line of its own: its times by launch beside
            # the library call; K13 also without the flush, its host time,
            # its grid and floor
            for k, m in sorted(measured.items()):
                keys = ["shapes", "ms", "device_ms", "device_split",
                        "device_ms_unflushed", "ms_unflushed", "host_us",
                        "library_ms", "grid"]
                keys += sorted(x for x in m if x.startswith("floor_"))
                _say("[%s] %s: %s" % (name, "/".join(k), json.dumps({
                    x: m[x] for x in keys if x in m}
                    | {"bound_ms": _sum([m])["bound_ms"]})))
            if name == "arc_order":
                # the largest call: its grid, split, unflushed and host
                # times, its latency floor
                for x in own[0]:
                    if x.startswith(("floor_", "grid", "device_split",
                                     "ms_unflushed", "device_ms_unflushed",
                                     "host_us")):
                        row[x] = own[0][x]
        if name in ("hit_marks", "unpack4"):
            # each call on a line of its own: its times by launch, flushed
            # and not, its host time, K18's used-half library call
            for k, m in sorted(measured.items()):
                _say("[%s] %s: %s" % (name, "/".join(k), json.dumps({
                    x: m[x] for x in (
                        "shapes", "pieces", "ms", "device_ms",
                        "device_split", "device_ms_unflushed", "host_us",
                        "used_library_ms") if x in m}
                    | {"bound_ms": _sum([m])["bound_ms"]})))
        if name == "hit2arc":
            # the entry's call, without the flush too, beside its floor
            for k in ("device_ms_unflushed", "host_us", "floor_device_ms",
                      "floor_device_ms_unflushed"):
                row[k] = own[0][k]
            _say("[hit2arc] %s" % json.dumps({k: row[k] for k in (
                "device_ms", "device_ms_unflushed", "host_us",
                "floor_device_ms", "floor_device_ms_unflushed",
                "bound_ms")}))
        if name in ("compact", "shard_arcs"):
            # each call on a line of its own: its columns, its times by
            # launch beside the library call, its grid and floor
            for k, m in sorted(measured.items()):
                _say("[%s] %s: %s" % (name, "/".join(k), json.dumps({
                    x: m.get(x) for x in (
                        "shapes", "ms", "device_ms", "device_split",
                        "library_ms", "wall_us", "grid", "floor",
                        "floor_nosync")}
                    | {"bound_ms": _sum([m])["bound_ms"]})))
            if name == "compact":
                row["read_us"] = _read_us(reps[name])
                _say("[compact] reading m: %s" % json.dumps(row["read_us"]))
        if name == "sweep":
            _sweep_tiers(row, calls, cases.get(name, {}))
        if name == "arc_order":
            _arc_tiers(row, calls)
        if rec.log_tag is not None:
            row["calls"] = _calls(name, rec)
            _say("[calls] %s %s (%s): %s" % (
                rec.log_tag, name, "V, A, D, do_trans"
                if name == "trans_multi" else "S, K, nb max",
                json.dumps(row["calls"])))
        if name == "trans_multi":
            # K3's launches on noisy_ug by variant, and their cost a run:
            # each variant's launches times its largest call's device ms
            # less its bound
            by = {"trans": sum(c[3] for c in row["calls"]),
                  "multi": sum(1 - c[3] for c in row["calls"])}
            if sum(by.values()) != row["launches"]:
                _fail("trans_multi: %d calls logged on noisy_ug, %d "
                      "launches" % (sum(by.values()), row["launches"]))
            row["launches_by_variant"] = by
            row["cost_ms_a_run"] = sum(
                n * (row["cases"]["main/" + v]["device_ms"]
                     - row["cases"]["main/" + v]["bound_ms"])
                for v, n in by.items() if n)
            _say("[calls] noisy_ug trans_multi launches by variant %s, cost "
                 "a run %.5f ms" % (json.dumps(by), row["cost_ms_a_run"]))
        _say("kernel " + json.dumps(row))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the sharded path and the multi-process worker

def _group(device: str, rdv_dir: str):
    """A one-rank group on `device` (NCCL on the card, gloo on the CPU)
    around a file:// rendezvous, warmed by one all_reduce; returns
    (group, seconds to set it up)."""
    from miniasm_tpu_torch.parallel import group

    t0 = time.time()
    shutil.rmtree(rdv_dir, ignore_errors=True)
    os.makedirs(rdv_dir)
    g = group.init(0, 1, "file://" + os.path.join(rdv_dir, "rdv_" + device),
                   device=device)
    g.all_reduce(torch.zeros(1, device=g.device))
    if g.device.type == "cuda":
        torch.cuda.synchronize()
    return g, time.time() - t0


def _sharded(paf: str, device: str) -> tuple[str, str, float, dict, dict]:
    """One run_sharded on the current group, as _cli runs the CLI."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.parallel import full
    from miniasm_tpu_torch.utils import timers

    buf, err = io.StringIO(), io.StringIO()
    cuda.reset_launches()
    was = timers.tracing(True)
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(err):
            full.run_sharded(paf, Opt(), out=buf)
    finally:
        timers.tracing(was)
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    launches = cuda.launch_counts()
    stages = dict(full.LAST_TIMING)
    stages.update(_traced(full.LAST_TRACE))
    return buf.getvalue(), err.getvalue(), dt, stages, launches


def _multihost(paf: str, mdir: str) -> dict:
    """Two worker processes of miniasm_tpu_torch.parallel.multihost on the
    one card over gloo; returns rank 0's GFA, the wall and each process's
    stats (launches, stage times)."""
    from miniasm_tpu_torch.device import ENV

    procs = MH_PROCS
    shutil.rmtree(mdir, ignore_errors=True)
    os.makedirs(mdir)
    env = dict(os.environ)
    env.pop(ENV, None)  # the card
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    ps = [subprocess.Popen(
        [sys.executable, "-m", "miniasm_tpu_torch.parallel.multihost",
         "--coordinator", "file://" + os.path.join(mdir, "rdv"),
         "--num-procs", str(procs), "--proc-id", str(k), "--backend",
         "gloo", "--out", os.path.join(mdir, "p%d.gfa" % k),
         "--stats", os.path.join(mdir, "p%d.json" % k), paf],
        env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for k in range(procs)]
    errs = []
    try:
        for p in ps:
            errs.append(p.communicate(timeout=900)[1])
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.time() - t0
    for k, (p, e) in enumerate(zip(ps, errs)):
        if p.returncode != 0:
            sys.stderr.write(e[-3000:])
            _fail("multihost process %d exited %d" % (k, p.returncode))
    stats = []
    for k in range(procs):
        with open(os.path.join(mdir, "p%d.json" % k)) as f:
            stats.append(json.load(f))
    with open(os.path.join(mdir, "p0.gfa")) as f:
        out = f.read()
    return {"out": out, "wall_s": dt, "stats": stats}


def _sweep_cases() -> dict:
    """K2's calls beyond the recorded ones, whose reads hold at most a few
    hundred events (all sorted in registers): seeded unsorted events in
    reads of about 600, 4,000 and 100,000 events beside 959 reads of
    about 120 and 1,000 absent rows, once at the default cap (a block's
    shared memory; device memory for the largest) and once with
    smem_cap=0 (every read in device memory)."""
    import numpy as np

    from miniasm_tpu_torch.select import fused2

    rng = np.random.default_rng(SEED)
    sides = [50_000] + [2_000] * 8 + [300] * 32 + [60] * 959
    T = len(sides)
    seg, key = [np.full(1000, T)], [np.full(1000, fused2.SKIP)]
    for r, m in enumerate(sides):
        hi, span = (2_000_000, 40_000) if m > 10_000 else (30_000, 5_000)
        a = rng.integers(0, hi, m)
        b = a + rng.integers(1, span, m)
        ok = rng.random(m) >= 0.1  # a tenth skipped
        seg.append(np.full(2 * m, r))
        key += [np.where(ok, a * 2, fused2.SKIP),
                np.where(ok, b * 2 + 1, fused2.SKIP)]
    perm = rng.permutation(sum(x.shape[0] for x in seg))
    seg = torch.from_numpy(np.concatenate(seg)[perm].astype(np.int32))
    key = torch.from_numpy(np.concatenate(key)[perm].astype(np.int32))
    args = (seg.cuda(), key.cuda(), T, 3, 100)
    return {"sweep": {("cases", "deep_reads"): (args, {}),
                      ("cases", "deep_reads_smem0"): (args,
                                                      {"smem_cap": 0})}}


def _decode3_cases() -> dict:
    """K9's calls beyond the recorded ones: seeded pieces of 131,072
    records with the run tables a query-grouped stream does not give: the
    first run after record 0, one run over the piece, every run in the
    last 16 records (most starts repeated), and repeated starts."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    n = 1 << 17
    m = n // 8
    tables = {"late_first_run": np.sort(
                  rng.choice(np.arange(1500, n), m // 3, replace=False)),
              "one_run": np.zeros(1, np.int64),
              "runs_in_last_16": np.sort(rng.integers(n - 16, n, m)),
              "duplicate_starts": np.sort(rng.integers(0, n, m // 2))}
    cases = {}
    for name, starts in tables.items():
        bp = np.full(m, -1, np.int64)
        bp[:len(starts)] = starts
        bq = np.where(bp >= 0, rng.integers(0, 2**28, m), 0)
        flat = np.concatenate([rng.integers(-2**31, 2**31, 3 * n),
                               rng.integers(0, 2**32, m), bp, bq])
        flat = (flat & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        cases[("cases", name)] = ((torch.from_numpy(flat).cuda(),), {})
    return {"decode3": cases}


def _route_cases(paf: str, mdir: str) -> dict:
    """K11's calls beyond the recorded ones: an 8-way routing of the clean
    rows (dest = tid // ceil(n_seq / 8), self matches dropped, the four
    payload rows of the sweep exchange), the same payload to 1,024 shards
    on seeded skewed destinations (Zipf, exponent 1.3: about 30% of the
    rows to shard 0, the tail past 1,023 dropped), and each worker
    process's repartition, on the inputs the process saved (--stats)."""
    import numpy as np

    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.io.native.pafload import load_hits_mt
    from miniasm_tpu_torch.parallel import full, route as rt
    from miniasm_tpu_torch.parallel.group import block_size

    opt = Opt()
    cm, d, h = load_hits_mt(paf, opt.min_span, opt.min_match,
                            min_iden=float(opt.min_iden), upload=False)
    h.free()
    cm = cm.cuda()
    qid, tid = cm[0], cm[3]
    dest = full._owner_of(tid, block_size(d.n_seq, 8), 8, qid != tid)
    pay = torch.stack([tid, cm[4], cm[5], cm[6]]).contiguous()
    cases = {("cases", "ecoli_8way"): ((rt.Layout(dest, 8), pay), {})}
    skew = np.random.default_rng(SEED).zipf(1.3, dest.numel()) - 1
    skew = torch.from_numpy(np.minimum(skew, 1024).astype(np.int32)).cuda()
    cases[("cases", "skewed_1024")] = ((rt.Layout(skew, 1024), pay), {})
    for k in range(MH_PROCS):
        x = torch.load(os.path.join(mdir, "p%d.json.route.pt" % k))
        cases[("cases", "multihost_rank%d_repart" % k)] = (
            (rt.Layout(x["dest"].cuda(), x["n_sh"]), x["payload"].cuda()),
            {})
    return {"route": cases}


# ---------------------------------------------------------------------------
# the tool surfaces: the graft entry, the panel, the dry run, scaling and
# the host tools

def _entry_card():
    """The graft entry's forward step on the card, its launches counted
    (run among the recorders: its K2, K5 and K6 calls join the kernel
    phase as cases of their rows)."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.eval import dryrun

    with contextlib.redirect_stderr(io.StringIO()):
        fwd, (cm,) = dryrun.entry(device="cuda")
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.time()
    got = fwd(cm)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = cuda.launch_counts()
    expect = {k: 0 for k in launches}
    expect.update(sweep=1, hit_cut=1, hit2arc=1)
    _check_launches("dryrun_entry", launches, expect)
    return got, {"wall_s": dt, "launches": launches,
                 "columns": cm.shape[1]}


def _entry_device() -> dict:
    """The forward step's device events by torch.profiler, after the L2
    flush and without it: the kernels of the whole step, the tail after
    K5 (which must be K6 alone) and its device ms, beside K6's latency
    floor in its grid; printed as the [entry] line with the card's name
    and power limit.  Run after the kernel phase: its sessions, made
    among the runs, left the kernel phase's later sessions of K6 alone
    without most of K6's events."""
    from miniasm_tpu_torch.eval import dryrun

    with contextlib.redirect_stderr(io.StringIO()):
        fwd, (cm,) = dryrun.entry(device="cuda")
    step = lambda: fwd(cm)  # noqa: E731
    T = step()[5].shape[0]
    out = {"card": _smi()}
    for flush in (True, False):
        seq = _device_sequence(step, 20, flush)
        k5 = [i for i, (name, _ms) in enumerate(seq)
              if "hit_cut_kernel" in name]
        tail = seq[k5[0] + 1:] if len(k5) == 1 else []
        if len(tail) != 1 or "hit2arc_kernel" not in tail[0][0]:
            _fail("dryrun_entry: the step after K5 ran %s, not K6 alone"
                  % [_short(name) for name, _ms in tail])
        out["flushed" if flush else "unflushed"] = {
            "kernels": sum(1 for name, _ms in seq
                           if not name.startswith(("Memset", "Memcpy"))),
            "events": len(seq), "device_ms": sum(ms for _n, ms in seq),
            "tail_events": len(tail), "tail_device_ms": tail[0][1]}
    f = _hit2arc_floor(cm.shape[1], T)
    out["k6_floor_device_ms"] = _device_ms(f, 20)
    out["k6_floor_device_ms_unflushed"] = _device_ms(f, 20, flush=False)
    _say("[entry] %s" % json.dumps(out))
    return out


def _entry_check(got, info) -> dict:
    """The card's forward step against the same step on the CPU (the plain
    versions), bit for bit on every column."""
    from miniasm_tpu_torch.eval import dryrun

    with contextlib.redirect_stderr(io.StringIO()):
        pfwd, (pcm,) = dryrun.entry(device="cpu")
    t0 = time.time()
    want = pfwd(pcm)
    info["cpu_wall_s"] = time.time() - t0
    names = ("good", "u", "v", "l", "ol", "sub_s", "sub_e", "sub_del")
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or not torch.equal(g.cpu(), w):
            _fail("dryrun_entry: %s differs between the card and the CPU"
                  % name)
    info["good"] = int(want[0].sum())
    if not info["good"]:
        _fail("dryrun_entry: no good arc")
    _say("[card] dryrun_entry: %.4f s (CPU %.4f s), %d columns, %d valid, "
         "%d good arcs, %d reads; launches %s; the eight outputs bit-equal "
         "to the CPU's" % (info["wall_s"], info["cpu_wall_s"],
                           info["columns"], int(pcm[9].sum()), info["good"],
                           want[5].shape[0], json.dumps(info["launches"])))
    return info


PANEL_QUICK = ("clean20x", "drop30", "circular")  # tests/test_panel.py:15


def _panel_phase() -> list:
    """Every PANEL member through run_one on the card and on the CPU: the
    result dicts equal and the GFAs (captured from pipeline.run) byte-
    equal; the QUICK members meet tests/test_panel.py's assertions; the
    10 Mb member launches as the noisy main path does (_NOISY)."""
    import hashlib

    from miniasm_tpu_torch import cuda, pipeline
    from miniasm_tpu_torch.eval import panel

    cap: dict = {}
    orig = pipeline.run

    def capture(paf, opt, **kw):
        t0 = time.time()
        r = orig(paf, opt, **kw)
        cap["assembly_s"] = time.time() - t0
        cap["gfa"] = kw["out"].getvalue()
        return r

    rows = []
    pipeline.run = capture
    try:
        for cfg in panel.PANEL:
            name = cfg[0]
            got = {}
            for device in ("cuda", "cpu"):
                cap.clear()
                cuda.reset_launches()
                t0 = time.time()
                with contextlib.redirect_stderr(io.StringIO()):
                    res = panel.run_one(*cfg, device=device)
                if device == "cuda":
                    torch.cuda.synchronize()
                dt = time.time() - t0
                if "gfa" not in cap:
                    _fail("panel %s: run_one did not call pipeline.run"
                          % name)
                got[device] = dict(res=res, gfa=cap["gfa"], wall_s=dt,
                                   assembly_s=cap["assembly_s"],
                                   launches=cuda.launch_counts())
            card, cpu = got["cuda"], got["cpu"]
            if card["res"] != cpu["res"]:
                _fail("panel %s: card %s, CPU %s" % (name, card["res"],
                                                     cpu["res"]))
            if card["gfa"] != cpu["gfa"]:
                _fail("panel %s: card and CPU GFAs differ" % name)
            want = dict(_NOISY) if name == "10Mb-drop40" else dict(
                _MAIN, cut_hit2arc=2, sweep=2, trans_multi=">0",
                bubble_bfs="any", decode3="any", unpack4="any")
            _check_launches("panel " + name, card["launches"], want)
            r = card["res"]
            if name in PANEL_QUICK and not (
                    r["unitigs"] == 1 and r["layout_errors"] == 0
                    and r["reads_in_layout"] > 20):
                _fail("panel %s fails tests/test_panel.py's assertions: %s"
                      % (name, r))
            row = {"dataset": name, "config": list(cfg), "result": r,
                   "gfa_bytes": len(card["gfa"]),
                   "gfa_sha256": hashlib.sha256(
                       card["gfa"].encode()).hexdigest(),
                   "card_wall_s": card["wall_s"],
                   "card_assembly_s": card["assembly_s"],
                   "cpu_wall_s": cpu["wall_s"],
                   "cpu_assembly_s": cpu["assembly_s"],
                   "launches": card["launches"]}
            _say("[panel] %s: run_one card %.3f s (pipeline.run %.3f s), "
                 "CPU %.3f s (%.3f s); %s; GFA %d bytes, sha256 %s, equal on "
                 "both; launches %s"
                 % (name, card["wall_s"], card["assembly_s"], cpu["wall_s"],
                    cpu["assembly_s"], json.dumps(r), row["gfa_bytes"],
                    row["gfa_sha256"][:16], json.dumps(card["launches"])))
            rows.append(row)
    finally:
        pipeline.run = orig
    return rows


def _dryrun_phase(ddir: str) -> dict:
    """dryrun_multichip on a one-rank NCCL group and on two gloo ranks on
    the one card (each asserts its sharded GFA equals its single-card run
    and prints its line), both GFAs held to the CPU single run."""
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.eval import dryrun
    from miniasm_tpu_torch.pipeline import run

    paf = os.path.join(ddir, "dryrun.paf")
    dryrun.dryrun_paf(paf)
    want = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(io.StringIO()):
        run(paf, Opt(), out=want, device="cpu")
    out = {"cpu_single_wall_s": time.time() - t0,
           "gfa_bytes": len(want.getvalue())}
    for tag, n, backend in (("dryrun_nccl_1", 1, None),
                            ("dryrun_gloo_2", 2, "gloo")):
        t0 = time.time()
        gfa = dryrun.dryrun_multichip(n, backend=backend)
        dt = time.time() - t0
        if gfa != want.getvalue():
            _fail("%s: the GFA differs from the CPU single run" % tag)
        _say("[card] %s: %.3f s from launch to exit (spawn, group init, "
             "rank 0's single-card run, run_sharded on every rank); GFA %d "
             "bytes, the CPU single run's (%.3f s)"
             % (tag, dt, len(gfa), out["cpu_single_wall_s"]))
        out[tag] = {"wall_s": dt, "ranks": n,
                    "backend": backend or "nccl"}
    return out


def _scaling_phase(paf: str) -> dict:
    """measure on the clean PAF at 1 and 2 ranks on the card (NCCL at 1,
    gloo at 2), printed as one line; the CPU run of the same call (one
    round, gloo) gives the same keys and overlap count."""
    from miniasm_tpu_torch.eval.scaling import measure

    t0 = time.time()
    r = measure(paf, [1, 2])
    dt = time.time() - t0
    _say("[scaling] %s" % json.dumps(r))
    t0 = time.time()
    c = measure(paf, [1, 2], repeats=1, device="cpu")
    cpu_dt = time.time() - t0
    if set(c) != set(r) or c["overlaps"] != r["overlaps"]:
        _fail("scaling: the CPU run gives other keys or overlaps (%s, %s)"
              % (sorted(c), c["overlaps"]))
    _say("[scaling] %.3f s on the card (3 rounds), %.3f s on the CPU (1 "
         "round): %d overlaps on both; CPU overlaps/s %s"
         % (dt, cpu_dt, r["overlaps"], json.dumps(c["overlaps_per_s"])))
    return {"card": r, "cpu": c, "wall_s": dt, "cpu_wall_s": cpu_dt}


def _tools_phase(paf: str, fa: str, sim, ddir: str) -> dict:
    """The host tools where there is no jax: minidot and paf2mhap on the
    clean PAF, paftop and ref2ovlp on the simulator's truth mapping (by
    name, and by reference position); each one's wall, output bytes and
    sha256."""
    import hashlib

    from miniasm_tpu_torch import dotter
    from miniasm_tpu_torch.eval import panel, ref2ovlp
    from miniasm_tpu_torch.interop import paf2mhap, paftop

    rows = panel.truth_paf(sim).splitlines(True)
    truth = os.path.join(ddir, "truth.paf")
    truth_pos = os.path.join(ddir, "truth_pos.paf")
    with open(truth, "w") as f:
        f.writelines(rows)
    with open(truth_pos, "w") as f:
        f.writelines(sorted(rows, key=lambda r: int(r.split("\t")[7])))
    jobs = [("minidot", dotter.main, [paf]),
            ("paf2mhap", paf2mhap.main, [fa, paf]),
            ("paftop", paftop.main, [truth]),
            ("ref2ovlp", ref2ovlp.main, [truth_pos])]
    out = {}
    for name, fn, argv in jobs:
        buf, err = io.StringIO(), io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = fn(argv)
        dt = time.time() - t0
        text = buf.getvalue().encode()
        if rc != 0 or not text:
            sys.stderr.write(err.getvalue()[-2000:])
            _fail("%s exited %d with %d bytes" % (name, rc, len(text)))
        out[name] = {"wall_s": dt, "bytes": len(text),
                     "sha256": hashlib.sha256(text).hexdigest()}
        _say("[tools] %s %s: %.3f s, %d bytes, sha256 %s"
             % (name, " ".join(os.path.basename(a) for a in argv), dt,
                len(text), out[name]["sha256"]))
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the run switches: the v2 loader, the timing lines, the profiler trace,
# the Python streams, and the fuzz

# (tag, flags, input, the default-loader run of the plan it must equal)
V2_RUNS = [("ecoli_v2_ug", ["-p", "ug"], "clean", "ecoli_ug"),
           ("noisy_v2_ug", ["-p", "ug"], "noisy", "noisy_ug"),
           ("noisy_v2_sg", ["-p", "sg"], "noisy", "noisy_sg"),
           ("ecoli_v2_bed", ["-p", "bed"], "clean", "ecoli_bed"),
           ("noisy_v2_paf", ["-p", "paf"], "noisy", "noisy_paf")]
TICK_LINE = r"^\[T::([^\]]+)\] \+(\d+\.\d{3})$"
# the device functions of each kernel, as a trace names them
DEVICE_FUNCS = {"cut_hit2arc": ("cut_hit2arc_kernel",),
                "sweep": ("ev_count_kernel", "ev_alloc_kernel",
                          "ev_scatter_kernel", "ev_sweep_warp_kernel",
                          "ev_sweep_big_kernel"),
                "trans_multi": ("trans_multi_kernel",),
                "bubble_bfs": ("bubble_bfs_kernel",),
                "decode3": ("decode3_kernel",),
                "unpack4": ("unpack4_kernel",),
                "read_marks": ("read_marks_kernel",),
                "arc_order": ("arc_order_kernel",),
                "clean_stage_b": ("clean_stage_b_kernel",)}
# the kernels each profiled run must show in its trace
_TAILS = ("arc_order", "clean_stage_b")
PROFILED = {"noisy_ug": ("cut_hit2arc", "sweep", "trans_multi",
                         "bubble_bfs", "decode3", "unpack4") + _TAILS,
            "ecoli_ug": ("cut_hit2arc", "sweep", "trans_multi", "decode3",
                         "unpack4") + _TAILS}
FUZZ_CASES = 8


def _stage_line(stages) -> str:
    return ", ".join("%s %.3f" % (k, v) for k, v in stages.items()
                     if not k.startswith("trace."))


def _v2_phase(inputs: dict, runs: dict) -> None:
    """Each V2_RUNS run on the card and on the CPU under
    MINIASM_TPU_LOADER=v2: both print the bytes of the default-loader run
    of the plan, and the card run launches as EXPECT says."""
    v2 = {"MINIASM_TPU_LOADER": "v2"}
    for tag, flags, data, twin in V2_RUNS:
        args = flags + [inputs[data]]
        out, err, dt, stages, launches = _cli(args, "cuda", env=v2)
        _check_launches(tag, launches)
        if out != runs[twin]["out"]:
            _fail("%s printed other bytes than %s" % (tag, twin))
        cpu_out, _, cpu_dt, _, _ = _cli(args, "cpu", env=v2)
        if cpu_out != out:
            _fail("%s: card and CPU outputs differ" % tag)
        runs[tag] = {"wall_s": dt, "stages": stages, "out": out,
                     "launches": launches, "cpu_wall_s": cpu_dt,
                     "path": "v2", "twin": twin}
        _say("[v2] %s: %.3f s (%s %.3f s), CPU %.3f s, stdout = %s's and "
             "the CPU run's; launches %s; stages %s; %s stages %s"
             % (tag, dt, twin, runs[twin]["wall_s"], cpu_dt, twin,
                json.dumps(launches), _stage_line(stages), twin,
                _stage_line(runs[twin]["stages"])))


def _timing_phase(paf: str, runs: dict) -> dict:
    """MINIASM_TPU_TIMING=1 on ecoli_ug: one [T::<stage>] +s line per
    stage of LAST_TIMING, in its order and at its times, and the run's
    bytes."""
    import re

    out, err, dt, stages, launches = _cli(
        ["-p", "ug", paf], "cuda", env={"MINIASM_TPU_TIMING": "1"})
    _check_launches("ecoli_ug_timing", launches, EXPECT["ecoli_ug"])
    if out != runs["ecoli_ug"]["out"]:
        _fail("ecoli_ug_timing printed other bytes than ecoli_ug")
    ticks = [re.match(TICK_LINE, ln) for ln in err.splitlines()
             if ln.startswith("[T::")]
    names = [k for k in stages if not k.startswith("trace.")]
    if not ticks or not all(ticks) \
            or [m.group(1) for m in ticks] != names \
            or [m.group(2) for m in ticks] != ["%.3f" % stages[k]
                                               for k in names]:
        _fail("ecoli_ug_timing: [T::] lines %r, LAST_TIMING %r"
              % ([ln for ln in err.splitlines() if ln.startswith("[T::")],
                 names))
    _say("[timing] ecoli_ug: %.3f s, %d [T::] lines = LAST_TIMING: %s"
         % (dt, len(ticks), "; ".join(m.group(0) for m in ticks)))
    return {"wall_s": dt, "lines": [m.group(0) for m in ticks]}


def _busy_share(events) -> dict:
    """The device's busy share of a profiled run: the union of its
    kernel, memcpy and memset intervals over the run's window (from the
    first stage range's start to the last one's end), the idle share,
    and the three longest idle gaps, each named by the innermost span
    range around its middle (`span:<path>`, the recorder's, which
    MINIASM_TPU_PROFILE switches on), else by the stage range there."""
    marks = [e for e in events if e.get("cat") == "user_annotation"]
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"][6:])
                    for e in marks
                    if str(e.get("name", "")).startswith("stage:"))
    inner = [(e["ts"], e["ts"] + e["dur"], e["name"][5:]) for e in marks
             if str(e.get("name", "")).startswith("span:")]
    if not stages:
        _fail("the trace holds no stage: range")
    w0, w1 = stages[0][0], max(s[1] for s in stages)
    spans = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    busy, gaps, end = 0.0, [], w0
    for a, b in spans:
        if a > end:
            gaps.append((a - end, end))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((w1 - end, end))

    def holder(t):
        held = [s for s in inner if s[0] <= t <= s[1]]
        if held:
            return min(held, key=lambda s: s[1] - s[0])[2]
        return next((n for a, b, n in stages if a <= t <= b),
                    "(between stages)")

    top = sorted(gaps, reverse=True)[:3]
    window = w1 - w0
    return {"window_s": window / 1e6, "busy_s": busy / 1e6,
            "busy_share": busy / window, "idle_share": 1 - busy / window,
            "device_intervals": len(spans),
            "gaps": [{"ms": g / 1e3, "stage": holder(t + g / 2)}
                     for g, t in top]}


# one process of the profile phase: a first run, which loads the CUDA
# libraries and kernels, then the profiled run (the CLI under
# MINIASM_TPU_PROFILE, as a user runs it)
_PROFILE_PROC = """
import contextlib, io, json, os, sys, time
import torch
from miniasm_tpu_torch import cli, cuda, pipeline
src, pdir, res = sys.argv[1:]
runs = []
for prof in (None, pdir):
    if prof:
        os.environ["MINIASM_TPU_PROFILE"] = prof
    cuda.reset_launches()
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli.main(["-p", "ug", src])
    torch.cuda.synchronize()
    runs.append({"rc": rc, "out": buf.getvalue(), "err": err.getvalue(),
                 "wall_s": time.time() - t0,
                 "launches": cuda.launch_counts(),
                 "stages": dict(pipeline.LAST_TIMING)})
with open(res, "w") as f:
    json.dump(runs, f)
"""


def _profile_phase(inputs: dict, ddir: str, runs: dict) -> dict:
    """MINIASM_TPU_PROFILE on noisy_ug and on ecoli_ug, each the second
    run of a process of its own (a profiler in this process, after the
    runs above, recorded no K9 launch of the loader's side stream): the
    run's bytes, JAX's stderr line, a trace that loads and holds
    PROFILED's kernels by name, and the device's busy and idle share
    over the run."""
    from miniasm_tpu_torch.device import ENV

    env = dict(os.environ)
    env.pop(ENV, None)  # the card
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    report = {}
    for tag, data in (("noisy_ug", "noisy"), ("ecoli_ug", "clean")):
        pdir = os.path.join(ddir, "profile_" + tag)
        shutil.rmtree(pdir, ignore_errors=True)
        res = pdir + ".json"
        r = subprocess.run([sys.executable, "-c", _PROFILE_PROC,
                            inputs[data], pdir, res], cwd=HERE, env=env,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-3000:])
            _fail("%s_profile: the process exited %d" % (tag, r.returncode))
        with open(res) as f:
            first, prof = json.load(f)
        for k, run in (("first", first), ("profile", prof)):
            if run["rc"] != 0 or run["out"] != runs[tag]["out"]:
                _fail("%s_profile: the %s run printed other bytes than %s"
                      % (tag, k, tag))
            # a kernel whose module the process never imported never ran
            _check_launches("%s_%s" % (tag, k),
                            dict(dict.fromkeys(EXPECT[tag], 0),
                                 **run["launches"]), EXPECT[tag])
        if "[M::main] profiler trace written to %s\n" % pdir \
                not in prof["err"]:
            _fail("%s_profile: no 'profiler trace written' line" % tag)
        t0 = time.time()
        with open(os.path.join(pdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        funcs = {}
        for e in events:
            if e.get("cat") == "kernel":
                funcs[e["name"]] = funcs.get(e["name"], 0) + 1
        seen = {}
        for k in PROFILED[tag]:
            seen[k] = sum(n for f, n in funcs.items()
                          if any(d in f for d in DEVICE_FUNCS[k]))
            if not seen[k]:
                _fail("%s_profile: the trace holds no %s kernel (it holds "
                      "%s)" % (tag, k, sorted(f[:60] for f in funcs)))
        share = _busy_share(events)
        share.update(wall_s=prof["wall_s"], first_wall_s=first["wall_s"],
                     trace_bytes=os.path.getsize(
                         os.path.join(pdir, "trace.json")),
                     kernel_events=seen, parse_s=time.time() - t0,
                     stages=prof["stages"], first_stages=first["stages"])
        _say("[profile] %s: %.3f s with the profiler (the process's first "
             "run %.3f s, without it), trace %d bytes; kernel events %s; "
             "window %.4f s, device busy %.4f s: busy share %.4f, idle share "
             "%.4f; longest idle gaps %s; stages %s"
             % (tag, prof["wall_s"], first["wall_s"], share["trace_bytes"],
                json.dumps(seen), share["window_s"], share["busy_s"],
                share["busy_share"], share["idle_share"],
                json.dumps(share["gaps"]), _stage_line(prof["stages"])))
        report[tag] = share
    return report


def _fuzz_phase() -> dict:
    """FUZZ_CASES seeded cases of eval/fuzz.py, each on the card against
    the port on the CPU."""
    from miniasm_tpu_torch.eval import fuzz

    rng = random.Random(SEED)
    t0 = time.time()
    recs = []
    for k in range(FUZZ_CASES):
        rec = fuzz.run_case(fuzz.draw_case(rng), "cuda")
        recs.append(rec)
        _say("[fuzz] case %d: %s" % (k, json.dumps(rec)))
        if not rec["ok"]:
            _fail("fuzz case %d: card and CPU differ: %s" % (k, rec))
    dt = time.time() - t0
    _say("[fuzz] %d cases, each card = CPU, %.3f s" % (FUZZ_CASES, dt))
    return {"cases": recs, "seconds": dt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome", type=int, default=ECOLI_BP)
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    a = ap.parse_args(argv)

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this run needs a GPU")
    if not os.path.isfile(os.path.join(HERE, "miniasm_tpu_torch",
                                       "__init__.py")):
        _fail("miniasm_tpu_torch/ is not beside this script: run it from "
              "a checkout of the repository")
    sys.path.insert(0, HERE)
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.core import hit2arc as h2a
    from miniasm_tpu_torch.eval.simulate import simulate, write_fasta, \
        write_paf
    from miniasm_tpu_torch.graph import clean, devbub, devclean
    from miniasm_tpu_torch.io.native import pafload
    from miniasm_tpu_torch.io.native.build import get_lib
    from miniasm_tpu_torch.parallel import full as pfull, group
    from miniasm_tpu_torch.select import cut, filter as flt, fused2
    from miniasm_tpu_torch.utils import compact as kc

    if a.genome == ECOLI_BP:
        for (tag, name), want in AT_ECOLI.items():
            EXPECT[tag][name] = want
        for k in ("trans_multi", "clean_stage_b"):
            MH_EXPECT[0][k] = 19
        MH_EXPECT[0]["bubble_bfs"] = 11
    report: dict = {}
    smi = _smi()
    _say(smi)
    kind = torch.cuda.get_device_name(0)
    _say("torch %s, CUDA %s, python %s, device %s"
         % (torch.__version__, torch.version.cuda, sys.version.split()[0],
            kind))

    # --- 1. build ---
    t0 = time.time()
    get_lib()
    t_native = time.time() - t0
    t_nvcc = cuda.build()
    _say("[build] host loader %.2f s, CUDA kernels %.2f s (%s)"
         % (t_native, t_nvcc, ", ".join(cuda.sources())))
    for src, log in sorted(cuda.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                _say("[ptxas %s] %s" % (src, line.strip()))
    report["build_s"] = {"native": t_native, "nvcc": t_nvcc}

    # --- 2. data ---
    if a.genome < ECOLI_BP:
        _say("[data] NOTE: genome of %d bp, below E. coli's %d: a quick "
             "check, not the measured size" % (a.genome, ECOLI_BP))
    t0 = time.time()
    ddir = os.path.join(HERE, "build", "smoke")
    os.makedirs(ddir, exist_ok=True)
    paf = os.path.join(ddir, "ecoli_%d.paf" % a.genome)
    noisy = os.path.join(ddir, "ecoli_%d_noisy.paf" % a.genome)
    fa = os.path.join(ddir, "ecoli_%d.fa" % a.genome)
    sim = simulate(genome_len=a.genome, coverage=COVERAGE,
                   mean_read=MEAN_READ, sd_read=SD_READ, seed=SEED)
    n_lines = write_paf(sim, paf)
    write_fasta(sim, fa)
    rng = random.Random(36)
    n_noisy = 0
    with open(paf) as f, open(noisy, "w") as g:
        for line in f:
            if rng.random() > 0.50:
                g.write(line)
                n_noisy += 1
    # the loader's format switches: the clean PAF's lines shuffled, as a
    # PAF sorted by target or merged from several runs comes (no query
    # runs), and with one overlap of two 90 kb reads appended, as an
    # ultra-long read gives (coordinates beyond 16 bits at the end)
    shuffled = os.path.join(ddir, "ecoli_%d_shuffled.paf" % a.genome)
    longp = os.path.join(ddir, "ecoli_%d_long.paf" % a.genome)
    with open(paf) as f:
        lines = f.readlines()
    with open(longp, "w") as g:
        g.writelines(lines)
        g.write("ultralong_a\t90000\t10\t89000\t+\tultralong_b\t90000\t"
                "1000\t89990\t85000\t88990\t255\n")
    random.Random(36).shuffle(lines)
    with open(shuffled, "w") as g:
        g.writelines(lines)
    del lines
    snap = {d: os.path.join(ddir, "snapshot_" + d) for d in ("cuda", "cpu")}
    for d in snap.values():
        shutil.rmtree(d, ignore_errors=True)
    _say("[data] %d reads, %d PAF lines (%.1f MB), noisy %d lines, reads "
         "FASTA %.1f MB, shuffled and long PAFs, %.2f s"
         % (len(sim["names"]), n_lines, os.path.getsize(paf) / 1e6,
            n_noisy, os.path.getsize(fa) / 1e6, time.time() - t0))
    report["data"] = {"genome_bp": a.genome, "coverage": COVERAGE,
                      "reads": len(sim["names"]), "paf_lines": n_lines,
                      "noisy_lines": n_noisy,
                      "fasta_bytes": os.path.getsize(fa)}
    # (tag, arguments, MINIASM_TPU_CLEAN, path): a cold run (first use of
    # every CUDA library), three warm runs of the clean set for the
    # spread, the noisy set, -p sg and bed; the staged path: -1 (pass 2 +
    # containment), -2 (pass 1), -1 -2 (no selection: the graph of every
    # read), -S 4 (both passes, no containment) and -1 -p paf; the oracle
    # clean modes; -f and -R on the main and the staged path; the main
    # path's -p paf, a snapshot written and restored, and the loader's
    # 4-row and 7-row switches
    plan = [("ecoli_ug_cold", ["-p", "ug", paf], "hybrid", "main"),
            ("ecoli_ug", ["-p", "ug", paf], "hybrid", "main"),
            ("ecoli_ug_2", ["-p", "ug", paf], "hybrid", "main"),
            ("ecoli_ug_3", ["-p", "ug", paf], "hybrid", "main"),
            ("noisy_ug", ["-p", "ug", noisy], "hybrid", "main"),
            ("noisy_sg", ["-p", "sg", noisy], "hybrid", "main"),
            ("ecoli_bed", ["-p", "bed", paf], "hybrid", "main"),
            ("ecoli_s1_ug", ["-1", "-p", "ug", paf], "hybrid", "staged"),
            ("noisy_s2_ug", ["-2", "-p", "ug", noisy], "hybrid", "staged"),
            ("noisy_s12_sg", ["-1", "-2", "-p", "sg", noisy], "hybrid",
             "staged"),
            ("ecoli_S4_bed", ["-S", "4", "-p", "bed", paf], "hybrid",
             "staged"),
            ("noisy_s1_paf", ["-1", "-p", "paf", noisy], "hybrid", "staged"),
            ("noisy_native_ug", ["-p", "ug", noisy], "native", "oracle"),
            ("noisy_py_sg", ["-p", "sg", noisy], "py", "oracle"),
            ("ecoli_f_ug", ["-f", fa, "-p", "ug", paf], "hybrid", "flags"),
            ("noisy_R_ug", ["-R", "-p", "ug", noisy], "hybrid", "flags"),
            ("noisy_s1_R_f_ug", ["-1", "-R", "-f", fa, "-p", "ug", noisy],
             "hybrid", "flags"),
            ("ecoli_paf", ["-p", "paf", paf], "hybrid", "paf"),
            ("noisy_paf", ["-p", "paf", noisy], "hybrid", "paf"),
            ("ecoli_snap_ug", ["-p", "ug", paf], "hybrid", "snapshot"),
            ("ecoli_snap_ug_restore", ["-p", "ug", paf], "hybrid",
             "snapshot"),
            ("shuffled_ug", ["-p", "ug", shuffled], "hybrid", "loader"),
            ("long_ug", ["-p", "ug", longp], "hybrid", "loader")]
    # an oracle run prints the bytes of the hybrid run it stands beside,
    # and so do the snapshot runs
    same_as = {"noisy_native_ug": "noisy_ug", "noisy_py_sg": "noisy_sg",
               "ecoli_snap_ug": "ecoli_ug",
               "ecoli_snap_ug_restore": "ecoli_ug",
               "sharded_ug": "ecoli_ug", "sharded_ug_2": "ecoli_ug",
               "sharded_ug_3": "ecoli_ug", "sharded_noisy_ug": "noisy_ug"}
    # the sharded runs (a one-rank group: NCCL on the card, gloo on the
    # CPU), each printing the bytes of its -p ug run; the clean set three
    # times for the spread, the repeats on the card only
    sharded = [("sharded_ug", paf), ("sharded_ug_2", paf),
               ("sharded_ug_3", paf), ("sharded_noisy_ug", noisy)]
    rdv = os.path.join(ddir, "rendezvous")

    def snapshot_of(tag, device):
        return snap[device] if tag.startswith("ecoli_snap") else None

    def check_restore(tag, err):
        # the first snapshot run writes, the second restores
        restored = "Steps 1-3 restored from snapshot" in err
        if restored != tag.endswith("_restore"):
            _fail("%s: %s" % (tag, "restored" if restored
                               else "did not restore"))

    # --- 3. every run on the card ---
    # K3 keeps a row of arcs (3 int32 each) in shared memory
    k3_row_limit = cuda.SMEM_MAX // 12

    def on_path(variant):
        # record each call under the path of the run that made it
        return lambda a_, k: (PATH["now"], variant(a_, k))

    # K3 and K4 also keep every call of noisy_ug, whose shapes the kernel
    # phase reads
    k3 = Recorder(devclean, "trans_multi", on_path(
                      lambda a_, k: "trans" if a_[6] else "multi"),
                  stat_fn=lambda a_, k: a_[4],  # D: the largest row
                  log_tag="noisy_ug")
    recs = [Recorder(fused2, "cut_hit2arc", on_path(
                lambda a_, k: "final" if k["final_pass"] else "relaxed")),
            Recorder(fused2, "sweep_events", on_path(
                lambda a_, k: "fine" if a_[4] else "crude"), kernel="sweep"),
            k3,
            Recorder(devbub, "bubble_bfs", on_path(
                lambda a_, k: "K%d" % a_[6]), log_tag="noisy_ug"),
            Recorder(cut, "hit_cut", on_path(lambda a_, k: "all")),
            Recorder(h2a, "hit2arc_tail", on_path(lambda a_, k: "all"),
                     kernel="hit2arc"),
            # del_asymm_mask calls K7 by clean's name for it
            Recorder(clean, "key_member", on_path(lambda a_, k: "all"),
                     size_fn=lambda a_, k: a_[2][0].numel()),
            Recorder(clean, "dup_mark", on_path(lambda a_, k: "all")),
            Recorder(pafload, "decode3", on_path(lambda a_, k: "all")),
            # the largest load on the card: the most records unpacked (the
            # sharded paths' host load runs the plain version: not kept)
            Recorder(pafload, "unpack4", on_path(lambda a_, k: "all"),
                     size_fn=lambda a_, k: sum(n for _d, n in a_[0]),
                     when=lambda a_, k: any(d.is_cuda for d, _n in a_[0])),
            # K11: the largest call of each run
            Recorder(pfull, "route", on_path(lambda a_, k: PATH["tag"])),
            # K12 (the main path's and the sharded step's), K13; K14:
            # the largest detection
            Recorder(fused2, "read_marks", on_path(lambda a_, k: "all")),
            Recorder(fused2, "arc_order", on_path(lambda a_, k: "all")),
            Recorder(devclean, "clean_stage_b", on_path(lambda a_, k: "all")),
            # K16 by its kind of call (the cuts and the take, the trim
            # table, the remapped hits, the arcs)
            Recorder(kc, "compact", on_path(_compact_kind),
                     size_fn=lambda a_, k: sum(
                         r.numel() for r in _compact_args(a_, k)[0])),
            Recorder(flt, "hit_flt_sums", on_path(lambda a_, k: "all"),
                     kernel="hit_flt"),
            Recorder(h2a, "hit_marks", on_path(lambda a_, k: a_[1])),
            Recorder(pfull, "shard_arcs", on_path(lambda a_, k: "all"))]
    runs = {}
    with contextlib.ExitStack() as st:
        for r in recs:
            st.enter_context(r)
        for tag, args, mode, path in plan:
            k3.stat = 0
            PATH["now"], PATH["tag"] = path, tag
            out, err, dt, stages, launches = _cli(
                args, "cuda", mode, snapshot_of(tag, "cuda"))
            if path == "snapshot":
                check_restore(tag, err)
            runs[tag] = {"wall_s": dt, "stages": stages, "out": out,
                         "launches": launches, "k3_max_row": k3.stat,
                         "clean": mode, "path": path}
            if args[args.index("-p") + 1] == "ug":
                runs[tag]["gfa"] = _gfa_summary(out)
            _say("[card] %s: %.3f s, %d bytes, %s; launches %s; K3 largest "
                 "row %d (limit %d); stages %s"
                 % (tag, dt, len(out), json.dumps(runs[tag].get("gfa")),
                    json.dumps(launches), k3.stat, k3_row_limit,
                    json.dumps(stages)))
            _check_launches(tag, launches)
            _check_detects(tag, launches, stages)
            if not out:
                _fail("%s printed nothing" % tag)
            if "-f" in args:
                _check_sequences(tag, out)
        g, t_group = _group("cuda", rdv)
        _say("[card] one-rank group: %s on %s, %.3f s (init and a first "
             "all_reduce)" % (g.backend, g.device, t_group))
        try:
            for tag, src in sharded:
                k3.stat = 0
                PATH["now"], PATH["tag"] = "sharded", tag
                out, err, dt, stages, launches = _sharded(src, "cuda")
                runs[tag] = {"wall_s": dt, "stages": stages, "out": out,
                             "launches": launches, "k3_max_row": k3.stat,
                             "clean": "hybrid", "path": "sharded",
                             "gfa": _gfa_summary(out)}
                _say("[card] %s: %.3f s, %d bytes, %s; launches %s; K3 "
                     "largest row %d; stages %s"
                     % (tag, dt, len(out), json.dumps(runs[tag]["gfa"]),
                        json.dumps(launches), k3.stat, json.dumps(stages)))
                _check_launches(tag, launches)
                _check_detects(tag, launches, stages)
        finally:
            group.destroy()
        PATH["now"], PATH["tag"] = "dryrun", "dryrun_entry"
        entry_out = _entry_card()
    report["group_init_s"] = t_group
    report["dryrun_entry"] = _entry_check(*entry_out)
    runs["dryrun_entry"] = {"launches": entry_out[1]["launches"],
                            "path": "dryrun"}

    # --- 3b. the multi-process worker: two processes on the one card,
    #     over gloo (NCCL refuses two ranks on one card) ---
    mh = _multihost(noisy, os.path.join(ddir, "multihost"))
    for k, st in enumerate(mh["stats"]):
        _say("[card] multihost_noisy_ug rank %d (%s, %s): launches %s; "
             "stages %s" % (k, st["device"], st["backend"],
                            json.dumps(st["launches"]),
                            json.dumps(st["stages_s"])))
        if sorted(st["launches"]) != sorted(cuda.launch_counts()):
            _fail("multihost_noisy_ug rank %d counts the kernels %s, the "
                  "package has %s" % (k, sorted(st["launches"]),
                                      sorted(cuda.launch_counts())))
        _check_launches("multihost_noisy_ug rank %d" % k, st["launches"],
                        MH_EXPECT[k])
    if mh["out"] != runs["noisy_ug"]["out"]:
        _fail("multihost_noisy_ug: rank 0 printed other bytes than noisy_ug")
    _say("[card] multihost_noisy_ug: 2 processes, %.3f s from start to "
         "exit; rank 0's GFA is noisy_ug's bytes" % mh["wall_s"])
    runs["multihost_noisy_ug"] = {"wall_s": mh["wall_s"],
                                  "stats": mh["stats"], "path": "multihost"}
    for tag in ("ecoli_ug", "ecoli_ug_2", "ecoli_ug_3"):
        if runs[tag]["out"] != runs["ecoli_ug_cold"]["out"]:
            _fail("two card runs on one input differ")
    for tag, ref in same_as.items():
        if runs[tag]["out"] != runs[ref]["out"]:
            _fail("%s printed other bytes than %s" % (tag, ref))
    for tag in ("ecoli_ug", "noisy_ug", "ecoli_s1_ug", "noisy_s2_ug",
                "shuffled_ug", "long_ug"):
        if runs[tag]["gfa"]["unitigs"] == 0:
            _fail("%s: no unitig in the output" % tag)
    longest = runs["ecoli_ug"]["gfa"]["longest_bp"]
    if longest < 0.5 * a.genome:
        _fail("the clean set's longest unitig is %d bp of a %d bp genome"
              % (longest, a.genome))

    # --- 4. kernels against their plain versions ---
    n_arcs = max((c[1][0].numel() for r in recs if r.kernel == "dup_mark"
                  for c in r.calls.values()), default=1 << 15)
    cases = dict(_sweep_cases(), **_decode3_cases(), **_symm_cases(n_arcs))
    cases.update(_route_cases(paf, os.path.join(ddir, "multihost")))
    rows = _kernel_phase(recs, runs, cases)
    report["dryrun_entry"]["device"] = _entry_device()

    # --- 5. the same commands on the CPU ---
    for tag, args, mode, path in plan:
        if tag in ("ecoli_ug_cold", "ecoli_ug_2", "ecoli_ug_3"):
            continue
        out, err, dt, _, _ = _cli(args, "cpu", mode, snapshot_of(tag, "cpu"))
        if path == "snapshot":
            check_restore(tag, err)
        same = out == runs[tag]["out"]
        _say("[cpu] %s: %.3f s, stdout %s the card's"
             % (tag, dt, "identical to" if same else "DIFFERS from"))
        runs[tag]["cpu_wall_s"] = dt
        if not same:
            _fail("%s: card and CPU outputs differ" % tag)
    g, _ = _group("cpu", rdv)
    try:
        for tag, src in sharded:
            if tag[-2:] in ("_2", "_3"):
                continue
            out, err, dt, _, _ = _sharded(src, "cpu")
            same = out == runs[tag]["out"]
            _say("[cpu] %s (%s): %.3f s, stdout %s the card's"
                 % (tag, g.backend, dt,
                    "identical to" if same else "DIFFERS from"))
            runs[tag]["cpu_wall_s"] = dt
            if not same:
                _fail("%s: card and CPU outputs differ" % tag)
    finally:
        group.destroy()

    # --- 6. the tool surfaces: the panel, the dry run, scaling, the tools ---
    report["panel"] = _panel_phase()
    report["dryrun"] = _dryrun_phase(ddir)
    report["scaling"] = _scaling_phase(paf)
    report["tools"] = _tools_phase(paf, fa, sim, ddir)

    # --- 7. the run switches and the fuzz ---
    inputs = {"clean": paf, "noisy": noisy}
    _v2_phase(inputs, runs)
    for row in rows:
        row["launches_noisy_v2_ug"] = runs["noisy_v2_ug"]["launches"].get(
            row["name"])
    report["timing"] = _timing_phase(paf, runs)
    report["profile"] = _profile_phase(inputs, ddir, runs)
    report["fuzz"] = _fuzz_phase()

    if a.json:
        for r in runs.values():
            r.pop("out", None)
        report.update({"card": smi, "kind": kind, "runs": runs,
                       "kernels": rows})
        os.makedirs(os.path.dirname(os.path.abspath(a.json)), exist_ok=True)
        with open(a.json, "w") as f:
            json.dump(report, f, indent=1)
    _say(smi)
    _say(json.dumps({"kernels": rows}))
    # the run used one card, whatever the machine holds
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
