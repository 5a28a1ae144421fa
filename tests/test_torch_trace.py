"""The port's trace recorder (utils/timers.py, pipeline.LAST_TRACE) on the
CPU:

- off (the default): a main-path run records no span and no counter, and
  its stdout is the JAX package's bytes;
- on: every span lies inside its parent and has a self time >= 0, the
  main path's spans appear under their stages, and the counters agree
  with what they count: load.records with the loader's n_orig,
  clean.detects with the calls of devclean.detect, clean.commits with the
  tips, internal sequences, bi-loops and bubbles the port's own stderr
  lines report;
- MINIASM_TPU_PROFILE: spans.json holds the run's record, and each
  `span:` range of trace.json is an in-memory span, in the same order, at
  the same duration (within 10% or 200 us, in one of three runs)."""

import json
import os
import re

import pytest
import torch

from conftest import run_ours
from miniasm_tpu_torch import cuda, pipeline
from miniasm_tpu_torch.graph import devclean
from miniasm_tpu_torch.io.native import pafload
from miniasm_tpu_torch.utils import timers
from test_torch_cli import run_port

# the main path's spans on the CPU (ring_wait and cold:<kernel> happen on
# a card only), as paths under the stage spans; `...` any passes between
MAIN_SPANS = ["load+upload/ring", "load+upload/parse_wait",
              "load+upload/push", "load+upload/colmat", "load+upload/seqdict",
              "select+fetch/enqueue", "select+fetch/fetch",
              "graph_build/cleanup", "clean/detect", "clean/trans",
              "clean/symm", "clean/cut_tip", "clean/cut_tip/cleanup",
              "clean/.../detect/build", "clean/.../detect/fetch",
              "clean/pop_bubble/dispatch", "clean/pop_bubble/commit",
              "clean/del_short", "clean/cut_internal", "clean/cut_biloop"]
# the stderr lines whose counts clean.commits sums (pop_bubble: the
# bubbles popped, not the tips trimmed)
COMMIT_LINES = re.compile(r"^\[M::(cut_tip|cut_internal|cut_biloop|"
                          r"pop_bubble)::[^\]]*\] (?:cut|popped) (\d+) ",
                          re.M)


def traced_run(args):
    """run_port with the recorder on; the switch restored after."""
    was = timers.tracing(True)
    try:
        return run_port(args)
    finally:
        timers.tracing(was)


@pytest.fixture(scope="module")
def noisy_traced(sim_noisy):
    """A recorded -p ug run of the noisy set: (stdout, stderr, record)."""
    rc, out, err = traced_run(["-p", "ug", sim_noisy["paf"]])
    assert rc == 0
    rec = pipeline.LAST_TRACE
    return out, err, {"run": rec.run, "spans": list(rec.spans),
                      "counters": dict(rec.counters),
                      "self": [rec.self_seconds(i)
                               for i in range(len(rec.spans))]}


@pytest.mark.parametrize("data", ["sim_small", "sim_noisy"])
def test_off_records_nothing(request, data):
    args = ["-p", "ug", request.getfixturevalue(data)["paf"]]
    assert timers.tracing(False) is False
    rc, got, _ = run_port(args)
    assert rc == 0 and got == run_ours(args) and got
    assert pipeline.LAST_TRACE.spans == []
    assert pipeline.LAST_TRACE.counters == {}
    assert pipeline.LAST_TRACE.run is None
    # a site outside a recording run costs the shared no-op context
    assert timers.span("x") is timers.span("y") is timers._NULL
    assert not timers.recording()


def test_on_prints_the_same_bytes(sim_noisy, noisy_traced):
    out, _, rec = noisy_traced
    assert out == run_ours(["-p", "ug", sim_noisy["paf"]])
    assert rec["run"] is not None
    # the switch is back off: the next run records nothing
    rc, _, _ = run_port(["-p", "ug", sim_noisy["paf"]])
    assert rc == 0 and pipeline.LAST_TRACE.spans == []


def test_children_inside_parents(noisy_traced):
    spans = noisy_traced[2]["spans"]
    assert spans and all(s.t1 is not None and s.t0 <= s.t1 for s in spans)
    for s in spans:
        if s.parent < 0:
            assert s.path == s.name and s.name in pipeline.LAST_TIMING
            continue
        p = spans[s.parent]
        assert p.t0 <= s.t0 and s.t1 <= p.t1
        assert s.path == p.path + "/" + s.name
    assert min(noisy_traced[2]["self"]) >= 0
    # the stages are the top-level spans, in the order they ran
    top = [s.name for s in spans if s.parent < 0]
    assert top == list(pipeline.LAST_TIMING)


@pytest.mark.parametrize("path", MAIN_SPANS)
def test_main_path_span(noisy_traced, path):
    pat = re.compile("^" + re.escape(path).replace(r"/\.\.\./", "/(.+/)?")
                     + "$")
    assert any(pat.match(s.path) for s in noisy_traced[2]["spans"]), path


def test_load_records_is_n_orig(sim_noisy, noisy_traced):
    *_, h = pafload.load_hits_mt(sim_noisy["paf"], 2000, 100)
    c = noisy_traced[2]["counters"]
    assert c["load.records"] == h.n_orig == c["select.hits"] > 0
    assert c["load.pieces"] >= 1 and c["load.format_switches"] == 0
    h.free()


def test_detects_counts_every_detection(sim_noisy, monkeypatch):
    calls = []
    real = devclean.detect

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(devclean, "detect", counting)
    rc, _, _ = traced_run(["-p", "ug", sim_noisy["paf"]])
    assert rc == 0 and len(calls) > 1
    assert pipeline.LAST_TRACE.counters["clean.detects"] == len(calls)
    n = sum(1 for s in pipeline.LAST_TRACE.spans if s.name == "detect")
    assert n == len(calls)


def test_commits_match_the_logged_counts(noisy_traced):
    _, err, rec = noisy_traced
    logged = [(k, int(n)) for k, n in COMMIT_LINES.findall(err)]
    assert {k for k, _ in logged} == {"cut_tip", "cut_internal",
                                      "cut_biloop", "pop_bubble"}
    c = rec["counters"]
    assert c["clean.commits"] == sum(n for _, n in logged) > 0
    assert c["clean.candidates"] >= c["clean.commits"]
    assert c["clean.bubble_recomputed"] >= 0


def test_launch_counts_copied_at_the_end():
    k = cuda.KERNELS[0]
    rec = timers.Trace()
    was = timers.tracing(True)
    try:
        with rec.recording():
            k.launches += 2
            timers.count("x.y", 3)
            timers.count("x.y")
    finally:
        timers.tracing(was)
        k.launches -= 2
    assert rec.counters == {"x.y": 4, "launches." + k.name: 2}
    timers.count("x.y")  # no run records: nothing changes
    assert rec.counters["x.y"] == 4


def _profiled(args, prof):
    """One run under MINIASM_TPU_PROFILE=prof: (rc, stdout, the run's
    spans below the stages as (path, us), the trace's `span:` ranges as
    (path, us) in the order they opened: a parent before a child of its
    start).  Checks that spans.json holds the run's record."""
    # one intra-op thread: torch's pool of threads, beside other test
    # processes, stalls a profiler range's entry or exit for a tick
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc, got, _ = run_port(args)
    finally:
        torch.set_num_threads(threads)
    assert timers.tracing(False) is False  # the switch was per run
    rec = pipeline.LAST_TRACE
    with open(os.path.join(prof, "spans.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rec.to_json()))
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted(((e["ts"], -e["dur"], e["name"][5:]) for e in events
                     if e.get("cat") == "user_annotation"
                     and str(e.get("name")).startswith("span:")))
    # the stages are their `stage:` ranges; every other span is a range
    mine = [(s.path, (s.t1 - s.t0) / 1e3) for s in rec.spans
            if s.parent >= 0]
    return rc, got, mine, [(p, -d) for _, d, p in ranges]


@pytest.mark.parametrize("path", ["main_ug", "main_paf"])
def test_profile_writes_spans(sim_noisy, tmp_path, monkeypatch, path):
    args = {"main_ug": ["-p", "ug"], "main_paf": ["-p", "paf"]}[path] \
        + [sim_noisy["paf"]]
    prof = str(tmp_path / "prof")
    monkeypatch.setenv("MINIASM_TPU_PROFILE", prof)
    runs = [_profiled(args, prof) for _ in range(3)]
    for rc, got, mine, ranges in runs:
        assert rc == 0 and got == runs[0][1]
        assert len(mine) > 5
        # the same spans every run, each a range by path and order
        assert [p for p, _ in ranges] == [p for p, _ in mine] \
            == [p for p, _ in runs[0][2]]
    assert runs[0][1] == run_ours(args)
    # Each span's two durations agree within 10% or 200 us in at least
    # one of the three runs: on a loaded CPU a scheduler tick (4 ms) can
    # land in the microseconds between the profiler's timestamp and the
    # recorder's clock read, and moves that span in that run alone; a
    # span that timed another interval would differ in every run.
    for i, (p, _) in enumerate(runs[0][2]):
        excess = [abs(r[3][i][1] - r[2][i][1]) - max(0.1 * r[2][i][1], 200)
                  for r in runs]
        assert min(excess) <= 0, (p, [(r[3][i][1], r[2][i][1])
                                      for r in runs])
