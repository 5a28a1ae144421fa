"""Wall/CPU timers and stage logging.

Equivalent of the reference's sys.c:7-46 (sys_realtime/sys_cputime/
sys_timestamp) and the `[M::stage::t*u]` stderr log convention used by every
pipeline pass. Log lines go to stderr only; stdout is reserved for data
(BED/PAF/GFA), matching the reference contract.

The port's trace recorder: `StageClock` times a run's stages, and a
`Trace` (pipeline.LAST_TRACE) records, while `tracing(True)` is set, each
stage and the `span`s opened inside it as nested intervals, and the run's
named integer counters (`count`).  Off, it records nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import time

_t0_real = time.time()
_t0_cpu = time.process_time()


def realtime() -> float:
    return time.time() - _t0_real


def cputime() -> float:
    return time.process_time() - _t0_cpu


def timestamp() -> str:
    rt = realtime()
    return "%.3f*%.2f" % (rt, (cputime() / rt) if rt > 0 else 0.0)


def log(stage: str, msg: str, *args) -> None:
    from .. import config

    if config.verbose >= 3:
        sys.stderr.write("[M::%s::%s] %s\n" % (stage, timestamp(), msg % args if args else msg))
        sys.stderr.flush()


class Span:
    """One timed interval of a run: its name, its path from the stage
    down (`load+upload/parse_wait`), the index of its parent in the run's
    list (-1 for a stage) and its ends on time.perf_counter_ns()."""

    __slots__ = ("name", "path", "parent", "t0", "t1")

    def __init__(self, name, path, parent, t0):
        self.name, self.path, self.parent, self.t0 = name, path, parent, t0
        self.t1 = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


class Trace:
    """The spans and named integer counters of one run, kept in memory and
    filled in place (pipeline.LAST_TRACE).  `with trace.recording():`
    scopes a run: the record is cleared, and filled only while tracing is
    on (`tracing`); at its end the run's launches of each hand kernel are
    counted as `launches.<kernel>`."""

    def __init__(self):
        self.run = None  # the run's identifier; None when not recorded
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._open: list[int] = []

    @contextlib.contextmanager
    def recording(self):
        global _cur
        self.spans.clear()
        self.counters.clear()
        self._open.clear()
        self.run = None
        if not _on:
            yield self
            return
        from .. import cuda

        self.run = "%d.%d" % (os.getpid(), next(_run_ids))
        before = cuda.launch_counts()
        prev, _cur = _cur, self
        try:
            yield self
        finally:
            _cur = prev
            for k, n in cuda.launch_counts().items():
                if n > before.get(k, 0):
                    self.counters["launches." + k] = n - before.get(k, 0)

    def self_seconds(self, i: int) -> float:
        """Span i's seconds less those of its children."""
        kids = sum(s.t1 - s.t0 for s in self.spans if s.parent == i)
        s = self.spans[i]
        return (s.t1 - s.t0 - kids) / 1e9

    def totals(self) -> dict:
        """Seconds by path, summed over the spans of each path."""
        out: dict = {}
        for s in self.spans:
            if s.t1 is not None:
                out[s.path] = out.get(s.path, 0.0) + s.seconds
        return out

    def to_json(self) -> dict:
        return {"run": self.run,
                "spans": [{"name": s.name, "path": s.path,
                           "parent": s.parent, "t0_ns": s.t0, "t1_ns": s.t1}
                          for s in self.spans],
                "counters": dict(self.counters)}


class _Span:
    """The context of one recorded span; all but a stage's are also a
    profiler range `span:<path>`, on the profiler trace's clock."""

    __slots__ = ("rec", "name", "ranged", "i", "rf")

    def __init__(self, rec: Trace, name: str, ranged: bool):
        self.rec, self.name, self.ranged = rec, name, ranged

    def __enter__(self):
        rec = self.rec
        parent = rec._open[-1] if rec._open else -1
        path = (self.name if parent < 0
                else rec.spans[parent].path + "/" + self.name)
        self.rf = None
        if self.ranged:
            import torch

            self.rf = torch.profiler.record_function("span:" + path)
            self.rf.__enter__()
        self.i = len(rec.spans)
        rec.spans.append(Span(self.name, path, parent, time.perf_counter_ns()))
        rec._open.append(self.i)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.spans[self.i].t1 = time.perf_counter_ns()
        rec._open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


# Tracing is off unless switched on: a span site then costs one check and
# the shared no-op context, a counter site one check.
_on = False
_cur: Trace | None = None  # the record of the run that records now
_NULL = contextlib.nullcontext()
_run_ids = itertools.count(1)


def tracing(on: bool) -> bool:
    """Record the spans and counters of the runs that start from now on
    (True) or not (False, the default); returns the previous setting.
    MINIASM_TPU_PROFILE switches it on for its run (cli.py)."""
    global _on
    prev, _on = _on, bool(on)
    return prev


def recording() -> bool:
    """Whether a run is recording now."""
    return _cur is not None


def span(name: str, ranged: bool = True):
    """`with span(name):` times the block as a child of the innermost open
    span of the recording run; a no-op when no run records."""
    rec = _cur
    return _NULL if rec is None else _Span(rec, name, ranged)


def count(name: str, n: int = 1) -> None:
    """Add n to the recording run's counter `name`.  Loops keep their
    counts in local integers and add them once a pass."""
    rec = _cur
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


class StageClock:
    """The cumulative stage clock of one run (pipeline.LAST_TIMING,
    parallel.full.LAST_TIMING, the worker's `stages_s` in
    parallel/multihost.py).  `with clock.stage(name):` runs one stage
    inside a profiler range `stage:<name>`, which a torch.profiler trace
    records (MINIASM_TPU_PROFILE) and which costs nothing otherwise, and,
    while a run records (Trace.recording), as its top-level span.  At
    the stage's end the card is synchronized, so that its device work
    ends inside the stage, and `timing[name]` is set to the seconds since
    the clock started.  With MINIASM_TPU_TIMING set, each end also writes
    `[T::<name>] +<s>` to stderr, the JAX package's line
    (pipeline.py:84-88)."""

    def __init__(self, timing: dict, dev):
        timing.clear()
        self.timing, self.dev = timing, dev
        self.echo = bool(os.environ.get("MINIASM_TPU_TIMING"))
        self.t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str):
        import torch

        with torch.profiler.record_function("stage:" + name), \
                span(name, ranged=False):
            yield
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        t = time.time() - self.t0
        self.timing[name] = t
        if self.echo:
            sys.stderr.write("[T::%s] +%.3f\n" % (name, t))


def liftrlimit() -> None:
    """Lift the address-space rlimit (reference sys.c:24-31)."""
    try:
        import resource

        resource.setrlimit(resource.RLIMIT_AS, (resource.RLIM_INFINITY, resource.RLIM_INFINITY))
    except Exception:
        pass
