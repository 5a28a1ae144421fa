"""Wall/CPU timers and stage logging.

Equivalent of the reference's sys.c:7-46 (sys_realtime/sys_cputime/
sys_timestamp) and the `[M::stage::t*u]` stderr log convention used by every
pipeline pass. Log lines go to stderr only; stdout is reserved for data
(BED/PAF/GFA), matching the reference contract.
"""

from __future__ import annotations

import contextlib
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


# Fine-grained attribution accumulator (device-kernel vs transfer vs host
# sub-costs inside a pipeline stage).  pipeline._run_fast_v2 clears it per
# run; bench.py reports it as "substages".  Keys accumulate seconds except
# *_n keys, which count events.
EXTRA: dict = {}


def add_extra(key: str, val: float) -> None:
    EXTRA[key] = round(EXTRA.get(key, 0.0) + val, 4)


class StageClock:
    """The cumulative stage clock of one run (pipeline.LAST_TIMING,
    parallel.full.LAST_TIMING, the worker's `stages_s` in
    parallel/multihost.py).  `with clock.stage(name):` runs one stage
    inside a profiler range `stage:<name>`, which a torch.profiler trace
    records (MINIASM_TPU_PROFILE) and which costs nothing otherwise.  At
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

        with torch.profiler.record_function("stage:" + name):
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
