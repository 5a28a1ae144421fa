"""Wall/CPU timers and stage logging.

Equivalent of the reference's sys.c:7-46 (sys_realtime/sys_cputime/
sys_timestamp) and the `[M::stage::t*u]` stderr log convention used by every
pipeline pass. Log lines go to stderr only; stdout is reserved for data
(BED/PAF/GFA), matching the reference contract.
"""

from __future__ import annotations

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


def liftrlimit() -> None:
    """Lift the address-space rlimit (reference sys.c:24-31)."""
    try:
        import resource

        resource.setrlimit(resource.RLIMIT_AS, (resource.RLIM_INFINITY, resource.RLIM_INFINITY))
    except Exception:
        pass
