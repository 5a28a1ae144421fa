"""Reading a torch.profiler trace of assemblies.

Each profiled assembly runs inside a `portbench:assembly` range; the
program marks each stage of an assembly as a `stage:<name>` range
(utils/timers.py StageClock), which ends after a synchronize, so the
device work of a stage lies inside its range.  `busy` is a copy of
chip_smoke.py's `_busy_share`: the union of the kernel, memcpy and memset
intervals over an assembly's stage window, and the idle gaps in it, each
named by the stage that holds its middle.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Assembly:
    """One profiled assembly: its stage ranges and its device events,
    times in microseconds."""

    def __init__(self, stages, device):
        self.stages = stages      # [(t0, t1, name)], sorted
        self.device = device      # [(t0, t1, cat, name)], sorted

    def stage(self, name):
        """The (t0, t1) of the named stage range, or None."""
        for a, b, n in self.stages:
            if n == name:
                return a, b
        return None

    def kernels_in(self, t0, t1):
        """The kernel events that start inside [t0, t1]."""
        return [e for e in self.device if e[2] == "kernel" and t0 <= e[0] <= t1]


def load(path):
    """The profiled assemblies of a chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == "portbench:assembly")
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"][6:])
                    for e in events if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("stage:"))
    device = sorted((e["ts"], e["ts"] + e["dur"], e["cat"], e["name"])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") in DEVICE_CATS)
    out = []
    for a, b in spans:
        st = [s for s in stages if a <= s[0] and s[1] <= b]
        if not st:
            continue
        w0, w1 = st[0][0], max(s[1] for s in st)
        dev = [d for d in device if d[0] < w1 and d[1] > w0]
        out.append(Assembly(st, dev))
    return out


def busy(asm: Assembly) -> dict:
    """The device's busy seconds over the assembly's stage window, the
    window, and the idle gaps as (seconds, stage)."""
    w0, w1 = asm.stages[0][0], max(s[1] for s in asm.stages)
    spans = sorted((max(a, w0), min(b, w1)) for a, b, _, _ in asm.device)
    total, gaps, end = 0.0, [], w0
    for a, b in spans:
        if a > end:
            gaps.append((a - end, end))
        if b > end:
            total += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((w1 - end, end))

    def holder(t):
        return next((n for a, b, n in asm.stages if a <= t <= b),
                    "(between stages)")

    return {"window_s": (w1 - w0) / 1e6, "busy_s": total / 1e6,
            "gaps": [(g / 1e6, holder(t + g / 2)) for g, t in gaps]}
