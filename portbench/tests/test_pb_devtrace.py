"""portbench/devtrace.py on a fixed synthetic chrome trace: the program's
`span:<path>` ranges, which its recorder adds while tracing is on, leave
the assemblies, their stage windows, the device's busy seconds and the
idle gaps (with the stages that name them) exactly as they are without
them, so `device_idle_share` and `roofline_share.select` read the same
intervals."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench import devtrace  # noqa: E402


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _dev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# two assemblies of three stages; device work in load, select and clean
EVENTS = []
for base in (0, 10_000):
    EVENTS += [
        _range("portbench:assembly", base, 1_000),
        _range("stage:load+upload", base + 10, 300),
        _range("stage:select+fetch", base + 310, 100),
        _range("stage:clean", base + 410, 500),
        _dev("gpu_memcpy", "Memcpy HtoD", base + 200, 20),
        _dev("kernel", "unpack4", base + 290, 10),
        _dev("kernel", "sweep", base + 320, 30),
        _dev("kernel", "arc_order", base + 340, 40),
        _dev("kernel", "clean_stage_b", base + 600, 5),
        _dev("gpu_memset", "Memset", base + 880, 2),
    ]
SPANS = []
for base in (0, 10_000):
    SPANS += [
        _range("span:load+upload/parse_wait", base + 20, 170),
        _range("span:load+upload/push", base + 195, 10),
        _range("span:select+fetch/enqueue", base + 312, 20),
        _range("span:clean/cut_tip", base + 420, 300),
        _range("span:clean/cut_tip/detect", base + 590, 30),
        _range("span:clean/pop_bubble/commit", base + 730, 150),
    ]


def _load(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return devtrace.load(str(path))


@pytest.mark.parametrize("order", ["spans_last", "spans_first"])
def test_span_ranges_change_nothing(tmp_path, order):
    plain = _load(tmp_path, EVENTS)
    mixed = _load(tmp_path, EVENTS + SPANS if order == "spans_last"
                  else SPANS + EVENTS)
    assert len(plain) == len(mixed) == 2
    for a, b in zip(plain, mixed):
        assert a.stages == b.stages and a.device == b.device
        assert a.stage("select+fetch") == b.stage("select+fetch")
        assert a.kernels_in(*a.stage("select+fetch")) \
            == b.kernels_in(*b.stage("select+fetch"))
        assert devtrace.busy(a) == devtrace.busy(b)


def test_busy_and_gaps_of_the_fixed_trace(tmp_path):
    asms = _load(tmp_path, EVENTS + SPANS)
    b = devtrace.busy(asms[0])
    assert b["window_s"] == pytest.approx(900e-6)
    # 20 + 10 + (30 + 40 overlapping from 320 to 380: 60) + 5 + 2
    assert b["busy_s"] == pytest.approx(97e-6)
    # the gap from 300 to 320 has its middle at 310, load+upload's end
    assert [n for _, n in b["gaps"]] == ["load+upload"] * 3 + ["clean"] * 3
    assert sum(g for g, _ in b["gaps"]) + b["busy_s"] \
        == pytest.approx(b["window_s"])
