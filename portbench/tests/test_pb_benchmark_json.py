"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every configuration, traffic mix and per-layer metric by its name."""

import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
sys.path.insert(0, ROOT)

from portbench import run as R  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_limits(bench):
    assert set(bench) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_workloads(bench):
    w = bench["workloads"]
    assert 1 <= len(w) <= 24
    assert len({(x["config"], x["traffic"]) for x in w}) == len(w)
    for x in w:
        assert set(x) == {"name", "config", "traffic", "chips", "why"}
        assert x["chips"] in (1, 4) and _line(x["why"])
        assert NAME.match(x["config"]) and NAME.match(x["traffic"])
    assert sum(x["chips"] == 4 for x in w) <= max(1, len(w) // 4)


def test_metrics(bench):
    e2e = bench["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    names = {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in names
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["name"], m["layer"])
    for c in cells:
        assert any(c in m.get("workloads", cells) for m in bench["per_layer"])


def test_discovery_by_name(bench):
    """Each cell's configuration and traffic, and each per-layer metric's
    reader, are files named after them; the reader declares the layer,
    unit and end-to-end metric that BENCHMARK.json gives it."""
    for w in bench["workloads"]:
        cell, cfg, traffic, e2e, layer = R.load_cell(w["name"])
        assert cell == w and cfg["name"] == w["config"]
        assert set(traffic) <= {"recall", "order", "gzip", "argv", "why",
                                "source"}
        assert {m["name"] for m in e2e} >= {"setup_s"}
    for m in bench["per_layer"]:
        mod = R.load_metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == \
            (m["layer"], m["unit"], m["moves"])
        assert callable(mod.read)


def test_a_reader_with_nothing_to_read_returns_nothing(bench):
    r = R.Run()
    for m in bench["per_layer"]:
        assert R.load_metric(m["name"]).read(r) is None
