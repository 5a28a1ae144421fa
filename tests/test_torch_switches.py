"""The port's run switches against the JAX package's (tolerance 0:
stdout byte-equal):

- MINIASM_TPU_TIMING: a `[T::<stage>] +<s>` stderr line at the end of
  each stage, in the JAX package's format, on every path; stdout
  unchanged;
- MINIASM_TPU_PROFILE: a torch.profiler trace in <dir>/trace.json that
  loads as JSON and holds a `stage:<name>` range for each stage, and
  JAX's stderr line; stdout unchanged;
- MINIASM_TPU_NATIVE_SO: a good library loads in place of the build, a
  bad one raises, and so does a failed build."""

import json
import os
import re

import pytest

from conftest import run_ours
from miniasm_tpu_torch import pipeline
from miniasm_tpu_torch.io.native import build
from test_torch_cli import run_port

TICK = re.compile(r"^\[T::([^\]]+)\] \+(\d+\.\d{3})$")
PATHS = {"main_ug": ["-p", "ug"], "main_bed": ["-p", "bed"],
         "main_paf": ["-p", "paf"], "staged_sg": ["-1", "-p", "sg"],
         "staged_paf": ["-2", "-R", "-p", "paf"]}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_timing_lines(sim_noisy, monkeypatch, path):
    args = PATHS[path] + [sim_noisy["paf"]]
    want = run_ours(args)
    monkeypatch.setenv("MINIASM_TPU_TIMING", "1")
    rc, got, err = run_port(args)
    assert rc == 0 and got == want
    ticks = [TICK.match(ln) for ln in err.splitlines()
             if ln.startswith("[T::")]
    assert ticks and all(ticks)
    assert [m.group(1) for m in ticks] == list(pipeline.LAST_TIMING)
    assert [m.group(2) for m in ticks] == \
        ["%.3f" % t for t in pipeline.LAST_TIMING.values()]
    # the stages JAX's main path writes lead the port's
    if path == "main_ug":
        assert [m.group(1) for m in ticks][:4] == \
            ["load+upload", "select+fetch", "order", "graph_build"]
    monkeypatch.delenv("MINIASM_TPU_TIMING")
    assert "[T::" not in run_port(args)[2]


@pytest.mark.parametrize("path", ["main_ug", "staged_sg"])
def test_profile_trace(sim_small, tmp_path, monkeypatch, path):
    args = PATHS[path] + [sim_small["paf"]]
    want = run_ours(args)
    prof = str(tmp_path / "prof")
    monkeypatch.setenv("MINIASM_TPU_PROFILE", prof)
    rc, got, err = run_port(args)
    assert rc == 0 and got == want
    assert "[M::main] profiler trace written to %s\n" % prof in err
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"][6:]: e for e in events
              if e.get("cat") == "user_annotation"
              and str(e.get("name")).startswith("stage:")}
    assert set(ranges) == set(pipeline.LAST_TIMING)
    # the stages follow one another in the order they ended
    order = sorted(ranges, key=lambda k: ranges[k]["ts"])
    assert order == list(pipeline.LAST_TIMING)
    assert all(ranges[k]["dur"] > 0 for k in order)


def test_native_so_override(monkeypatch, tmp_path):
    good = build.get_lib()._name
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setenv("MINIASM_TPU_NATIVE_SO", good)
    lib = build.get_lib()
    assert lib._name == good and hasattr(lib, "ma_paf_load_hits3")
    for bad in (str(tmp_path / "absent.so"), __file__):
        monkeypatch.setattr(build, "_lib", None)
        monkeypatch.setenv("MINIASM_TPU_NATIVE_SO", bad)
        with pytest.raises(RuntimeError, match="does not load"):
            build.get_lib()
        assert build._lib is None


def test_failed_build_raises(monkeypatch, tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.delenv("MINIASM_TPU_NATIVE_SO", raising=False)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(build, "_sources", lambda: [str(broken)])
    with pytest.raises(RuntimeError, match="build failed"):
        build.get_lib()
    assert build._lib is None and not os.path.exists(tmp_path / "lib.so")
