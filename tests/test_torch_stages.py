"""The stage-time driver miniasm_tpu_torch.eval.stages on the CPU: a cold
round (a fresh process per run) and a warm one on a small simulated set,
each run's select spans and detection count present and its output the
same size in both modes; and the select-stage summary of a profiler
trace."""

import json

import pytest

from miniasm_tpu_torch.eval import stages


@pytest.fixture(scope="module")
def small_paf(tmp_path_factory):
    from miniasm_tpu_torch.eval.simulate import simulate, write_paf

    p = str(tmp_path_factory.mktemp("stages") / "s.paf")
    write_paf(simulate(genome_len=60_000, coverage=12.0, seed=3), p)
    return p


def test_stages_cold_and_warm_on_cpu(small_paf, tmp_path, capsys):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = {}
    for warm in (False, True):
        out = str(tmp_path / ("warm.json" if warm else "cold.json"))
        argv = ["--device", "cpu", "--paf", small_paf, "--noisy", small_paf,
                "--rounds", "1", "--json", out, root]
        assert stages.main(argv + (["--warm"] if warm else [])) == 0
        with open(out) as f:
            rep = json.load(f)
        assert rep["warm"] is warm
        assert [r["run"] for r in rep["runs"]] == list(stages.RUNS)
        for r in rep["runs"]:
            assert r["spans"]["select+fetch/fetch"] >= 0
            assert r["spans"]["select+fetch/enqueue"] >= 0
            assert r["bytes"] > 0
        assert rep["runs"][2]["counters"]["clean.detects"] >= 1
        got[warm] = [r["bytes"] for r in rep["runs"]]
    assert got[False] == got[True]
    assert "select enqueue" in capsys.readouterr().out


@pytest.mark.parametrize("warm", [False, True])
def test_stages_staged_and_sharded_runs_on_cpu(small_paf, tmp_path, warm):
    """--runs: the staged path's -1, -2 and -S 4 -p bed and run_sharded on
    a one-rank gloo group, each with its select stage's own seconds."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "runs.json")
    runs = ["ecoli_s1_ug", "noisy_s2_ug", "ecoli_S4_bed", "sharded_ug"]
    argv = ["--device", "cpu", "--paf", small_paf, "--noisy", small_paf,
            "--rounds", "1", "--json", out, "--runs", ",".join(runs), root]
    assert stages.main(argv + (["--warm"] if warm else [])) == 0
    with open(out) as f:
        rep = json.load(f)
    assert [r["run"] for r in rep["runs"]] == runs
    for r in rep["runs"]:
        assert r["bytes"] > 0 and 0 < r["select_s"] < r["wall_s"]
    assert "select" in rep["runs"][3]["stages"]
    assert "gather" in rep["runs"][3]["stages"]
    with pytest.raises(SystemExit):
        stages.main(argv[:-2] + ["--runs", "warmup", root])


@pytest.mark.parametrize("run", ["sharded_ug", "ecoli_ug"])
def test_stages_run_without_a_card_raises(small_paf, monkeypatch, capsys,
                                          run):
    """A run of the script's process asked of the card (the default
    --device) where there is none raises, the sharded arm as the CLI arm:
    neither measures the CPU unless the CPU is asked for."""
    import argparse
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.delenv("MINIASM_TPU_TORCH_DEVICE", raising=False)
    a = argparse.Namespace(device="cuda", trace_runs="noisy_ug")
    with pytest.raises(RuntimeError, match="exited"):
        stages._process(root, [run], a, small_paf, small_paf, "")
    assert "no CUDA device is available" in capsys.readouterr().err


def test_select_calls_sums_the_select_window(tmp_path):
    ev = [{"name": "stage:select+fetch", "ts": 100, "dur": 50},
          {"name": "aten::index", "cat": "cpu_op", "ts": 110, "dur": 20},
          {"name": "aten::index", "cat": "cpu_op", "ts": 131, "dur": 4},
          {"name": "cudaHostAlloc", "cat": "cuda_runtime", "ts": 136,
           "dur": 10},
          {"name": "aten::sort", "cat": "cpu_op", "ts": 140, "dur": 20},
          {"name": "aten::add", "cat": "cpu_op", "ts": 10, "dur": 5}]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    rows = stages._select_calls(str(p))
    assert [r[:3] for r in rows] == [
        ("stage:select+fetch", "window", 1), ("aten::index", "cpu_op", 2),
        ("cudaHostAlloc", "cuda_runtime", 1)]
    assert [r[3] for r in rows] == pytest.approx([0.05, 0.024, 0.01])
