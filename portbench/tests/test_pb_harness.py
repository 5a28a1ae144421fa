"""The harness end to end on the CPU at a small size: a sound run is
correct; a run with the timed path broken underneath is not, for each
fault the cells can have; without a card, or without the program, a run
exits with an error and prints no result.  The card's own run is the
`cuda` test at the end."""

import os
import shutil
import subprocess
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
sys.path.insert(0, ROOT)

from portbench import run as R  # noqa: E402

SMALL = {"genome_len": 120_000}


def args(workload, seed=2**31 + 3, seconds=0.5, trace=0):
    return types.SimpleNamespace(workload=workload, seed=seed,
                                 seconds=seconds, trace=trace)


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("MINIASM_TPU_TORCH_DEVICE", "cpu")


def _break(fault):
    """A hook that swaps the program's CLI for one with `fault`."""

    def hook(asm):
        real = asm.cli

        def main(argv):
            paf = argv[-1]
            if fault == "half":
                # half of the input left out where it is read
                half = paf + ".half"
                with open(paf, "rb") as f:
                    lines = f.read().split(b"\n")
                with open(half, "wb") as f:
                    f.write(b"\n".join(lines[: len(lines) // 2]) + b"\n")
                return real.main(argv[:-1] + [half])
            if fault == "unchanged":
                # the assembly returns without doing its work
                return 0
            rc = real.main(argv)
            if fault == "altered":
                # one answer altered where it is produced: a read's offset
                sys.stdout.flush()
                with open(asm.out, "rb+") as f:
                    data = bytearray(f.read())
                    i = data.index(b"\na\t") + 1
                    j = data.index(b"\t", data.index(b"\t", i) + 1) + 1
                    data[j] = ord("9") if data[j] != ord("9") else ord("8")
                    f.seek(0)
                    f.write(bytes(data))
            return rc

        asm.cli = types.SimpleNamespace(main=main)
        return asm

    return hook


@pytest.mark.parametrize("workload", ["ecoli_exact", "ecoli_half"])
def test_a_sound_run_is_correct(cpu, workload):
    res, check = R.run(args(workload), device_check=False, sizes=SMALL)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 3
    assert set(res["metrics"]) == {"paf_lines_per_s", "setup_s"}
    assert list(res)[-1] == "check"
    assert check == ["check: mismatched 0 (limit 0)",
                     "check: failed 0 (limit 0)"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", ["ecoli_exact", "ecoli_half"])
def test_a_broken_path_is_not_correct(cpu, workload, fault):
    res, check = R.run(args(workload), device_check=False, sizes=SMALL,
                       assembler_hook=_break(fault))
    assert res["correct"] is False
    assert res["check"]["mismatched"]["value"] == res["attempted"] >= 3
    assert check[0].startswith("check: mismatched")


def test_a_traced_run_reports_the_layers(cpu):
    res, _ = R.run(args("ecoli_half", trace=1), device_check=False,
                   sizes=SMALL)
    assert res["correct"] is True
    m = res["metrics"]
    for k in ("assembly_s_p95", "first_assembly_s", "load_s", "select_s",
              "graph_s", "clean_s", "emit_s"):
        assert m[k]["value"] > 0
    # no device on the CPU: nothing to read for the device's metrics
    assert "roofline_share.select" not in m
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ecoli_exact",
         "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, **(env or {})))


def test_without_a_card_the_run_fails_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _cli(ROOT, {"MINIASM_TPU_TORCH_DEVICE": "cpu"})
    assert r.returncode == 3 and r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_without_the_program_the_run_fails_and_prints_nothing(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(str(tmp_path))
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """On the card: a short run of each cell's smallest form is correct
    and names the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for w in ("ecoli_exact", "ecoli_half"):
        res, _ = R.run(args(w, seconds=1), sizes=SMALL)
        assert res["correct"] is True
        assert res["device"]["platform"] == "gpu"
        assert res["device"]["kind"] == torch.cuda.get_device_name()
