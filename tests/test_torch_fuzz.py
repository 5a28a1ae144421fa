"""The port-vs-JAX fuzz (miniasm_tpu_torch/eval/fuzz.py): seeded
draw_case cases through run_case with the JAX CLI as the oracle, stdout
byte-equal and the same exit code; and the draw covers every numeric and
structural option."""

import random

import pytest

from miniasm_tpu_torch.eval import fuzz
from test_torch_options import jax_cli

SEED = 12
N_CASES = 12


def _cases():
    rng = random.Random(SEED)
    return [fuzz.draw_case(rng) for _ in range(N_CASES)]


@pytest.mark.parametrize("k", range(N_CASES))
def test_fuzz_case_matches_jax(k):
    rec = fuzz.run_case(_cases()[k], "cpu", oracle=jax_cli)
    assert rec["ok"], rec


def test_draw_covers_every_option():
    """Over 200 draws every numeric and structural flag appears, each
    draw ends in one -p format, and a seed draws the same cases."""
    rng = random.Random(0)
    cases = [fuzz.draw_case(rng) for _ in range(200)]
    seen = {a for c in cases for a in c["args"] if a.startswith("-")}
    want = set(fuzz.NUMERIC) | {"-r", "-R", "-b", "-1", "-2", "-S", "-p"}
    assert want <= seen
    assert all(c["args"][-2] == "-p" and c["args"][-1] in
               ("ug", "sg", "bed", "paf") for c in cases)
    assert _cases() == _cases()
    assert {c["gl"] for c in cases} == {150_000, 300_000, 500_000, 800_000}


def test_main_writes_artifact(tmp_path, monkeypatch, capsys):
    """main on the CPU: one JSON line per case, a summary line, and the
    artifact; the default oracle is the port on the CPU."""
    import json

    from miniasm_tpu_torch.device import ENV

    monkeypatch.setenv(ENV, "cpu")
    out = tmp_path / "fuzz.json"
    assert fuzz.main(["1", "--seed", "3", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"cases": 1, "fails": 0}
    art = json.loads(out.read_text())
    assert art["cases"] == 1 and art["results"][0]["ok"]
