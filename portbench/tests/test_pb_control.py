"""The control of the benchmark's check: the plain reference with one of
the configuration's guarantees broken (reads numbered in another order
than the order their names first appear, as a loader that interns two
halves of the file on two threads would), put in the program's place
inside a run of the harness, must come out not correct, on either mix.
portbench/control.py reads the same on the card at a cell's own size."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench import control  # noqa: E402


@pytest.mark.parametrize("workload", ["ecoli_exact", "ecoli_half"])
def test_the_control_fails_the_check(workload):
    rows = control.readings(workload, [41, 42, 2**31 + 43], 0.3,
                            device_check=False,
                            sizes={"genome_len": 150_000})
    assert [r["correct"] for r in rows] == [False] * 3
    assert all(r["mismatched"] == r["attempted"] >= 3 for r in rows)
    assert all(r["failed"] == 0 for r in rows)
