"""The sanitizer jobs of the port's host C++
(miniasm_tpu_torch/io/native/sanitize.py): the exerciser over a plain -O1
-g build of every io/native/*.cpp, loaded through MINIASM_TPU_NATIVE_SO,
runs here; the AddressSanitizer/UBSan and ThreadSanitizer builds are
slow-marked (tier-1 deselects them)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _job(mode):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MINIASM_TPU")}
    return subprocess.run(
        [sys.executable, "-m", "miniasm_tpu_torch.io.native.sanitize", mode],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)


def _check(mode):
    r = _job(mode)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    assert "sanitize exerciser (%s): every native entry point exercised"\
        % mode in r.stdout
    assert r.stdout.splitlines()[-1].startswith("%s: clean" % mode)


def test_exerciser_without_sanitizer():
    _check("none")


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["asan", "tsan"])
def test_sanitizer_job(mode):
    _check(mode)


def test_usage():
    from miniasm_tpu_torch.io.native import sanitize

    assert sanitize.main(["msan"]) == 2
    assert sanitize.main([]) == 2
