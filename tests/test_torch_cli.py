"""The port's command line (miniasm_tpu_torch.cli) against the JAX
package's on the same PAF: stdout must be byte-identical for -p ug, sg
and bed (the staged flags are in test_torch_staged_cli.py, -f and -R in
test_torch_flags.py, the oracle clean modes in test_torch_oracle.py, the
main path's -p paf in test_torch_paf.py, the snapshot in
test_torch_snapshot.py).  Also: the port imports neither JAX nor the JAX
package, and asks for the card by default and raises without one."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from conftest import run_ours
from miniasm_tpu_torch import cli as tcli
from miniasm_tpu_torch.device import ENV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_port(args, device="cpu"):
    """The port's CLI in-process on `device`; returns (rc, stdout, stderr)."""
    old = os.environ.get(ENV)
    os.environ[ENV] = device
    out, err = io.StringIO(), io.StringIO()
    try:
        with redirect_stdout(out), redirect_stderr(err):
            rc = tcli.main(list(args))
    finally:
        if old is None:
            os.environ.pop(ENV, None)
        else:
            os.environ[ENV] = old
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("fmt", ["ug", "sg", "bed"])
@pytest.mark.parametrize("data", ["sim_small", "sim_noisy"])
def test_cli_stdout_matches_jax(request, data, fmt):
    paf = request.getfixturevalue(data)["paf"]
    want = run_ours(["-p", fmt, paf])
    rc, got, _ = run_port(["-p", fmt, paf])
    assert rc == 0
    assert got == want
    assert got


def test_gz_stdin_and_empty_inputs(sim_noisy, tmp_path):
    """The loader reads gzip and stdin like the JAX package's; an empty
    PAF prints what the JAX package prints."""
    import gzip
    import shutil

    want = run_ours(["-p", "ug", sim_noisy["paf"]])
    gz = str(tmp_path / "r.paf.gz")
    with open(sim_noisy["paf"], "rb") as f, gzip.open(gz, "wb") as g:
        shutil.copyfileobj(f, g)
    assert run_port(["-p", "ug", gz])[1] == want
    env = dict(os.environ, **{ENV: "cpu"})
    with open(sim_noisy["paf"]) as f:
        r = subprocess.run([sys.executable, "-m", "miniasm_tpu_torch.cli",
                            "-p", "ug", "-"], stdin=f, cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout == want
    empty = str(tmp_path / "empty.paf")
    open(empty, "w").close()
    assert run_port(["-p", "ug", empty])[:2] == (0, run_ours(["-p", "ug", empty]))


def test_port_imports_no_jax(sim_small, tmp_path):
    """A main-path run, a staged (-1) run, -p paf, a snapshot save and
    restore, both oracle clean modes, -f -R, the parallel package
    (run_sharded on a one-rank group, the multi-process worker), and the
    tools (minidot, the interop converters, the eval tools, the panel, the
    scaling harness and the graft entry points, imported, and minidot and
    the forward step run), the run switches (the v2 loader, the timing
    lines and the profiler trace) and the fuzz and sanitizer modules load
    no module of JAX or of the JAX package (exact names: miniasm_tpu_torch
    shares the prefix)."""
    paf, fa = sim_small["paf"], sim_small["fasta"]
    snap = str(tmp_path / "snap")
    code = (
        "import io, json, os, sys\n"
        "from contextlib import redirect_stdout\n"
        "from miniasm_tpu_torch import cli\n"
        "from miniasm_tpu_torch.config import Opt\n"
        "from miniasm_tpu_torch.parallel import group, multihost, route\n"
        "from miniasm_tpu_torch.parallel.full import run_sharded\n"
        "from miniasm_tpu_torch import dotter\n"
        "from miniasm_tpu_torch.io import fastx\n"
        "from miniasm_tpu_torch.interop import (da2paf, mhap2paf, paf2mhap,\n"
        "    paftop, sam2paf, wt2paf)\n"
        "from miniasm_tpu_torch.eval import (dryrun, fuzz, order_eval,\n"
        "    ovsen, paf_srtcmp, panel, ref2ovlp, scaling, testsen)\n"
        "from miniasm_tpu_torch.io.native import sanitize\n"
        "with redirect_stdout(io.StringIO()):\n"
        "    rc = dotter.main([%r])\n"
        "    fwd, args = dryrun.entry(device='cpu')\n"
        "    fwd(*args)\n"
        "    rc |= cli.main(['-p', 'ug', %r])\n"
        "    rc |= cli.main(['-1', '-p', 'ug', %r])\n"
        "    rc |= cli.main(['-p', 'paf', %r])\n"
        "    rc |= cli.main(['-R', '-f', %r, %r])\n"
        "    os.environ.update(MINIASM_TPU_LOADER='v2',\n"
        "                      MINIASM_TPU_TIMING='1',\n"
        "                      MINIASM_TPU_PROFILE=%r + '_prof')\n"
        "    rc |= cli.main(['-R', '-f', %r, %r])\n"
        "    for k in ('LOADER', 'TIMING', 'PROFILE'):\n"
        "        del os.environ['MINIASM_TPU_' + k]\n"
        "    group.init(0, 1, 'file://' + %r + '_rdv', device='cpu')\n"
        "    run_sharded(%r, Opt())\n"
        "    group.destroy()\n"
        "    multihost.worker(%r, %r + '.gfa', coordinator='file://' + %r\n"
        "                     + '_rdv2', num_procs=1, proc_id=0)\n"
        "    os.environ['MINIASM_TPU_SNAPSHOT'] = %r\n"
        "    for mode in ('native', 'py'):\n"
        "        os.environ['MINIASM_TPU_CLEAN'] = mode\n"
        "        rc |= cli.main(['-p', 'ug', %r])\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'miniasm_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'miniasm_tpu.')))\n"
        "print(json.dumps([rc, bad]))\n" % (paf, paf, paf, paf, fa, paf, snap,
                                             fa, paf, snap, paf, paf, snap,
                                             snap, snap, paf))
    env = dict(os.environ, **{ENV: "cpu"})
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rc, bad = json.loads(r.stdout.strip().splitlines()[-1])
    assert rc == 0 and bad == []


def test_cuda_requested_without_card_raises(sim_small, monkeypatch):
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.device import get_device
    from miniasm_tpu_torch.pipeline import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(sim_small["paf"], Opt(), out=io.StringIO())
    assert get_device("cpu").type == "cpu"
    rc, out, err = run_port(["-p", "ug", sim_small["paf"]], device="cuda")
    assert rc != 0 and out == "" and "no CUDA device" in err
