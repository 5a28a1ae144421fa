"""The port's sharded path (miniasm_tpu_torch/parallel/full.py) against the
JAX package's: run_sharded at world sizes 1, 2 and 4, its ranks started
by parallel/group.py's launch over gloo on the CPU, must print the bytes
of the JAX run_sharded on the 8-device virtual mesh (tests/conftest.py)
and of the JAX single-device pipeline, and at world size 2 with -p bed,
-S, -f, -R and the oracle clean modes those of the JAX pipeline; the
step's tables, counters and arc set must equal the JAX
_make_select_step's; detect(group=) at world size 2 must equal detect().
Everything compared is exact.

The ranks are spawned processes that import this module: it imports JAX
only inside the fixtures, so they load PyTorch and the port alone."""

import io
import os
import pickle

import numpy as np
import pytest
import torch

from miniasm_tpu_torch.config import Opt
from miniasm_tpu_torch.parallel import group as grp

RUNS = [("sim_small", "ug"), ("sim_noisy", "ug"), ("sim_noisy", "sg")]
WORLDS = [1, 2, 4]
# the flag sets the world-size-2 launch also runs: (name, data, fmt, the
# pipeline's keywords, environment); "fn_reads" names the data's FASTA,
# "no_cont" is -R (run_sharded takes its excluded reads)
FLAG_RUNS = [
    ("bed", "sim_small", "bed", {}, {}),
    ("bed", "sim_noisy", "bed", {}, {}),
    ("S9", "sim_noisy", "ug", {"stage": 9}, {}),
    ("S7", "sim_noisy", "sg", {"stage": 7}, {}),
    ("f", "sim_small", "ug", {"fn_reads": True}, {}),
    ("R", "sim_noisy", "ug", {"no_cont": True}, {}),
    ("native", "sim_noisy", "ug", {}, {"MINIASM_TPU_CLEAN": "native"}),
    ("py", "sim_noisy", "sg", {}, {"MINIASM_TPU_CLEAN": "py"})]


def flag_id(run):
    name, data, fmt = run[:3]
    return "%s_%s_%s" % (name, data, fmt)


def _kwargs(kw, data):
    """FLAG_RUNS keywords for one fixture: the FASTA path for fn_reads."""
    return {k: (data["fasta"] if k == "fn_reads" else v)
            for k, v in kw.items()}


def rank_job(outdir, runs, extra):
    """Every rank of a launch: run_sharded for each (tag, paf, fmt, kw,
    env) of runs, with the environment `env` set and the keywords `kw`
    (no_cont: the -R prefilter's excluded reads); with `extra` also the
    step's outputs for each (tag, paf) and the sharded detection of a
    pickled graph.  Rank 0 writes the results into outdir."""
    from miniasm_tpu_torch.graph import devclean
    from miniasm_tpu_torch.io.paf import no_cont_prefilter
    from miniasm_tpu_torch.parallel.full import (gather_arcs, run_sharded,
                                                 select_step, shard_rows)
    from miniasm_tpu_torch.utils.timers import StageClock

    g = grp.current()
    root = g.rank == 0

    def save(name, text):
        if root:
            with open(os.path.join(outdir, name), "w") as f:
                f.write(text)

    for tag, paf, fmt, kw, env in runs:
        kw = dict(kw)
        opt = Opt()
        if kw.pop("no_cont", False):
            kw["excl"] = no_cont_prefilter(paf, opt.min_span, opt.min_match,
                                           opt.max_hang, opt.int_frac)
        buf = io.StringIO()
        os.environ.update(env)
        try:
            run_sharded(paf, opt, outfmt=fmt, out=buf, **kw)
        finally:
            for k in env:
                del os.environ[k]
        save(tag, buf.getvalue())
    if not extra:
        return
    for tag, paf in extra["step"]:
        rows, n_seq, block, _ = shard_rows(paf, Opt(), None, g,
                                           StageClock({}, g.device))
        arcmat, meta, counts = select_step(rows, n_seq, block, Opt(), g)
        allarcs = gather_arcs(arcmat, g)
        if root:
            np.savez(os.path.join(outdir, "step_" + tag + ".npz"),
                     arcs=allarcs, meta=meta, counts=np.asarray(counts))
    if root:
        with open(extra["graph"], "rb") as f:
            graph = pickle.load(f)
        det = devclean.detect(graph, Opt(), do_trans=True, device=g.device,
                              group=g)
        devclean.release(g)
        with open(os.path.join(outdir, "detect.pkl"), "wb") as f:
            pickle.dump(det, f)
    else:
        devclean.follow(g)


def _noisy_graph(paf):
    """The port's single-card graph of a PAF, before cleaning."""
    from miniasm_tpu_torch.graph.asg import graph_from_arcs
    from miniasm_tpu_torch.io.native.pafload import load_hits_mt
    from miniasm_tpu_torch.select.fused2 import select_build2

    opt = Opt()
    colmat, d, h3 = load_hits_mt(paf, opt.min_span, opt.min_match,
                                 min_iden=float(opt.min_iden))
    h3.free()
    arcs, md, _ = select_build2(colmat, d, opt, bi_dir=True)
    g, _, _, _ = graph_from_arcs(d, md["sub_s"], md["sub_e"], md["sub_del"],
                                 md["cont"], md["used"], md["pal"], arcs)
    return g


@pytest.fixture(scope="module")
def port_runs(sim_small, sim_noisy, tmp_path_factory):
    """The port's outputs at each world size: {(world, data, fmt): text},
    plus the world-size-2 launch's step and detect results."""
    sims = {"sim_small": sim_small, "sim_noisy": sim_noisy}
    pafs = {k: v["paf"] for k, v in sims.items()}
    graph = str(tmp_path_factory.mktemp("graph") / "noisy.pkl")
    with open(graph, "wb") as f:
        pickle.dump(_noisy_graph(sim_noisy["paf"]), f)
    res = {}
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp("ws%d" % world))
        runs = [("%s_%s" % (data, fmt), pafs[data], fmt, {}, {})
                for data, fmt in RUNS]
        extra = None
        if world == 2:
            extra = {"step": sorted(pafs.items()), "graph": graph}
            runs += [(flag_id(r), pafs[r[1]], r[2], _kwargs(r[3], sims[r[1]]),
                      r[4]) for r in FLAG_RUNS]
        grp.launch(world, rank_job, d, runs, extra, device="cpu")
        for data, fmt in RUNS:
            with open(os.path.join(d, "%s_%s" % (data, fmt))) as f:
                res[(world, data, fmt)] = f.read()
        if world == 2:
            res["dir2"] = d
            for r in FLAG_RUNS:
                with open(os.path.join(d, flag_id(r))) as f:
                    res[flag_id(r)] = f.read()
    res["graph"] = graph
    return res


@pytest.fixture(scope="module")
def jax_runs(sim_small, sim_noisy):
    """{(data, fmt): (JAX run_sharded on make_mesh(8), JAX pipeline.run)}."""
    from miniasm_tpu.config import Opt as JOpt
    from miniasm_tpu.parallel.full import run_sharded
    from miniasm_tpu.parallel.mesh import make_mesh
    from miniasm_tpu.pipeline import run

    pafs = {"sim_small": sim_small["paf"], "sim_noisy": sim_noisy["paf"]}
    res = {}
    for data, fmt in RUNS:
        a, b = io.StringIO(), io.StringIO()
        run_sharded(pafs[data], JOpt(), make_mesh(8), outfmt=fmt, out=a)
        run(pafs[data], JOpt(), outfmt=fmt, out=b)
        res[(data, fmt)] = (a.getvalue(), b.getvalue())
    return res


@pytest.mark.parametrize("data,fmt", RUNS)
@pytest.mark.parametrize("world", WORLDS)
def test_run_sharded_matches_jax(port_runs, jax_runs, world, data, fmt):
    jax_sharded, jax_single = jax_runs[(data, fmt)]
    assert jax_sharded == jax_single
    assert port_runs[(world, data, fmt)] == jax_sharded
    assert jax_sharded.count("\n") > 10


@pytest.mark.parametrize("run", FLAG_RUNS, ids=flag_id)
def test_run_sharded_flags_match_jax(request, port_runs, monkeypatch, run):
    """-p bed, -S, -f, -R and the oracle clean modes through run_sharded
    at world size 2: the JAX pipeline's bytes."""
    from miniasm_tpu.config import Opt as JOpt
    from miniasm_tpu.pipeline import run as jax_run

    name, data, fmt, kw, env = run
    sim = request.getfixturevalue(data)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = io.StringIO()
    jax_run(sim["paf"], JOpt(), outfmt=fmt, out=want, **_kwargs(kw, sim))
    assert port_runs[flag_id(run)] == want.getvalue()
    assert want.getvalue().count("\n") > 10
    if name == "f":
        assert "\tLN:i:" in want.getvalue() and "\t*\t" not in want.getvalue()


def _jax_step(paf):
    """The JAX package's sharded step on make_mesh(8), as its run_sharded
    runs it (full.py:404-433)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from miniasm_tpu.config import Opt as JOpt
    from miniasm_tpu.parallel import full as jf
    from miniasm_tpu.parallel.mesh import make_mesh

    opt, mesh = JOpt(), make_mesh(8)
    cols, d, _, _ = jf._load_originals(paf, opt, None)
    n_seq = d.n_seq
    hostmat, per, block, cap = jf._partition(cols, n_seq, 8)
    max_len = int(np.max(d.lens_array()))
    step = jf._make_select_step(
        mesh, n_seq, jf._next_pow2(n_seq), opt, per=per, block=block,
        cap=cap, pack_se=max_len < 65535, arc_cap=2 * per,
        tr_cap=jf._next_pow2(max(1 << 14, 8 * block)),
        pack_ev=max_len < 32767 and n_seq + 2 <= 0xFFFF)
    gmat = jax.device_put(hostmat, NamedSharding(mesh, P(None, "r")))
    arcmat, meta, counts = jax.device_get(jax.jit(step)(gmat))
    return np.asarray(arcmat), np.asarray(meta)[:, :n_seq], \
        [int(x) for x in counts]


@pytest.mark.parametrize("data", ["sim_noisy", "sim_small"])
def test_select_step_matches_jax_step(request, port_runs, data):
    paf = request.getfixturevalue(data)["paf"]
    arcmat, meta, c = _jax_step(paf)
    got = np.load(os.path.join(port_runs["dir2"], "step_%s.npz" % data))
    assert np.array_equal(got["meta"], meta)
    tot_dp, tot_len = c[7] + (c[8] << 10), c[9] + (c[10] << 10)
    assert got["counts"].tolist() == c[:7] + [tot_dp, tot_len]
    live = arcmat[4] >= 0
    want = {int(k): tuple(arcmat[:4, j]) for j, k in
            zip(np.flatnonzero(live), arcmat[4][live])}
    arcs = got["arcs"]
    have = {int(k): tuple(arcs[:4, j]) for j, k in enumerate(arcs[4])}
    assert len(have) == arcs.shape[1] == c[6] > 0
    assert have == want


def test_detect_group_matches_detect(port_runs):
    from miniasm_tpu_torch.graph import devclean

    with open(port_runs["graph"], "rb") as f:
        g = pickle.load(f)
    want = devclean.detect(g, Opt(), do_trans=True)
    with open(os.path.join(port_runs["dir2"], "detect.pkl"), "rb") as f:
        got = pickle.load(f)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(got[k], v), k
        elif k == "shorts":
            assert all(np.array_equal(a, b) for a, b in zip(got[k], v))
        else:
            assert got[k] == v, k
    assert want["counters"][0] > 0  # transitive reduction fired


def test_launch_refuses_two_nccl_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL refuses"):
        grp.launch(2, rank_job, "", [], None, device="cuda")
    with pytest.raises(ValueError, match="ug, sg or bed"):
        from miniasm_tpu_torch.parallel.full import run_sharded

        run_sharded("x.paf", Opt(), outfmt="paf")
