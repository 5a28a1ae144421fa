"""Card tests of the port's CUDA kernels (miniasm_tpu_torch/csrc): each
kernel against its plain PyTorch twin on the same CUDA tensors, bit for
bit, plus one small end-to-end run on the card against the CPU run.

Marked `cuda`; they skip on a machine without a card.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from miniasm_tpu_torch.graph.asg import Graph, cleanup

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_graph(rng, n_seq=60, n_pairs=200):
    """Random symmetric string graph in the port's Graph (compacted)."""
    lens = rng.integers(3000, 20000, n_seq).astype(np.uint32)
    us, ls, vs, ols = [], [], [], []
    for _ in range(n_pairs):
        a = int(rng.integers(0, 2 * n_seq))
        b = int(rng.integers(0, 2 * n_seq))
        if a >> 1 == b >> 1:
            continue
        la, lb = int(lens[a >> 1]), int(lens[b >> 1])
        ol = int(rng.integers(500, min(la, lb)))
        us += [a, b ^ 1]
        ls += [la - ol, lb - ol]
        vs += [b, a ^ 1]
        ols += [ol, ol]
    g = Graph(u=np.asarray(us, np.int32), l=np.asarray(ls, np.int32),
              v=np.asarray(vs, np.int32), ol=np.asarray(ols, np.int32),
              adel=np.zeros(len(us), bool), slen=lens,
              sdel=rng.random(n_seq) < 0.05,
              idx_start=np.zeros(2 * n_seq, np.int64),
              idx_cnt=np.zeros(2 * n_seq, np.int32))
    return cleanup(g)


def cut_inputs(rng, n=50_000, T=500):
    """Random select rows and trim tables for cut_hit2arc; about a tenth
    of the rows push a projected end below zero, so the unsigned e-side
    clamp matters."""
    qid = rng.integers(0, T - 2, n)
    tid = rng.integers(0, T - 2, n)
    qs = rng.integers(0, 20000, n)
    qe = qs + rng.integers(0, 20000, n)
    ts = rng.integers(0, 20000, n)
    te = ts + rng.integers(0, 20000, n)
    flags = rng.integers(0, 8, n)
    colmat = np.stack([qid, qs, qe, tid, ts, te, flags]).astype(np.int32)
    s = rng.integers(0, 3000, T)
    e = s + rng.integers(0, 30000, T)
    tab = np.stack([s, e, rng.random(T) < 0.1]).astype(np.int32)
    lanes = rng.integers(0, 4, n).astype(np.uint8)
    return colmat, tab, lanes


@pytest.mark.parametrize("final_pass", [False, True])
def test_cut_hit2arc_kernel_matches_plain(dev, final_pass):
    from miniasm_tpu_torch.select import fused2

    colmat, tab, lanes = cut_inputs(np.random.default_rng(1))
    c = torch.from_numpy(colmat).to(dev)
    args = (c, c[[1, 2, 4, 5]].contiguous(), torch.from_numpy(lanes).to(dev),
            torch.from_numpy(tab).to(dev))
    kw = dict(min_span=2000, max_hang=1000, int_frac=0.8, min_ovlp=2000,
              final_pass=final_pass)
    got = fused2.cut_hit2arc(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, fused2.cut_hit2arc_plain(*args, **kw))


def sweep_inputs(rng, T, reads, n_sides, lo=0, hi=30000, span=5000,
                 skip=0.1, pad=50, p=None):
    """Unsorted, shuffled sweep events: n_sides (start, end) pairs in the
    given reads (drawn with probabilities p; a tenth of them skipped), then
    `pad` absent rows."""
    from miniasm_tpu_torch.select import fused2

    seg = rng.choice(reads, n_sides, p=p)
    a = rng.integers(lo, hi, n_sides)
    b = a + rng.integers(1, span, n_sides)
    ok = rng.random(n_sides) >= skip
    key = np.concatenate([np.where(ok, a * 2, fused2.SKIP),
                          np.where(ok, b * 2 + 1, fused2.SKIP),
                          np.full(pad, fused2.SKIP)])
    seg = np.concatenate([seg, seg, np.full(pad, T)])
    perm = rng.permutation(seg.shape[0])
    return (seg[perm].astype(np.int32),
            key[perm].astype(np.uint32).view(np.int32))


def check_sweep(dev, seg, key, T, min_dp, end_clip, **kw):
    from miniasm_tpu_torch.select import fused2

    seg = torch.from_numpy(seg).to(dev)
    key = torch.from_numpy(key).to(dev)
    got = fused2.sweep_events(seg, key, T, min_dp, end_clip, **kw)
    torch.cuda.synchronize()
    want = fused2.sweep_events_plain(seg, key, T, min_dp, end_clip)
    assert torch.equal(got, want)
    return want


@pytest.mark.parametrize("end_clip", [0, 1000])
def test_sweep_kernel_matches_plain(dev, end_clip):
    T = 400
    seg, key = sweep_inputs(np.random.default_rng(2), T, np.arange(T - 1),
                            10_000)
    want = check_sweep(dev, seg, key, T, 3, end_clip)
    assert (want[0] != want[1]).sum() > 300 and want[2].any()


@pytest.mark.parametrize("smem_cap", [0, 2048, 8192, None])
def test_sweep_kernel_smem_cap(dev, smem_cap):
    """Reads of 60 to 19,000 events (read i drawn with weight 1/(i+1)):
    with the cap at its default they take every branch that fits on chip
    (a warp's registers up to 256 events, a block's shared memory above);
    the cap lowered sends every read (0), the reads past 512 events (2048)
    or past 2048 (8192) to device memory.  The kernel's own branch counts
    say so."""
    from miniasm_tpu_torch.select import fused2

    T = 300
    rng = np.random.default_rng(3)
    w = 1.0 / np.arange(1, T)
    seg, key = sweep_inputs(rng, T, np.arange(T - 1), 60_000, p=w / w.sum())
    kw = {} if smem_cap is None else {"smem_cap": smem_cap}
    want = check_sweep(dev, seg, key, T, 3, 500, **kw)
    assert (want[0] != want[1]).sum() > 250
    _, tiers = fused2.sweep_events_tiers(
        torch.from_numpy(seg).to(dev), torch.from_numpy(key).to(dev), T, 3,
        500, **kw)
    n = np.bincount(seg[(seg < T) & (key != fused2.SKIP)], minlength=T)
    keys = (fused2.SMEM_MAX if smem_cap is None else smem_cap) // 4
    # a warp sorts up to 256 events (REG_EVENTS, csrc/select.cu)
    assert tiers.tolist() == [int((n > min(keys, 256)).sum()),
                              int((n > min(keys, fused2.SMEM_MAX // 4))
                                  .sum())]
    if smem_cap is None:
        assert tiers[0] > 0 and tiers[1] == 0


@pytest.mark.parametrize("n_sides", [50_000, 100_000])
def test_sweep_kernel_one_huge_read(dev, n_sides):
    """One read of 2 * n_sides events, past a block's shared memory,
    beside reads of about 3800 (a block's shared memory)."""
    from miniasm_tpu_torch.select import fused2

    rng = np.random.default_rng(n_sides)
    T = 64
    s1, k1 = sweep_inputs(rng, T, [7], n_sides, hi=2_000_000, span=40_000)
    s2, k2 = sweep_inputs(rng, T, np.arange(T - 1), 120_000)
    want = check_sweep(dev, np.concatenate([s1, s2]),
                       np.concatenate([k1, k2]), T, 5, 0)
    assert want[0, 7] != want[1, 7]
    check_sweep(dev, s1, k1, T, 20, 100, smem_cap=fused2.SMEM_MAX // 2)


def test_sweep_kernel_many_empty_reads(dev):
    T = 300_000
    rng = np.random.default_rng(4)
    seg, key = sweep_inputs(rng, T, rng.choice(T, 500), 2000, pad=1000)
    want = check_sweep(dev, seg, key, T, 2, 100)
    assert 0 < int(want[3].sum()) <= 500
    seg, key = sweep_inputs(rng, T, [0], 0, pad=1000)  # padding only
    assert not check_sweep(dev, seg, key, T, 2, 100).any()


def test_sweep_kernel_largest_positions(dev):
    """Positions up to the largest a key holds below SKIP (start keys to
    0x7FFFFFFE), and keys above it (starts past 2**30 wrap negative as
    int32): the in-read order is the unsigned one."""
    T = 40
    rng = np.random.default_rng(6)
    top = (0x7FFFFFFF >> 1) - 1
    seg, key = sweep_inputs(rng, T, np.arange(T - 2), 4000,
                            lo=top - 300_000, hi=top - 60_000, span=60_000,
                            pad=0)
    want = check_sweep(dev, seg, key, T, 3, 1000)
    assert int(want[1].max()) >= top - 100_000
    # read T-2 ends at the largest end key, read T-1 starts at the largest
    # start key and ends past it
    edge = np.asarray([T - 2, T - 2, T - 1, T - 1], np.int32)
    ekey = np.asarray([(top - 5) * 2, top * 2 + 1, 0x7FFFFFFE, 0x80000001],
                      np.uint32)
    want = check_sweep(dev, np.concatenate([seg, edge]),
                       np.concatenate([key, ekey.view(np.int32)]), T, 1, 0)
    assert want[:2, -1].tolist() == [0x3FFFFFFF, 0x40000000]
    seg, key = sweep_inputs(rng, T, np.arange(T), 4000, lo=(1 << 30) - 5000,
                            hi=(1 << 30) + 5000, span=3000, pad=0)
    assert (key < 0).any()
    check_sweep(dev, seg, key, T, 2, 0)


def staged_inputs(rng, n=50_000, T=500):
    """Random staged hits (9, n) and trim tables (3, T): coordinates that
    straddle the trim ends, a few starts above 2**31 (projections that
    wrap below zero), deleted reads, every hit2arc class."""
    qid = rng.integers(0, T, n)
    tid = rng.integers(0, T, n)
    qs = rng.integers(0, 9000, n)
    qs[rng.random(n) < 0.02] = (1 << 32) - rng.integers(1, 3000)
    qe = qs + rng.integers(0, 9000, n)
    ts = rng.integers(0, 9000, n)
    te = ts + rng.integers(0, 9000, n)
    z = np.zeros(n, np.int64)
    cols = np.stack([qid, qs, qe, tid, ts, te, z, z,
                     rng.integers(0, 2, n)]).astype(np.uint32).view(np.int32)
    s = rng.integers(0, 6000, T)
    e = s + rng.integers(0, 12000, T)
    sub = np.stack([s, e, rng.random(T) < 0.1]).astype(np.int32)
    return cols, sub


def test_hit_cut_kernel_matches_plain(dev):
    from miniasm_tpu_torch.select import cut

    cols, sub = staged_inputs(np.random.default_rng(5))
    args = (torch.from_numpy(cols).to(dev), torch.from_numpy(sub).to(dev),
            2000)
    got = cut.hit_cut(*args)
    torch.cuda.synchronize()
    want = cut.hit_cut_plain(*args)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert want[1].any() and not want[1].all()


def entry_tail_inputs(rng, n, T):
    """Seeded inputs of the forward step's tail after K5, as numpy: the
    (10, n) int32 columns (qid and tid partly outside [0, T), past the end
    and negative; rev and valid 0, 1 or 2), K5's (4, n) uint32 coordinates
    (a few above 2**31) and bool keep, the uint32 trim starts and ends (a
    tenth with s > e, so that e - s wraps; a few ends near 2**32) and the
    int32 deletion row (0, 1 or 2)."""
    cm = rng.integers(-2**31, 2**31, (10, n))
    for row in (0, 3):
        ids = rng.integers(0, T, n)
        wild = rng.random(n) < 0.1
        ids[wild] = rng.integers(-2 * T - 3, 2 * T + 3, int(wild.sum()))
        cm[row] = ids
    cm[8] = rng.integers(0, 3, n)
    cm[9] = rng.integers(0, 3, n)
    qs = rng.integers(0, 9000, n)
    qs[rng.random(n) < 0.02] = 2**32 - rng.integers(1, 3000)
    ts = rng.integers(0, 9000, n)
    coords = np.stack([qs, qs + rng.integers(0, 9000, n), ts,
                       ts + rng.integers(0, 9000, n)]) % 2**32
    s = rng.integers(0, 12000, T)
    e = s + rng.integers(0, 12000, T)
    back = rng.random(T) < 0.1
    e[back] = s[back] - rng.integers(1, 5000, int(back.sum()))
    e[rng.random(T) < 0.02] = 2**32 - rng.integers(1, 5000)
    dl = rng.integers(0, 3, T) * (rng.random(T) < 0.2)
    return (cm.astype(np.int32), coords.astype(np.uint32),
            rng.random(n) < 0.7, s.astype(np.uint32),
            (e % 2**32).astype(np.uint32), dl.astype(np.int32))


def check_hit2arc_tail(dev, seed, n, T, int_frac):
    """K6 against its plain version on entry_tail_inputs, bit for bit;
    returns the plain version's outputs."""
    from miniasm_tpu_torch.core import hit2arc as h2a

    cm, coords, keep, s, e, dl = entry_tail_inputs(
        np.random.default_rng(seed), n, T)
    sub = np.stack([s.view(np.int32), e.view(np.int32), dl])
    args = [torch.from_numpy(x).to(dev) for x in (
        cm, coords.view(np.int32), keep, sub)] + [1000, int_frac, 2000]
    want = h2a.hit2arc_tail_plain(*args)
    got = h2a.hit2arc_tail(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and torch.equal(g, w)
    return want


@pytest.mark.parametrize("int_frac", [0.5, 0.8])
def test_hit2arc_kernel_matches_plain(dev, int_frac):
    """K6 on the graft entry's kind of inputs at 50,000 columns and 500
    reads, ids outside [0, T) among them."""
    arcs, good, _ = check_hit2arc_tail(dev, 6, 50_000, 500, int_frac)
    assert len(set(arcs[0].clamp(min=-5, max=0).tolist())) == 5
    assert good.any() and not good.all()


@pytest.mark.parametrize("n, T", [(300, 700), (100, 9000), (0, 50)],
                         ids=["few_reads", "many_reads", "no_column"])
def test_hit2arc_kernel_more_reads_than_columns(dev, n, T):
    """K6 where the reads outnumber the columns: the grid covers the T
    reads for sub_del, past the columns' blocks when T is many times n;
    with no column it still writes sub_del."""
    arcs, good, sub_del = check_hit2arc_tail(dev, 7, n, T, 0.8)
    assert arcs.shape == (5, n) and sub_del.shape == (T,)
    assert sub_del.any() and not sub_del.all()


@pytest.mark.parametrize("do_trans", [False, True])
def test_trans_multi_kernel_matches_plain(dev, do_trans):
    from miniasm_tpu_torch.graph import devclean

    g = random_graph(np.random.default_rng(3), n_seq=300, n_pairs=3000)
    c = devclean.build_arcs(g, dev)
    args = (c["first"], c["av"], c["al"], c["sdel_v"], c["D"], 1000,
            do_trans)
    got = devclean.trans_multi(*args)
    torch.cuda.synchronize()
    want = devclean.trans_multi_plain(*args)
    assert torch.equal(got, want)
    assert int((want & 1).sum()) > 0 or not do_trans
    # one rank's block of rows, as the sharded clean runs it
    V = c["first"].shape[0] - 1
    rows = (V // 3, 2 * V // 3)
    a0, a1 = (int(c["first"][r]) for r in rows)
    got = devclean.trans_multi(*args, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want[a0:a1])
    assert torch.equal(devclean.trans_multi_plain(*args, rows=rows), got)


@pytest.mark.parametrize("n_sh", [1, 8])
def test_route_kernel_matches_plain(dev, n_sh):
    from miniasm_tpu_torch.parallel import route as rt

    rng = np.random.default_rng(n_sh)
    L = 300_000
    dest = torch.from_numpy(rng.integers(0, n_sh + 1, L).astype(np.int32))
    payload = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (4, L)).astype(np.int32))
    # random destinations; ties: every row to one bucket, some dropped
    d1 = torch.where(dest == n_sh, n_sh, n_sh - 1).to(torch.int32)
    for d in (dest, d1):
        on_card = rt.Layout(d.to(dev), n_sh)
        on_host = rt.Layout(d, n_sh)
        assert on_card.sizes == on_host.sizes
        # one layout serves two payloads, as the select step's passes
        for p in (payload, payload.flip(1).contiguous()):
            got = rt.route(on_card, p.to(dev))
            torch.cuda.synchronize()
            want = rt.route(on_host, p)
            assert torch.equal(got.cpu(), want)
            assert torch.equal(rt.route_plain(on_card, p.to(dev)).cpu(),
                               want)


def _route_case(kind, n_sh, rng, R):
    """(dest, payload) of a route case: random destinations with dropped
    rows; every row dropped; every row to one bucket; skewed (most rows
    to a few buckets); random on 1 and 4096 +- 1 rows (tiles of 1024)."""
    L = int(kind[1:]) if kind.startswith("L") else 50_000
    if kind == "dropped":
        dest = np.full(L, n_sh)
    elif kind == "one_bucket":
        dest = np.full(L, n_sh // 2)
    elif kind == "skewed":
        dest = np.minimum(rng.zipf(1.3, L) - 1, n_sh)
    else:
        dest = rng.integers(0, n_sh + 1, L)
    payload = rng.integers(-2**31, 2**31 - 1, (R, L))
    return (torch.from_numpy(dest.astype(np.int32)),
            torch.from_numpy(payload.astype(np.int32)))


@pytest.mark.parametrize("R", [4, 7, 11])
@pytest.mark.parametrize("kind", ["random", "dropped", "one_bucket",
                                  "skewed", "L1", "L4095", "L4097"])
@pytest.mark.parametrize("n_sh", [1, 8, 1024])
def test_route_kernel_cases(dev, n_sh, kind, R):
    """The layout pass and the scatter against their plain versions: the
    card's Layout equals the CPU's in sizes, off and total, and route()
    equals route_plain; the layout launches once per Layout, the scatter
    once per payload."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.parallel import route as rt

    rng = np.random.default_rng(1000 * n_sh + 10 * R + len(kind))
    d, p = _route_case(kind, n_sh, rng, R)
    n0 = cuda.launch_counts()
    on_card = rt.Layout(d.to(dev), n_sh)
    on_host = rt.Layout(d, n_sh)
    assert on_card.sizes == on_host.sizes
    assert on_card.total == on_host.total
    assert on_card.off.cpu().tolist() == on_host.off.tolist()
    h, off = rt.layout_plain(d.to(dev), n_sh)
    assert h[1:n_sh + 1] == on_card.sizes
    assert torch.equal(off, on_card.off)
    for q in (p, p.flip(1).contiguous()):
        got = rt.route(on_card, q.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), rt.route(on_host, q))
    n1 = cuda.launch_counts()
    assert n1["route_layout"] - n0["route_layout"] == 1
    assert n1["route"] - n0["route"] == 2


def test_route_layout_raises_on_card(dev):
    from miniasm_tpu_torch.parallel import route as rt

    d = torch.tensor([0, 1, 1, 1, 2, 0] * 1000, dtype=torch.int32,
                     device=dev)
    with pytest.raises(ValueError, match="beyond"):
        rt.Layout(d + 1, 2)
    with pytest.raises(ValueError, match="negative"):
        rt.Layout(d - 1, 2)
    assert rt.Layout(d, 2).sizes == [2000, 3000]


def _noisy_paf(tmp_path):
    """tests/conftest.py's sim_noisy: the 200 kb simulation with half of
    its PAF lines dropped (random.Random(36))."""
    import random

    from miniasm_tpu_torch.eval.simulate import simulate, write_paf

    full = str(tmp_path / "r.paf")
    paf = str(tmp_path / "noisy.paf")
    write_paf(simulate(genome_len=200_000, coverage=20.0, seed=7), full)
    rng = random.Random(36)
    with open(full) as f, open(paf, "w") as g:
        for line in f:
            if rng.random() > 0.50:
                g.write(line)
    return paf


def test_sharded_nccl_world_one_matches_cpu(dev, tmp_path):
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.parallel import group
    from miniasm_tpu_torch.parallel.full import run_sharded
    from miniasm_tpu_torch.pipeline import run

    paf = _noisy_paf(tmp_path)
    want = io.StringIO()
    run(paf, Opt(), out=want, device="cpu")
    g = group.init(0, 1, "file://" + str(tmp_path / "rdv"), device="cuda")
    try:
        assert g.backend == "nccl" and g.device.type == "cuda"
        cuda.reset_launches()
        got = io.StringIO()
        run_sharded(paf, Opt(), out=got)
        torch.cuda.synchronize()
        n = cuda.launch_counts()
    finally:
        group.destroy()
    assert got.getvalue() == want.getvalue() and want.getvalue()
    assert n["route"] == 2 and n["sweep"] == 2 and n["cut_hit2arc"] == 2
    assert n["trans_multi"] > 0


def _sharded_rank(paf, outfn):
    """One rank of test_sharded_gloo_two_ranks_on_one_card."""
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.parallel import group
    from miniasm_tpu_torch.parallel.full import run_sharded

    g = group.current()
    assert g.backend == "gloo" and g.device.type == "cuda"
    buf = io.StringIO()
    run_sharded(paf, Opt(), out=buf)
    if g.rank == 0:
        with open(outfn, "w") as f:
            f.write(buf.getvalue())


def test_sharded_gloo_two_ranks_on_one_card(dev, tmp_path):
    """Gloo runs every collective of run_sharded (scatter, broadcasts,
    all_to_all_single, all_reduce, all_gather) on CUDA tensors."""
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.parallel import group
    from miniasm_tpu_torch.pipeline import run

    paf = _noisy_paf(tmp_path)
    want = io.StringIO()
    run(paf, Opt(), out=want, device="cpu")
    out = str(tmp_path / "g.gfa")
    group.launch(2, _sharded_rank, paf, out, backend="gloo", device="cuda")
    with open(out) as f:
        assert f.read() == want.getvalue()


def test_multihost_gloo_two_ranks_on_one_card(dev, tmp_path):
    import os
    import subprocess
    import sys

    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.pipeline import run

    paf = _noisy_paf(tmp_path)
    want = io.StringIO()
    run(paf, Opt(), out=want, device="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("MINIASM_TPU_TORCH_DEVICE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "miniasm_tpu_torch.parallel.multihost",
         "--coordinator", "file://" + str(tmp_path / "rdv"), "--num-procs",
         "2", "--proc-id", str(k), "--backend", "gloo",
         "--out", str(tmp_path / ("p%d.gfa" % k)), paf],
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for k in range(2)]
    errs = [p.communicate(timeout=600)[1].decode() for p in procs]
    for p, e in zip(procs, errs):
        assert p.returncode == 0, e[-3000:]
    assert (tmp_path / "p0.gfa").read_text() == want.getvalue()


@pytest.mark.parametrize("K", [4, 64])
def test_bubble_bfs_kernel_matches_plain(dev, K):
    from miniasm_tpu_torch.graph import devbub

    g = random_graph(np.random.default_rng(4), n_seq=200, n_pairs=500)
    g.adel[::7] = True  # tombstones: the back-arc test still reads them
    c = devbub._arc_cols(g, dev)
    src = torch.from_numpy(np.flatnonzero(
        c["live_out"].cpu().numpy() >= 2).astype(np.int32)).to(dev)
    args = (c["first"], c["av"], c["al"], c["adel"], c["live_out"], src, K,
            50000)
    got = devbub.bubble_bfs(*args)
    torch.cuda.synchronize()
    want = devbub.bubble_bfs_plain(*args)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def layered_arcs(rng, comps=((12, 3, 0), (20, 4, 0), (20, 3, 4),
                             (40, 4, 0))):
    """K4's columns for components of (layers, width, n_back): a root read
    overlaps the reads of a first layer, each layer's reads overlap reads
    of the next (every read is reached, each arc with its complement), the
    last layer a sink read, the sink one read more; so the root's visited
    set takes the whole component, up to 163 vertices.  n_back tombstoned
    arcs lead from later reads back to the root: the back-arc test aborts
    on them.  Returns ((first, av, al, adel, live_out), sources)."""
    us, vs, ls, dead = [], [], [], []

    def arc(a, b, ln, d=False):
        us.extend([2 * a, 2 * b + 1])
        vs.extend([2 * b, 2 * a + 1])
        ls.extend([ln, ln])
        dead.extend([d, d])

    base = 0
    for layers, width, n_back in comps:
        ids = [[base]] + [[base + 1 + i * width + j for j in range(width)]
                          for i in range(layers)]
        sink = base + 1 + layers * width
        ids.append([sink])
        for cur, nxt in zip(ids, ids[1:]):
            pairs = {(cur[k % len(cur)], b) for k, b in enumerate(nxt)}
            pairs |= {(a, nxt[int(rng.integers(len(nxt)))]) for a in cur}
            for a, b in sorted(pairs):
                arc(a, b, int(rng.integers(100, 1000)))
        arc(sink, sink + 1, 500)
        for _ in range(n_back):
            us.append(2 * int(rng.integers(base + 1, sink + 1)))
            vs.append(2 * base)
            ls.append(500)
            dead.append(True)
        base = sink + 2
    V = 2 * base
    u = np.asarray(us)
    order = np.argsort(u, kind="stable")
    first = np.searchsorted(u[order], np.arange(V + 1)).astype(np.int64)
    adel = np.asarray(dead, np.uint8)[order]
    live_out = np.bincount(u[order][adel == 0], minlength=V)
    cols = (first, np.asarray(vs, np.int32)[order],
            np.asarray(ls, np.int32)[order], adel, live_out.astype(np.int32))
    src = np.flatnonzero(live_out >= 2).astype(np.int32)
    return cols, src


@pytest.mark.parametrize("K", [4, 32, 64, 128, 256])
@pytest.mark.parametrize("max_dist", [3000, 10**6])
def test_bubble_bfs_kernel_large_visited_sets(dev, K, max_dist):
    """Visited sets past 32, 64 and 128 vertices, overflow at every K but
    the largest, distance and back-arc aborts; at K = 64 and 256 also
    with the state in global scratch (smem_cap=0)."""
    from miniasm_tpu_torch.cuda import SMEM_MAX
    from miniasm_tpu_torch.graph import devbub

    cols, src = layered_arcs(np.random.default_rng(11))
    args = tuple(torch.from_numpy(x).to(dev) for x in cols) + (
        torch.from_numpy(src).to(dev), K, max_dist)
    want = devbub.bubble_bfs_plain(*args)
    for cap in [SMEM_MAX] + ([0] if K in (64, 256) else []):
        got = devbub.bubble_bfs(*args, smem_cap=cap)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y), cap
    res = want[0].cpu()
    if max_dist == 10**6:
        assert bool(((res[0] & 2) != 0).any()) == (K < 256)
        assert int(res[1].max()) > min(K - 1, 128)
        assert bool((res[0] & 1).any()) or K < 64
    assert bool(((res[0] & 3) == 0).any())  # aborts


def _dense_graph(kind):
    """Few reads, many overlaps: rows past 256 slots ("wide") or past 32
    ("mid"), many of them to repeated targets."""
    n_seq, n_pairs = {"wide": (20, 8000), "mid": (40, 1500)}[kind]
    return random_graph(np.random.default_rng(12), n_seq=n_seq,
                        n_pairs=n_pairs)


@pytest.mark.parametrize("kind", ["wide", "mid"])
@pytest.mark.parametrize("K", [4, 64])
def test_bubble_bfs_kernel_multi_arcs(dev, kind, K):
    """Rows of hundreds of arcs (chunks of 32) with many arcs to one
    target: the kernel's rounds of revisits against the serial order."""
    from miniasm_tpu_torch.graph import devbub

    g = _dense_graph(kind)
    g.adel[::7] = True
    c = devbub._arc_cols(g, dev)
    src = torch.nonzero(c["live_out"] >= 2).flatten().to(torch.int32)
    args = (c["first"], c["av"], c["al"], c["adel"], c["live_out"], src, K,
            50000)
    got = devbub.bubble_bfs(*args)
    torch.cuda.synchronize()
    for x, y in zip(got, devbub.bubble_bfs_plain(*args)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed", [4, 5])
def test_bubble_dispatch_on_card_reruns_overflow(dev, seed, monkeypatch):
    """_dispatch from K = 4 on the card: each re-run takes only the
    sources that overflowed, and the merged arrays equal one plain run of
    every source at the final K."""
    from miniasm_tpu_torch.graph import devbub

    g = random_graph(np.random.default_rng(seed), n_seq=200, n_pairs=500)
    g.adel[::7] = True
    c = devbub._arc_cols(g, dev)
    cands = np.flatnonzero(c["live_out"].cpu().numpy() >= 2).tolist()
    sizes = []
    orig = devbub.bubble_bfs

    def spy(*a, **k):
        sizes.append(a[5].shape[0])
        return orig(*a, **k)

    monkeypatch.setattr(devbub, "bubble_bfs", spy)
    ok, nb, ntip, sink, vis, par, K = devbub._dispatch(g, cands, 50000, 4,
                                                       dev)
    assert K > 4 and len(sizes) == (K // 4).bit_length()
    assert sizes[0] == len(cands) and all(0 < n < len(cands)
                                          for n in sizes[1:])
    res, v_all, p_all = devbub.bubble_bfs_plain(
        c["first"], c["av"], c["al"], c["adel"], c["live_out"],
        torch.tensor(cands, dtype=torch.int32, device=dev), K, 50000)
    res = res.cpu().numpy()
    assert np.array_equal(ok, (res[0] & 1).astype(bool))
    for got, want in ((nb, res[1]), (ntip, res[2]), (sink, res[3]),
                      (vis, v_all.cpu().numpy()), (par, p_all.cpu().numpy())):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("tomb", [False, True])
@pytest.mark.parametrize("K", [4, 64])
def test_bubble_walk_after_card_dispatch(dev, K, tomb):
    """K4's dispatch on the card, then the native walk, against the
    Python spec (tests/bubwalk_spec.py) on the same verdicts: a braid of
    overlapping bubbles, so many sources go stale behind earlier commits
    and the host BFS redoes them; the tombstones, the packed return and
    the counters equal."""
    import copy

    import bubwalk_spec as spec
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.graph import devbub

    g = spec.braid_graph(np.random.default_rng(23), n_back=400, n_alt=300)
    if tomb:
        g.adel[::7] = True
    live = np.array([g.live_out(v) for v in range(g.n_vtx)])
    cands = np.flatnonzero(live >= 2).astype(np.int32)
    max_dist = Opt().bub_dist
    ver = devbub._dispatch(g, cands, max_dist, K, dev)
    g_spec, g_nat = copy.deepcopy(g), copy.deepcopy(g)
    want = spec.walk(g_spec, cands, ver, max_dist)
    got = devbub.bubble_walk(g_nat, cands, ver, max_dist)
    assert got == want
    assert got[2] > 0 and got[3] > 0
    assert np.array_equal(g_nat.adel, g_spec.adel)
    assert np.array_equal(g_nat.sdel, g_spec.sdel)


def _capped_rows(c, D):
    """K3's columns of build_arcs(...) c with every row cut to its first D
    slots (rows stay sorted by length): the longest row becomes D, and so
    D picks the kernel's lanes per row."""
    first = c["first"].cpu()
    keep = (first[1:] - first[:-1]).clamp(max=D)
    idx = torch.cat([torch.arange(int(f), int(f) + int(k))
                     for f, k in zip(first[:-1], keep)]).to(c["av"].device)
    f2 = torch.zeros_like(first)
    f2[1:] = torch.cumsum(keep, 0)
    return (f2.to(c["av"].device), c["av"][idx].contiguous(),
            c["al"][idx].contiguous(), c["sdel_v"], int(keep.max()))


def _trans_multi_both(dev, first, av, al, sdel_v, D, do_trans):
    """K3 against its plain version, whole and through rows=; returns the
    bits."""
    from miniasm_tpu_torch.graph import devclean

    args = (first, av, al, sdel_v, D, 1000, do_trans)
    want = devclean.trans_multi_plain(*args)
    got = devclean.trans_multi(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    V = first.shape[0] - 1
    rows = (V // 4, V // 2 + 3)
    a0, a1 = (int(first[r]) for r in rows)
    got = devclean.trans_multi(*args, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want[a0:a1])
    return want


@pytest.mark.parametrize("D", [1, 2, 3, 5, 9, 17, 32])
@pytest.mark.parametrize("do_trans", [False, True])
def test_trans_multi_kernel_each_group_size(dev, D, do_trans):
    """The lanes per row follow the longest row D (1, 2, 4, 8, 16, 32, 32
    here): every instance of the kernel on a dense random graph whose rows
    are cut to D slots."""
    from miniasm_tpu_torch.graph import devclean

    c = devclean.build_arcs(_dense_graph("mid"), dev)
    first, av, al, sdel_v, Dm = _capped_rows(c, D)
    assert Dm == D
    want = _trans_multi_both(dev, first, av, al, sdel_v, D, do_trans)
    assert bool((want & 1).any()) == (do_trans and D > 1)
    assert bool((want & 2).any()) or D < 3


@pytest.mark.parametrize("kind", ["wide", "mid"])
@pytest.mark.parametrize("do_trans", [False, True])
def test_trans_multi_kernel_long_rows(dev, kind, do_trans):
    """Rows of more than 32 slots ("mid") and more than 256 ("wide"): 32
    lanes take a row's slots and its neighbours' arcs 32 at a time."""
    from miniasm_tpu_torch.graph import devclean

    c = devclean.build_arcs(_dense_graph(kind), dev)
    assert c["D"] > {"wide": 256, "mid": 32}[kind]
    want = _trans_multi_both(dev, c["first"], c["av"], c["al"], c["sdel_v"],
                             c["D"], do_trans)
    assert bool((want & 2).any())
    assert bool((want & 1).any()) == do_trans


@pytest.mark.parametrize("fmt", ["ug", "sg", "bed"])
def test_run_on_card_matches_cpu(dev, tmp_path, fmt):
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.eval.simulate import simulate, write_paf
    from miniasm_tpu_torch.pipeline import run

    paf = str(tmp_path / "r.paf")
    write_paf(simulate(genome_len=200_000, coverage=20.0, seed=7), paf)
    outs = {}
    cuda.reset_launches()
    for d in ("cpu", "cuda"):
        buf = io.StringIO()
        run(paf, Opt(), outfmt=fmt, out=buf, device=d)
        outs[d] = buf.getvalue()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]
    n = cuda.launch_counts()
    assert n["cut_hit2arc"] == 2 and n["sweep"] == 2
    assert (n["trans_multi"] > 0) == (fmt != "bed")


@pytest.mark.parametrize("args", [["-1"], ["-2", "-p", "sg"],
                                  ["-1", "-2"], ["-S", "4", "-p", "bed"],
                                  ["-1", "-p", "paf"]],
                         ids=lambda a: "".join(a))
def test_staged_run_on_card_matches_cpu(dev, tmp_path, args):
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.eval.simulate import simulate, write_paf
    from miniasm_tpu_torch.pipeline import run

    paf = str(tmp_path / "r.paf")
    write_paf(simulate(genome_len=200_000, coverage=20.0, seed=7), paf)
    kw = {"no_first": "-1" in args, "no_second": "-2" in args,
          "stage": int(args[args.index("-S") + 1]) if "-S" in args else 100,
          "outfmt": args[args.index("-p") + 1] if "-p" in args else "ug"}
    outs = {}
    cuda.reset_launches()
    for d in ("cpu", "cuda"):
        buf = io.StringIO()
        run(paf, Opt(), out=buf, device=d, **kw)
        outs[d] = buf.getvalue()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]
    n = cuda.launch_counts()
    # every run compacts (K16) and either filters (K17) or marks (K18);
    # K6 is the graft entry's alone
    assert n["cut_hit2arc"] == 0 and n["hit2arc"] == 0
    assert n["compact"] > 0 and n["hit_flt"] + n["hit_marks"] > 0


I32MAX = 2**31 - 1


def _member_inputs(case, rng):
    """(hay columns, hay_n, needle columns, needle_n, needle_xor) as int32
    numpy columns for K7."""
    if case == "empty_hay":
        h = [np.zeros(0, np.int32)] * 2
        return h, 0, [rng.integers(-1, 3, 100)] * 2, 100, 0
    if case == "empty_needles":
        return [rng.integers(0, 9, 100)], 100, [np.zeros(0, np.int32)], 0, 0
    if case == "one":
        return [np.array([7]), np.array([-1])], 1, \
            [np.array([7]), np.array([-1])], 1, 0
    if case == "marker":
        # (-1, -1) packs to all ones, the bytes of an empty table slot: in
        # the hay and among the needles, and -1 alone in one column
        h = [np.array([-1, 2, -1]), np.array([-1, -1, 3])]
        q = [np.array([-1, -1, 2, -1, -1]), np.array([-1, 3, 0, -1, -1])]
        return h, 3, q, 4, 0
    if case == "marker_absent":
        h = [rng.integers(-3, 3, 5000), rng.integers(0, 3, 5000)]
        q = [np.full(3000, -1), np.full(3000, -1)]
        return h, 5000, q, 3000, 0
    if case == "marker_one_col":
        return [np.array([-1, 4])], 2, [np.array([-1, 4, 5, -1])], 3, 0
    if case == "pads":
        # INT32_MAX pads (hay_n < mh), dead needles (needle_n < mq), and
        # (-1, -1) beside them
        h = [np.concatenate([rng.integers(-5, 5, 3000), [-1, I32MAX]]),
             np.concatenate([rng.integers(-5, 5, 3000), [-1, I32MAX]])]
        q = [np.concatenate([[I32MAX, I32MAX, -1], rng.integers(-6, 6, 4000)]),
             np.concatenate([[I32MAX, 0, -1], rng.integers(-6, 6, 4000)])]
        return h, 2500, q, 3500, 0
    if case == "pads_one_col":
        h = [np.concatenate([rng.integers(-50, 50, 300), [I32MAX]])]
        q = [np.concatenate([[I32MAX], rng.integers(-60, 60, 500)])]
        return h, 200, q, 450, 0
    if case == "all_dups":
        h = [np.full(5000, 42), np.full(5000, 42)]
        q = [rng.integers(40, 45, 8000), rng.integers(41, 44, 8000)]
        return h, 5000, q, 6000, 0
    if case == "extremes":
        vals = np.array([-2**31, -2**31 + 1, I32MAX, -1, -2, 0, 1])
        h = [rng.choice(vals, 4000), rng.choice(vals, 4000)]
        q = [rng.choice(vals, 4000), rng.choice(vals, 4000)]
        return h, 3900, q, 4000, 1
    if case == "complements":  # del_asymm's call: (u, v) against (v^1, u^1)
        u, v = rng.integers(0, 40_000, 100_000), rng.integers(0, 40_000, 100_000)
        return [u, v], 100_000, [v, u], 100_000, 1
    if case == "beyond_l2":
        # 4,194,304 hay keys: the table (128 MB) leaves L2
        n = 1 << 22
        h = [rng.integers(-2**31, 2**31, n), rng.integers(-2**31, 2**31, n)]
        q = [np.concatenate([h[0][:n // 2], rng.integers(-2**31, 2**31, n // 2)]),
             np.concatenate([h[1][:n // 2], rng.integers(-2**31, 2**31, n // 2)])]
        return h, n - 1000, q, n - 10, 0
    assert case == "random"
    h = [rng.integers(-2**31, 2**31, 200_000), rng.integers(0, 9, 200_000)]
    q = [np.concatenate([h[0][:100_000], rng.integers(-2**31, 2**31, 100_000)]),
         np.concatenate([h[1][:100_000], rng.integers(0, 9, 100_000)])]
    return h, 200_000, q, 150_000, 0


def _cols(cols, dev):
    return [torch.from_numpy(np.asarray(c).astype(np.int32)).to(dev)
            for c in cols]


@pytest.mark.parametrize("case", ["empty_hay", "empty_needles", "one",
                                  "marker", "marker_absent",
                                  "marker_one_col", "pads", "pads_one_col",
                                  "all_dups", "extremes", "complements",
                                  "beyond_l2", "random"])
def test_key_member_kernel_matches_plain(dev, case):
    from miniasm_tpu_torch.utils import arrays

    h, hn, q, qn, xr = _member_inputs(case, np.random.default_rng(7))
    args = (_cols(h, dev), hn, _cols(q, dev), qn, xr)
    n0 = arrays.K_MEMBER.launches
    got = arrays.key_member(*args)
    torch.cuda.synchronize()
    want = arrays.key_member_plain(*args)
    assert torch.equal(got, want)
    assert arrays.K_MEMBER.launches == n0 + (len(q[0]) > 0)
    if case in ("marker", "marker_one_col"):
        assert got.tolist() == {"marker": [True, True, False, True, False],
                                "marker_one_col": [True, True, False,
                                                   False]}[case]
    if case in ("pads", "pads_one_col", "extremes", "complements",
                "beyond_l2", "random"):
        assert want.any() and not want.all()
    if case == "marker_absent":
        assert not want.any()


def _dup_inputs(case, rng):
    """(u, v) int32 numpy arc columns for K8."""
    n = {"empty": 0, "one": 1, "one_marker": 1, "marker": 20_000,
         "all_dups": 100_000, "far_dups": 300_000, "extremes": 50_000,
         "beyond_l2": 1 << 22, "random": 300_000}[case]
    if case == "one_marker":
        return np.full(1, -1), np.full(1, -1)
    if case == "marker":  # (-1, -1), all ones as an empty slot, a third
        u, v = rng.integers(-1, 2, n), rng.integers(-1, 1, n)
        return u, v
    if case == "all_dups":  # every arc the same key
        return np.full(n, 5), np.full(n, 6)
    if case == "far_dups":
        # every key twice, the copies half an array apart
        u, v = rng.integers(0, 2**30, n // 2), rng.integers(0, 2**30, n // 2)
        p = rng.permutation(n // 2)
        return np.concatenate([u, u[p]]), np.concatenate([v, v[p]])
    if case == "extremes":
        vals = np.array([-2**31, -2**31 + 1, I32MAX, -1, -2, 0, 1])
        return rng.choice(vals, n), rng.choice(vals, n)
    if case == "beyond_l2":
        # 4,194,304 arcs from a million pairs: the table (128 MB) leaves L2
        return rng.integers(0, 1024, n), rng.integers(0, 1024, n)
    return rng.integers(0, max(n // 50, 1), n), rng.integers(0, 50, n)


@pytest.mark.parametrize("case", ["empty", "one", "one_marker", "marker",
                                  "all_dups", "far_dups", "extremes",
                                  "beyond_l2", "random"])
def test_dup_mark_kernel_matches_plain(dev, case):
    from miniasm_tpu_torch.graph import clean

    u, v = _dup_inputs(case, np.random.default_rng(8))
    uc, vc = _cols([u, v], dev)
    n0 = clean.K_DUP.launches
    got = clean.dup_mark(uc, vc)
    torch.cuda.synchronize()
    want = clean.dup_mark_plain(uc, vc)
    assert torch.equal(got, want)
    assert clean.K_DUP.launches == n0 + (len(u) > 0)
    pairs = set(zip(np.asarray(u, np.int32).tolist(),
                    np.asarray(v, np.int32).tolist()))
    assert int(want.sum()) == len(u) - len(pairs)
    if case == "far_dups":
        h = len(u) // 2
        assert not want[:h].any() and want[h:].sum() > 0


def test_symm_wrappers_raise_on_card(dev):
    """K7 and K8 take contiguous int32 columns on one card; anything else
    raises, nothing falls back to the plain version."""
    from miniasm_tpu_torch.graph import clean
    from miniasm_tpu_torch.utils import arrays

    c = torch.arange(8, dtype=torch.int32, device=dev)
    bad = [c.to(torch.int64), c.view(4, 2)[:, 0], c.cpu()]
    for b in bad:
        with pytest.raises((TypeError, ValueError)):
            clean.dup_mark(c, b) if b.numel() == 8 else \
                clean.dup_mark(c[:4], b)
        with pytest.raises((TypeError, ValueError)):
            arrays.key_member([c], 8, [b], 8)


@pytest.mark.parametrize("mode,args", [
    ("native", ["-p", "ug"]), ("py", ["-p", "sg"]),
    ("hybrid", ["-R", "-f", "FA"]), ("py", ["-1", "-R", "-f", "FA"])],
    ids=lambda x: x if isinstance(x, str) else "".join(x))
def test_oracle_and_flags_on_card_match_cpu(dev, tmp_path, monkeypatch,
                                            mode, args):
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.eval.simulate import simulate, write_fasta, \
        write_paf
    from miniasm_tpu_torch.pipeline import run

    paf, fa = str(tmp_path / "r.paf"), str(tmp_path / "r.fa")
    sim = simulate(genome_len=200_000, coverage=20.0, seed=7)
    write_paf(sim, paf)
    write_fasta(sim, fa)
    monkeypatch.setenv("MINIASM_TPU_CLEAN", mode)
    kw = {"no_first": "-1" in args, "no_cont": "-R" in args,
          "fn_reads": fa if "-f" in args else None,
          "outfmt": args[args.index("-p") + 1] if "-p" in args else "ug"}
    outs = {}
    cuda.reset_launches()
    for d in ("cpu", "cuda"):
        buf = io.StringIO()
        run(paf, Opt(), out=buf, device=d, **kw)
        outs[d] = buf.getvalue()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]
    n = cuda.launch_counts()
    oracle = mode != "hybrid"
    assert (n["key_member"] > 0) == oracle and (n["dup_mark"] > 0) == oracle


def test_empty_input_on_card(dev, tmp_path):
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.pipeline import run

    paf = str(tmp_path / "empty.paf")
    open(paf, "w").close()
    for kw in ({}, {"no_first": True}):  # the main and the staged path
        outs = []
        for d in ("cpu", "cuda"):
            buf = io.StringIO()
            run(paf, Opt(), outfmt="ug", out=buf, device=d, **kw)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]


def _fmt3_piece(rng, n, runs):
    """A flat FMT3 piece of n records: random coordinate words and flag
    nibbles, `runs` run starts ascending from 0, the tail -1."""
    m = n // 8
    coords = rng.integers(-2**31, 2**31, 3 * n)
    words = rng.integers(0, 2**32, m)
    bp = np.full(m, -1, np.int64)
    bp[:runs] = np.concatenate(
        [[0], np.sort(rng.choice(np.arange(1, n), runs - 1, replace=False))])
    bq = np.where(bp >= 0, rng.integers(0, 2**28, m), 0)
    flat = np.concatenate([coords, words, bp, bq])
    return (flat & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _fmt3_with_starts(rng, n, starts):
    """_fmt3_piece of n records whose run table is `starts` (ascending,
    repeats allowed), the rest of the table -1."""
    flat = _fmt3_piece(rng, n, 2).astype(np.int64)
    m = n // 8
    bp = np.full(m, -1, np.int64)
    bp[:len(starts)] = starts
    flat[3 * n + m:3 * n + 2 * m] = bp
    flat[3 * n + 2 * m:] = np.where(bp >= 0, rng.integers(0, 2**28, m), 0)
    return (flat & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _decode3_case(case, rng):
    """The flat piece of one decode3 case: the seeded pieces, and the edge
    cases of the run table (the first run after record 0, one run over the
    piece, every run in the last 16 records, equal starts) on tiles of
    1024 records and on a whole 131,072-record piece."""
    runs = {"sixteen": (16, 2), "padded": (4096, 37), "full": (4096, 512),
            "all_zero": (4096, 0), "large": (1 << 19, 20_000),
            "piece": (1 << 17, 4000)}
    if case in runs:
        n, k = runs[case]
        return (np.zeros(3 * n + 3 * (n // 8), np.int32) if not k
                else _fmt3_piece(rng, n, k))
    n = 1 << 17 if case.endswith("_piece") else 4096 + 16
    m = n // 8
    starts = {"late_first_run": lambda: np.sort(
                  rng.choice(np.arange(1500, n), m // 3, False)),
              "one_run": lambda: [0],
              "runs_in_last_16": lambda: np.sort(
                  rng.integers(n - 16, n, m)),
              "duplicate_starts": lambda: np.sort(
                  rng.integers(0, n, m // 2))}[case.replace("_piece", "")]()
    return _fmt3_with_starts(rng, n, starts)


@pytest.mark.parametrize("case", [
    "sixteen", "padded", "full", "all_zero", "large", "piece",
    "late_first_run", "one_run", "runs_in_last_16", "duplicate_starts",
    "late_first_run_piece", "one_run_piece", "runs_in_last_16_piece",
    "duplicate_starts_piece"])
def test_decode3_kernel_matches_plain(dev, case):
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.io.native import pafload

    flat = _decode3_case(case, np.random.default_rng(9))
    before = cuda.launch_counts()["decode3"]
    got = pafload.decode3(torch.from_numpy(flat).to(dev))
    torch.cuda.synchronize()
    assert cuda.launch_counts()["decode3"] == before + 1
    want = pafload.decode3_plain(torch.from_numpy(flat))
    assert torch.equal(got.cpu(), want)


def test_decode3_kernel_unaligned_piece(dev):
    """A piece that starts 4 bytes past a 16-byte boundary (the kernel
    moves 16-byte words) decodes as an aligned one."""
    from miniasm_tpu_torch.io.native import pafload

    flat = torch.from_numpy(_decode3_case("padded",
                                          np.random.default_rng(4)))
    buf = torch.empty(flat.shape[0] + 1, dtype=torch.int32, device=dev)
    buf[1:] = flat.to(dev)
    got = pafload.decode3(buf[1:])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), pafload.decode3_plain(flat))


def _u4_pieces(rng, spec):
    """Seeded (piece, n) pairs of K10 on the CPU: spec lists (rows, width,
    n) with rows 4 (random packed words) or 7 (random colmat columns)."""
    return [(torch.from_numpy(rng.integers(0, 2**32, (rows, m))
                              .astype(np.uint32).view(np.int32)), n)
            for rows, m, n in spec]


def test_unpack4_kernel_matches_plain(dev):
    """K10, one launch a call: one whole piece; then 4-row and 7-row
    pieces of odd counts (so every piece after the first starts at a
    column offset that no 16-byte access would take) into a colmat wider
    than the pieces, whose other columns stay untouched."""
    from miniasm_tpu_torch.io.native import pafload

    rng = np.random.default_rng(10)
    (packed, _), = _u4_pieces(rng, [(4, 300_000, 300_000)])
    want = pafload.unpack4_plain(packed)
    before = _count("unpack4")
    got = pafload.unpack4([(packed.to(dev), 300_000)])
    torch.cuda.synchronize()
    assert _count("unpack4") - before == 1
    assert torch.equal(got.cpu(), want)
    pieces = _u4_pieces(rng, [(4, 131_072, 131_071), (7, 5_003, 5_003),
                              (4, 1_000, 17), (7, 64, 1), (4, 4_096, 4_093),
                              (7, 70_001, 69_999)])
    total = sum(n for _p, n in pieces)
    want = pafload.unpack4_pieces_plain(pieces)
    out = torch.full((7, total + 333), -7, dtype=torch.int32, device=dev)
    before = _count("unpack4")
    pafload.unpack4([(p.to(dev), n) for p, n in pieces], out)
    torch.cuda.synchronize()
    assert _count("unpack4") - before == 1
    o = out.cpu()
    assert torch.equal(o[:, :total], want)
    assert (o[:, total:] == -7).all()


@pytest.mark.parametrize("k", [1, 112, 113, 250])
def test_unpack4_kernel_piece_counts(dev, k):
    """K10 over k pieces of 1 to 3,000 records, 4 and 7 rows mixed: one
    launch per UNPACK4_MAX pieces (the pieces one struct of kernel
    parameters holds), bit-equal to the plain version."""
    from miniasm_tpu_torch.io.native import pafload

    rng = np.random.default_rng(100 + k)
    spec = []
    for _ in range(k):
        n = int(rng.integers(1, 3_000))
        spec.append((int(rng.choice([4, 7])), n + int(rng.integers(0, 40)),
                     n))
    pieces = _u4_pieces(rng, spec)
    before = _count("unpack4")
    got = pafload.unpack4([(p.to(dev), n) for p, n in pieces])
    torch.cuda.synchronize()
    assert _count("unpack4") - before == -(-k // pafload.UNPACK4_MAX)
    assert torch.equal(got.cpu(), pafload.unpack4_pieces_plain(pieces))


def test_unpack4_kernel_near_2_27_records(dev):
    """K10 over pieces of (1 << 27) - 3 records in all, made on the card:
    bit-equal to the plain version on the card."""
    from miniasm_tpu_torch.io.native import pafload

    g = torch.Generator(device=dev)
    g.manual_seed(27)
    big = (1 << 27) - 3 - 131_075
    pieces = [(torch.randint(-2**31, 2**31 - 1, (rows, m), generator=g,
                             dtype=torch.int32, device=dev), n)
              for rows, m, n in ((4, big + 5, big), (7, 131_072, 131_072),
                                 (4, 3, 3))]
    got = pafload.unpack4(pieces)
    torch.cuda.synchronize()
    assert got.shape == (7, (1 << 27) - 3)
    assert torch.equal(got, pafload.unpack4_pieces_plain(pieces))


def _ladder_paf(tmp_path, case):
    """A PAF of one case of the loader's format ladder."""
    from miniasm_tpu_torch.eval.simulate import simulate, write_paf

    paf = str(tmp_path / ("%s.paf" % case))
    write_paf(simulate(genome_len=200_000, coverage=20.0, seed=7), paf)
    if case == "shuffled":  # one run per record: the sideband overflows
        import random

        with open(paf) as f:
            lines = f.readlines()
        random.Random(36).shuffle(lines)
        with open(paf, "w") as f:
            f.writelines(lines)
    elif case == "long":  # 17-bit coordinates in the last record
        with open(paf, "a") as f:
            f.write("ul_a\t90000\t10\t89000\t+\tul_b\t90000\t1000\t"
                    "89990\t85000\t88990\t255\n")
    return paf


@pytest.mark.parametrize("case,fmt3,chunk", [
    ("grouped", "1", 4096), ("grouped", "0", 4096), ("shuffled", "1", 4096),
    ("long", "1", 4096), ("grouped", "0", 256)])
def test_loader_on_card_matches_cpu(dev, tmp_path, monkeypatch, case, fmt3,
                                    chunk):
    """The colmat of the loader's ladder on the card equal to the CPU's:
    K9 once a FMT3 piece, K10 once a load (at chunk 256, pieces of 64
    records: more than one launch's struct holds, so once per
    UNPACK4_MAX pieces)."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.io.native import pafload

    monkeypatch.setattr(pafload, "_CHUNK", chunk)  # several pieces
    monkeypatch.setenv("MINIASM_TPU_FMT3", fmt3)
    paf = _ladder_paf(tmp_path, case)
    cols = {}
    for d in ("cpu", "cuda"):
        cuda.reset_launches()
        c, _, h = pafload.load_hits_mt(paf, 2000, 100,
                                       device=torch.device(d))
        torch.cuda.synchronize()
        cols[d] = c.cpu()
        h.free()
    assert torch.equal(cols["cuda"], cols["cpu"])
    n = cuda.launch_counts()
    pieces = -(-cols["cpu"].shape[1] // (chunk >> 2))
    launches = -(-pieces // pafload.UNPACK4_MAX)
    if case == "grouped" and fmt3 == "1":
        assert n["decode3"] == pieces and n["unpack4"] == 1
    elif case == "long":
        assert n["decode3"] == pieces - 1 and n["unpack4"] == 1
    else:
        assert n["decode3"] == 0 and n["unpack4"] == launches
    if chunk == 256:
        assert launches > 1


@pytest.mark.parametrize("args", [["-p", "paf"], ["-R", "-p", "paf"],
                                  ["-b", "-p", "paf"]],
                         ids=lambda a: "".join(a))
def test_main_path_paf_on_card_matches_cpu(dev, tmp_path, args):
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.pipeline import run

    paf = _ladder_paf(tmp_path, "grouped")
    outs = {}
    for d in ("cpu", "cuda"):
        buf = io.StringIO()
        run(paf, Opt(), outfmt="paf", out=buf, device=d,
            no_cont="-R" in args, bi_dir="-b" not in args)
        outs[d] = buf.getvalue()
    assert outs["cuda"] == outs["cpu"] and outs["cpu"]


def test_snapshot_restore_on_card(dev, tmp_path):
    """The second run restores: no select or loader kernel launches, and
    the bytes of the first."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.pipeline import run

    paf = _ladder_paf(tmp_path, "grouped")
    snap = str(tmp_path / "snap")
    outs = []
    for _ in range(2):
        cuda.reset_launches()
        buf = io.StringIO()
        run(paf, Opt(), out=buf, device="cuda", snapshot_dir=snap)
        outs.append(buf.getvalue())
    n = cuda.launch_counts()
    assert outs[0] == outs[1] and outs[0]
    assert all(n[k] == 0 for k in ("cut_hit2arc", "sweep", "decode3",
                                   "unpack4"))


def test_entry_forward_step_matches_plain(dev):
    """The graft entry's forward step on the card (K2 `sweep`, K5
    `hit_cut`, K6 `hit2arc`, one launch each) against the same step on
    the CPU (their plain versions), bit for bit on all 4,096 columns; by
    torch.profiler's device events, in a process of its own (a session
    here would leave the later tests' sessions without some kernels), K6
    is the one device event after K5."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.eval import dryrun

    fwd, (cm,) = dryrun.entry(device="cuda")
    cuda.reset_launches()
    got = fwd(cm)
    torch.cuda.synchronize()
    n = cuda.launch_counts()
    pfwd, (pcm,) = dryrun.entry(device="cpu")
    want = pfwd(pcm)
    assert torch.equal(cm.cpu(), pcm)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert int(want[0].sum()) > 0
    assert {k: v for k, v in n.items() if v} == {
        "sweep": 1, "hit_cut": 1, "hit2arc": 1}
    names = _child_event_names("entry")
    k5 = [i for i, name in enumerate(names) if "hit_cut_kernel" in name]
    assert len(k5) == 1
    tail = names[k5[0] + 1:]
    assert len(tail) == 1 and "hit2arc_kernel" in tail[0]


def test_dryrun_multichip_nccl_one_rank(dev, capfd):
    """dryrun_multichip(1) on a one-rank NCCL group: the sharded GFA is the
    single-card run's bytes (the function asserts it) and the CPU run's."""
    import os
    import tempfile

    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.eval.dryrun import dryrun_multichip, dryrun_paf
    from miniasm_tpu_torch.pipeline import run

    gfa = dryrun_multichip(1)
    assert "dryrun_multichip: n_devices=1 " in capfd.readouterr().out
    with tempfile.TemporaryDirectory() as td:
        paf = os.path.join(td, "reads.paf")
        dryrun_paf(paf)
        want = io.StringIO()
        run(paf, Opt(), out=want, device="cpu")
    assert gfa == want.getvalue() and gfa


@pytest.mark.parametrize("fmt", ["ug", "sg", "bed"])
def test_v2_loader_on_card_matches_cpu(dev, tmp_path, monkeypatch, fmt):
    """MINIASM_TPU_LOADER=v2: one copy of the colmat, no K9 or K10, the
    select and clean kernels as on the default loader, and the bytes of
    the CPU run and of the default loader."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.pipeline import run

    paf = _ladder_paf(tmp_path, "grouped")
    outs = {}
    for loader in ("mt", "v2"):
        if loader == "v2":
            monkeypatch.setenv("MINIASM_TPU_LOADER", "v2")
        for d in ("cpu", "cuda"):
            cuda.reset_launches()
            buf = io.StringIO()
            run(paf, Opt(), outfmt=fmt, out=buf, device=d)
            outs[loader, d] = buf.getvalue()
        n = cuda.launch_counts()
        assert n["cut_hit2arc"] == 2 and n["sweep"] == 2
        assert (n["decode3"] > 0) == (loader == "mt")
        assert (n["unpack4"] > 0) == (loader == "mt")
    assert len(set(outs.values())) == 1 and outs["v2", "cpu"]


def test_profile_trace_holds_kernels(dev, tmp_path, monkeypatch, capsys):
    """MINIASM_TPU_PROFILE on the card: the trace holds the kernels of the
    run under their names, on the card's streams, beside the stage
    ranges; stdout is the run's without the profiler."""
    import json
    import os

    from miniasm_tpu_torch import cli
    from miniasm_tpu_torch.device import ENV

    paf = _ladder_paf(tmp_path, "grouped")
    monkeypatch.setenv(ENV, "cuda")
    assert cli.main(["-p", "ug", paf]) == 0
    want = capsys.readouterr().out
    prof = str(tmp_path / "prof")
    monkeypatch.setenv("MINIASM_TPU_PROFILE", prof)
    assert cli.main(["-p", "ug", paf]) == 0
    cap = capsys.readouterr()
    assert cap.out == want and "profiler trace written" in cap.err
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    for name in ("cut_hit2arc_kernel", "ev_sweep", "trans_multi_kernel",
                 "decode3_kernel", "unpack4_kernel"):
        assert any(name in k for k in kernels), (name, sorted(kernels))
    assert any(str(e.get("name")).startswith("stage:") for e in events)


@pytest.mark.parametrize("k", [0, 1])
def test_fuzz_cases_on_card(dev, k):
    """Two seeded fuzz cases, the port on the card against the port on
    the CPU."""
    import random

    from miniasm_tpu_torch.eval import fuzz

    rng = random.Random(5)
    cases = [fuzz.draw_case(rng) for _ in range(2)]
    rec = fuzz.run_case(cases[k], "cuda")
    assert rec["ok"], rec


# ---------------------------------------------------------------------------
# K12 read_marks, K13 arc_order (the select program's tail), K14
# clean_stage_b (the clean program's stage B)


def tail_inputs(rng, n=60_000, T=3000, start_hi=5000, read_p=None):
    """Random (colmat, final-pass output, marks, mdel) for K12 and K13:
    lanes, hit2arc codes (arcs and the four negative codes), self rows,
    palindromic self rows (rev, equal cut coordinates) and mostly
    surviving reads; qids drawn with probabilities read_p."""
    from miniasm_tpu_torch.core.hit2arc import MA_HT_QCONT

    qid = rng.choice(T - 2, n, p=read_p)
    tid = np.where(rng.random(n) < 0.05, qid, rng.integers(0, T - 2, n))
    qs = rng.integers(0, start_hi, n)
    ts = rng.integers(0, start_hi, n)
    colmat = np.stack([qid, qs, qs + 3000, tid, ts, ts + 3000,
                       rng.integers(0, 8, n)]).astype(np.int32)
    out = rng.integers(0, 20000, (15, n))
    out[4] = rng.integers(0, 4, n)
    for r in (5, 10):
        out[r] = np.where(rng.random(n) < 0.5, rng.integers(0, 9000, n),
                          rng.integers(MA_HT_QCONT - 2, 0, n))
    pal = rng.random(n) < 0.3
    out[2] = np.where(pal, out[0], out[2])
    out[3] = np.where(pal, out[1], out[3])
    tab = rng.choice([1, 5, 3, 0], T, p=[0.6, 0.2, 0.15, 0.05])
    mdel = rng.random(T) < 0.05
    t = [torch.from_numpy(np.ascontiguousarray(x.astype(np.int32)))
         for x in (colmat, out, tab)]
    return t[0], t[1], t[2], torch.from_numpy(mdel)


def arc_inputs(rng, n=60_000, T=3000, start_hi=5000, read_p=None):
    """Random (colmat, final-pass output, mdel) for K13, whose marks come
    from the rows: lanes, hit2arc codes (half arcs, the rest internal or
    short, and one in fifty of those a containment), self rows,
    palindromic self rows (rev, equal cut coordinates); qids drawn with
    probabilities read_p.  The first tenth of the reads (the heavy ones
    under read_p) is never contained nor sub-deleted, so that their arcs
    survive."""
    from miniasm_tpu_torch.core.hit2arc import MA_HT_QCONT, MA_HT_TCONT

    qid = rng.choice(T - 2, n, p=read_p)
    tid = np.where(rng.random(n) < 0.05, qid, rng.integers(0, T - 2, n))
    qs = rng.integers(0, start_hi, n)
    ts = rng.integers(0, start_hi, n)
    colmat = np.stack([qid, qs, qs + 3000, tid, ts, ts + 3000,
                       rng.integers(0, 8, n)]).astype(np.int32)
    out = rng.integers(0, 20000, (15, n))
    out[4] = rng.integers(0, 4, n)
    keep = T // 10
    for r, (marks_q, marks_t) in ((5, (qid, tid)), (10, (tid, qid))):
        neg = np.where(rng.random(n) < 0.02,
                       rng.choice([MA_HT_QCONT, MA_HT_TCONT], n),
                       rng.choice([-1, -4], n))
        # QCONT marks the side's query, TCONT its target
        hit = np.where(neg == MA_HT_QCONT, marks_q, marks_t)
        neg = np.where(((neg == MA_HT_QCONT) | (neg == MA_HT_TCONT))
                       & (hit < keep), -1, neg)
        out[r] = np.where(rng.random(n) < 0.5, rng.integers(0, 9000, n), neg)
    pal = rng.random(n) < 0.3
    out[2] = np.where(pal, out[0], out[2])
    out[3] = np.where(pal, out[1], out[3])
    mdel = (rng.random(T) < 0.05) & (np.arange(T) >= keep)
    t = [torch.from_numpy(np.ascontiguousarray(x.astype(np.int32)))
         for x in (colmat, out)]
    return t[0], t[1], torch.from_numpy(mdel)


def test_read_marks_kernel_matches_plain(dev):
    from miniasm_tpu_torch.select import fused2

    colmat, out, _, _ = (x.to(dev) for x in tail_inputs(
        np.random.default_rng(11)))
    T = 3000
    got = fused2.read_marks(colmat, out, T)
    torch.cuda.synchronize()
    want = fused2.read_marks_plain(colmat, out, T)
    assert torch.equal(got, want)
    # every mark word occurs, 5 and 3 among them
    assert set(want.unique().tolist()) >= {0, 1, 3, 5}


def test_read_marks_kernel_max_not_or(dev):
    """A palindromic self row (5) and a containment row (3) of one read:
    the kernel keeps 5, as its twin and both packages do."""
    from miniasm_tpu_torch.core.hit2arc import MA_HT_QCONT
    from miniasm_tpu_torch.select import fused2

    colmat = torch.tensor([[1, 1], [100, 0], [5000, 4000], [1, 2],
                           [100, 10], [5000, 4010], [3, 1]],
                          dtype=torch.int32, device=dev)
    out = torch.zeros((15, 2), dtype=torch.int32, device=dev)
    out[:4] = colmat[[1, 2, 4, 5]]
    out[4] = 1
    out[5] = torch.tensor([1200, MA_HT_QCONT], device=dev)
    got = fused2.read_marks(colmat, out, 4)
    assert got.tolist() == [0, 5, 1, 0]
    assert torch.equal(got, fused2.read_marks_plain(colmat, out, 4))


def _one_read_warp(dev, side):
    """32 rows, one warp, every row's query (side "q") or target ("t")
    read 1: row 0 a palindromic self hit (5), rows 1-3 containments of
    read 1 (3), the rest used only (1); the other reads 2..33."""
    from miniasm_tpu_torch.core.hit2arc import MA_HT_QCONT, MA_HT_TCONT

    n = 32
    other = torch.arange(2, 2 + n, dtype=torch.int32)
    one = torch.ones(n, dtype=torch.int32)
    q, t = (one, other) if side == "q" else (other, one)
    q[0] = t[0] = 1
    s = torch.arange(n, dtype=torch.int32) * 10
    colmat = torch.stack([q, s, s + 5000, t, s, s + 5000,
                          torch.full((n,), 3, dtype=torch.int32)])
    out = torch.zeros((15, n), dtype=torch.int32)
    out[:4] = colmat[[1, 2, 4, 5]]
    out[4] = 3
    out[5] = 100
    out[10] = 100
    # read 1 contained: its own q-side QCONT, or as target TCONT
    out[5, 1:4] = MA_HT_QCONT if side == "q" else MA_HT_TCONT
    return colmat.to(dev), out.to(dev)


@pytest.mark.parametrize("side", ["q", "t"])
def test_marks_one_read_a_warp(dev, side):
    """A warp whose 32 rows mark one read with mixed words (5 and 3 among
    them): K12 alone and K13's marks keep their max, 5, as the twin."""
    from miniasm_tpu_torch.select import fused2

    colmat, out = _one_read_warp(dev, side)
    T = 40
    got = fused2.read_marks(colmat, out, T)
    want = fused2.read_marks_plain(colmat, out, T)
    assert torch.equal(got, want) and int(want[1]) == 5
    mdel = torch.zeros(T, dtype=torch.bool, device=dev)
    res = fused2.arc_order(colmat, out, mdel, T - 2)
    torch.cuda.synchronize()
    plain = fused2.arc_order_plain(colmat, out, mdel, T - 2)
    for x, y in zip(fused2.arc_live(res, T - 2), fused2.arc_live(plain, T - 2)):
        assert torch.equal(x, y)
    flags = fused2.arc_live(res, T - 2)[1]
    assert int(flags[1]) == 4 | 8  # used and palindrome, not contained


def check_arc_order(dev, colmat, out, mdel, n_seq=None, **kw):
    """K13 against its twin on the card: the head, the flags row and the
    arcs (arc_live); returns the twin's result and the kernel's tiers."""
    from miniasm_tpu_torch.select import fused2

    colmat, out, mdel = (x.to(dev) for x in (colmat, out, mdel))
    n_seq = mdel.shape[0] - 2 if n_seq is None else n_seq
    got, tiers = fused2.arc_order_tiers(colmat, out, mdel, n_seq, **kw)
    torch.cuda.synchronize()
    want = fused2.arc_order_plain(colmat, out, mdel, n_seq)
    for x, y in zip(fused2.arc_live(got, n_seq), fused2.arc_live(want, n_seq)):
        assert torch.equal(x, y)
    return want, tiers.tolist()


@pytest.mark.parametrize("smem_cap", [0, 1, 2048, None])
def test_arc_order_kernel_matches_plain(dev, smem_cap):
    """Reads of 1 to about 900 arcs (read i drawn with weight 1/(i+1)),
    starts in [0, 50): many equal hit keys.  The default cap sorts the
    reads past 256 arcs by a block in shared memory, 2048 bytes sends
    those past 256 arcs to device memory, 0 and 1 byte every read."""
    rng = np.random.default_rng(12)
    T = 3000
    p = 1.0 / np.arange(1, T - 1)
    colmat, out, mdel = arc_inputs(rng, T=T, start_hi=50,
                                   read_p=p / p.sum())
    kw = {} if smem_cap is None else {"smem_cap": smem_cap}
    want, (block, devmem) = check_arc_order(dev, colmat, out, mdel, **kw)
    m_cont, n_arc, dup = want[:3].tolist()
    assert n_arc > 10_000 and dup > 0 and m_cont > n_arc
    if smem_cap is None:
        assert block > 0 and devmem == 0
    elif smem_cap == 2048:
        assert block == devmem > 0
    else:
        assert block == devmem > 1000


def test_arc_order_kernel_read_past_shared_memory(dev):
    """One read holds 40,000 arcs, more than a block's shared memory holds:
    its sort runs in device memory."""
    rng = np.random.default_rng(13)
    T, n = 40, 60_000
    p = np.full(T - 2, 0.1 / (T - 3))
    p[7] = 0.9
    colmat, out, mdel = arc_inputs(rng, n=n, T=T, start_hi=30000,
                                   read_p=p)
    colmat[3] = torch.where(colmat[3] == colmat[0], (colmat[0] + 1) % 30,
                            colmat[3])
    out[4] = 1
    out[5] = torch.from_numpy(rng.integers(0, 9000, n).astype(np.int32))
    mdel[:] = False
    want, (block, devmem) = check_arc_order(dev, colmat, out, mdel)
    assert want[1] == n and block >= 1 and devmem == 1


def test_arc_order_kernel_no_arcs_and_empty(dev):
    from miniasm_tpu_torch.select import fused2

    colmat, out, mdel = arc_inputs(np.random.default_rng(14), n=500)
    out[4] = 0  # no valid lane
    want, _ = check_arc_order(dev, colmat, out, mdel)
    assert want[:3].tolist() == [0, 0, 0]
    e = torch.zeros((7, 0), dtype=torch.int32, device=dev)
    m = mdel.to(dev)
    got = fused2.arc_order(e, torch.zeros((15, 0), dtype=torch.int32,
                                          device=dev), m, 5)
    head, flags, arcs = fused2.arc_live(got, 5)
    assert head.tolist() == [0, 0, 0] and arcs.shape == (5, 0)
    assert torch.equal(flags, m[:5].to(torch.int32))


def _most_tail_blocks():
    """The most blocks of K13's launch on this card (its grid's third
    word), read from a call on a few rows."""
    from miniasm_tpu_torch.select import fused2

    colmat, out, mdel = (x.cuda() for x in arc_inputs(
        np.random.default_rng(0), n=100, T=50))
    g = [0, 0, 0, 0]
    fused2.arc_order(colmat, out, mdel, 48, grid=g)
    assert g[0] == 1 and g[1] == 50 and g[2] > 0 and g[3] == 6
    return g[2]


@pytest.mark.parametrize("d", [-1, 0, 1, 257, 100_000])
def test_arc_order_kernel_read_chunk_edges(dev, d):
    """T at the edges of a block's chunk of reads: the card's whole grid
    at 256 reads a block (most x 256 + d: one read more or less than a
    round of the block's scan, a second round), and far past it."""
    from miniasm_tpu_torch.select import fused2

    most = _most_tail_blocks()
    T = most * 256 + d
    colmat, out, mdel = arc_inputs(np.random.default_rng(abs(d)),
                                   n=200_000, T=T)
    g = [0, 0, 0, 0]
    want, _ = check_arc_order(dev, colmat, out, mdel, grid=g)
    assert g[0] == most and g[1] == -(-T // most)
    assert (g[1] > 256) == (d > 0)
    assert int(want[1]) > 0
    # the same on the flags row's edge: n_seq = T
    want, _ = check_arc_order(dev, colmat, out, mdel, n_seq=T)


def test_to_host_reuses_one_pinned_block(dev):
    """to_host copies into the thread's pinned staging block: a smaller
    copy after a larger one lands in the same block."""
    from miniasm_tpu_torch.device import to_host

    a = to_host(torch.arange(300_000, dtype=torch.int32, device=dev))
    assert a.is_pinned() and a[-1].item() == 299_999
    ptr = a.data_ptr()
    b = to_host(torch.arange(10, dtype=torch.int64, device=dev))
    assert b.data_ptr() == ptr and b.dtype == torch.int64
    assert b.tolist() == list(range(10))


def _clean_graph_args(dev, g, n_rounds=2):
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.graph import devclean

    opt = Opt(n_rounds=n_rounds)
    c = devclean.build_arcs(g, dev)
    bits = devclean.trans_multi(c["first"], c["av"], c["al"], c["sdel_v"],
                                c["D"], int(opt.gap_fuzz), True)
    return c, bits, devclean._ratio_schedule(opt)


def check_clean(dev, c, bits, ratios, do_symm, max_ext, grid=None):
    """The fused stage-B kernel against its twin, the whole buffer bit for
    bit (counters, arc words, candidate bytes and their zero pad); returns
    the buffer and the candidate bytes (the launch's blocks and lanes into
    the list `grid`, when given)."""
    from miniasm_tpu_torch.graph import devclean

    args = (c["first"], c["av"], c["aol"], bits, c["sdel_v"], ratios,
            do_symm)
    got = devclean.clean_stage_b(*args, c["D"], max_ext, grid=grid)
    torch.cuda.synchronize()
    want = devclean.clean_stage_b_plain(*args, max_ext)
    assert torch.equal(got, want)
    V, A = c["V"], c["av"].shape[0]
    return want, want[3 + len(ratios) + A:].view(torch.uint8)[:V]


@pytest.mark.parametrize("n_rounds", [1, 2, 6, 27])
@pytest.mark.parametrize("do_symm", [False, True])
def test_clean_stage_b_kernels_match_plain(dev, n_rounds, do_symm):
    """K14 on a random graph with asymmetric singletons, at 3 to
    29 ratios (27 rounds fill all 32 bits of an arc's word)."""
    rng = np.random.default_rng(20 + n_rounds)
    g = random_graph(rng, n_seq=400, n_pairs=800)
    keep = rng.random(g.n_arc) > 0.1  # drop a tenth: asymmetric arcs
    g.adel[~keep] = True
    g = cleanup(g)
    c, bits, ratios = _clean_graph_args(dev, g, n_rounds)
    for max_ext in (1, 4, 7):
        want, ends = check_clean(dev, c, bits, ratios, do_symm, max_ext)
    R = len(ratios)
    assert R == n_rounds + 2
    assert int(want[2]) > 0 and int(want[3 + R - 1]) > 0
    assert bool((ends & 1).any()) and bool((ends & 8).any())


@pytest.mark.parametrize("kind", ["wide", "mid"])
def test_clean_stage_b_kernels_long_rows(dev, kind):
    """Rows of more than 32 arcs: 32 lanes take a row's slots 32 at a
    time, and the complement scans run past one 16-arc chunk."""
    c, bits, ratios = _clean_graph_args(dev, _dense_graph(kind))
    assert c["D"] > 32
    for do_symm in (False, True):
        check_clean(dev, c, bits, ratios, do_symm, 4)


def _short_row_graph(rng, n_seq, n_pairs):
    """A random symmetric graph of n_seq reads and short rows, drawn in
    bulk (random_graph's loop is too slow at this size)."""
    lens = rng.integers(3000, 20000, n_seq).astype(np.uint32)
    a = rng.integers(0, 2 * n_seq, n_pairs)
    b = rng.integers(0, 2 * n_seq, n_pairs)
    ok = (a >> 1) != (b >> 1)
    a, b = a[ok], b[ok]
    la = lens[a >> 1].astype(np.int64)
    lb = lens[b >> 1].astype(np.int64)
    ol = rng.integers(500, np.minimum(la, lb))
    u = np.concatenate([a, b ^ 1])
    v = np.concatenate([b, a ^ 1])
    lu = np.concatenate([la - ol, lb - ol])
    o2 = np.concatenate([ol, ol])
    drop = rng.random(u.size) < 0.05  # a few asymmetric arcs
    g = Graph(u=u[~drop].astype(np.int32), l=lu[~drop].astype(np.int32),
              v=v[~drop].astype(np.int32), ol=o2[~drop].astype(np.int32),
              adel=np.zeros(int((~drop).sum()), bool), slen=lens,
              sdel=rng.random(n_seq) < 0.05,
              idx_start=np.zeros(2 * n_seq, np.int64),
              idx_cnt=np.zeros(2 * n_seq, np.int32))
    return cleanup(g)


@pytest.mark.parametrize("do_symm", [False, True])
def test_clean_stage_b_grid_strides(dev, do_symm):
    """600,000 vertices with short rows: more rows and more vertices than
    one resident grid covers, so both grid-stride loops take more than
    one round (the grid the wrapper chose), bit-equal."""
    g = _short_row_graph(np.random.default_rng(31), 300_000, 400_000)
    c, bits, ratios = _clean_graph_args(dev, g)
    V = c["V"]
    assert V == 600_000
    grid = [0, 0]
    check_clean(dev, c, bits, ratios, do_symm, 7, grid)
    blocks, lanes = grid
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 0 < blocks <= 8 * sms  # at most 2,048 threads an SM
    # blocks of 256 threads: 256 / lanes rows, 256 vertices a round
    row_rounds = -(-V // (blocks * (256 // lanes)))
    vertex_rounds = -(-V // (blocks * 256))
    assert row_rounds > 1 and vertex_rounds > 1, (grid, V)


@pytest.mark.parametrize("kind", ["no_vertex", "no_arc"])
def test_clean_stage_b_empty(dev, kind):
    """V == 0 (the counters only, no kernel) and A == 0 with V > 0 (every
    vertex still classified: a tip, unless its read is deleted)."""
    n_seq = 0 if kind == "no_vertex" else 7
    lens = np.full(n_seq, 5000, np.uint32)
    e32 = np.zeros(0, np.int32)
    g = cleanup(Graph(u=e32, l=e32, v=e32, ol=e32, adel=np.zeros(0, bool),
                      slen=lens, sdel=np.arange(n_seq) == 3,
                      idx_start=np.zeros(2 * n_seq, np.int64),
                      idx_cnt=np.zeros(2 * n_seq, np.int32)))
    c, bits, ratios = _clean_graph_args(dev, g)
    assert c["av"].shape[0] == 0 and c["V"] == 2 * n_seq
    grid = [-1, -1]
    want, ends = check_clean(dev, c, bits, ratios, True, 4, grid)
    assert want.shape[0] == 3 + len(ratios) + (c["V"] + 3) // 4
    assert not want[:3 + len(ratios)].any()
    if kind == "no_vertex":
        assert grid == [0, 0]
    else:
        assert ends.tolist() == [0 if v >> 1 == 3 else 1
                                 for v in range(2 * n_seq)]


def test_clean_arcs_raises_past_29_ratios(dev):
    from miniasm_tpu_torch.graph import devclean

    c, bits, _ = _clean_graph_args(dev, random_graph(
        np.random.default_rng(3), n_seq=20, n_pairs=40))
    with pytest.raises(ValueError, match="drop ratios"):
        devclean.clean_stage_b(c["first"], c["av"], c["aol"], bits,
                               c["sdel_v"], (0.5,) * 30, True, c["D"], 4)


class _TailOps:
    """The aten ops a call makes on CUDA tensors, and its device-to-host
    copies (a copy into a CPU tensor, a .cpu(), an item())."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        ops = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                ops.names.add(func.overloadpacket.__name__)
                src = [a for a in args if isinstance(a, torch.Tensor)]
                if func is torch.ops.aten.copy_.default:
                    if not args[0].is_cuda and args[1].is_cuda:
                        ops.d2h += 1
                elif func is torch.ops.aten._to_copy.default:
                    if src[0].is_cuda and str(kwargs.get("device")) == "cpu":
                        ops.d2h += 1
                elif func is torch.ops.aten._local_scalar_dense.default:
                    ops.d2h += src[0].is_cuda
                return func(*args, **kwargs)

        self.names, self.d2h, self.mode = set(), 0, Mode()


FORBIDDEN = {"sort", "nonzero", "searchsorted", "scatter_reduce",
             "scatter_reduce_"}


def test_select_and_clean_tails_on_card_one_copy(dev, tmp_path):
    """On CUDA tensors select_build2 and detect run no sort, nonzero,
    searchsorted or scatter_reduce; select_build2 makes two device-to-host
    copies (the second sized by n_arc), detect one; their results equal
    the CPU's; K13 (with K12's marks) and K14 launch once a call."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.eval.simulate import simulate, write_paf
    from miniasm_tpu_torch.graph import devclean
    from miniasm_tpu_torch.io.native.pafload import load_hits_mt
    from miniasm_tpu_torch.select import fused2

    paf = str(tmp_path / "r.paf")
    write_paf(simulate(genome_len=200_000, coverage=20.0, seed=7), paf)
    opt = Opt()
    res = {}
    for d in ("cpu", "cuda"):
        colmat, dd, h = load_hits_mt(paf, opt.min_span, opt.min_match,
                                     bi_dir=True, min_iden=float(opt.min_iden),
                                     device=torch.device(d))
        ops = _TailOps()
        cuda.reset_launches()
        with ops.mode:
            res[d] = fused2.select_build2(colmat, dd, opt, bi_dir=True,
                                          paf_tables=True)
        h.free()
        if d == "cuda":
            n = cuda.launch_counts()
            assert n["read_marks"] == 0 and n["arc_order"] == 1
            assert not ops.names & FORBIDDEN, ops.names & FORBIDDEN
            # the counts, head and tables; then the arcs at their size
            assert ops.d2h == 2
    (ca, cmd, cc), (ga, gmd, gc) = res["cpu"], res["cuda"]
    assert cc == gc and cc[6] > 0
    for k in ca:
        assert ca[k].dtype == ga[k].dtype and np.array_equal(ca[k], ga[k])
    for k in ("sub_s", "sub_e", "sub_del", "cont", "used", "pal"):
        assert np.array_equal(cmd[k], gmd[k])

    rng = np.random.default_rng(4)
    g = random_graph(rng, n_seq=300, n_pairs=1500)
    g.adel[rng.random(g.n_arc) < 0.1] = True
    g = cleanup(g)
    dets = {}
    for d in ("cpu", "cuda"):
        ops = _TailOps()
        cuda.reset_launches()
        with ops.mode:
            dets[d] = devclean.detect(g, opt, do_trans=True,
                                      device=torch.device(d))
        if d == "cuda":
            n = cuda.launch_counts()
            assert n["trans_multi"] == n["clean_stage_b"] == 1
            assert not ops.names & FORBIDDEN, ops.names & FORBIDDEN
            assert ops.d2h == 1
    for k, v in dets["cpu"].items():
        if k == "shorts":
            assert all(np.array_equal(a, b)
                       for a, b in zip(v, dets["cuda"][k]))
        elif isinstance(v, np.ndarray):
            assert v.dtype == dets["cuda"][k].dtype
            assert np.array_equal(v, dets["cuda"][k]), k
        else:
            assert v == dets["cuda"][k], k
    assert dets["cpu"]["counters"][2] > 0


# K16 compact, K17 hit_flt, K18 hit_marks (the staged path's compactions,
# filter and marks) and K19 shard_arcs (the sharded step's arc tail); K13
# again at the edges of its read scan (its block scan is common.cuh's)

# items (K16's columns, K19's rows) on both sides of a block's chunk while
# a lane takes one round (256 items: 255-257), of two to four blocks
# (511-1025), and several rounds a lane over the whole grid ((1 << 20) +
# 3); GRID_EDGES adds the edges of the grid's first round.  The CPU cases
# of tests/test_torch_compact.py take four of these counts
EDGES = [0, 1, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025,
         (1 << 20) + 3]


def _count(name):
    from miniasm_tpu_torch import cuda

    return cuda.launch_counts()[name]


# K16's kinds of input: which rows (k), keep and remap each mode passes
COMPACT_MODES = ["keep", "none", "all", "remap", "keep_remap", "composed",
                 "k1", "k16", "drop_all", "unaligned"]


def _compact_case(rng, n, mode, T=5000, k=None):
    """(rows, keep, mp) for K16: k int32 rows (9; 1 or 16 for modes k1,
    k16; ids in rows 0 and 3 where k >= 4), a keep byte (none, 40% or all
    kept) and a remap dropping about a third of the reads (every read for
    drop_all).  Also the CPU cases of tests/test_torch_compact.py."""
    k = k or {"k1": 1, "k16": 16}.get(mode, 9)
    rows = rng.integers(-2**31, 2**31, (k, n), dtype=np.int32)
    if k >= 4:
        rows[0] = rng.integers(0, T, n)
        rows[3] = rng.integers(0, T, n)
    p = {"none": 0.0, "all": 1.0}.get(mode, 0.4)
    keep = (rng.random(n) < p).astype(np.uint8)
    mp = np.where(rng.random(T) < 0.33, -1, 0).astype(np.int32)
    if mode == "drop_all":
        mp[:] = -1
    mp[mp == 0] = np.arange(int((mp == 0).sum()), dtype=np.int32)
    return torch.from_numpy(rows), torch.from_numpy(keep), torch.from_numpy(mp)


def _compact_kw(mode, keep, mp):
    """compact's keep and mp for a mode of COMPACT_MODES."""
    remap = mode in ("remap", "keep_remap", "k16", "drop_all")
    return {"keep": None if mode in ("remap", "drop_all") else keep,
            "mp": mp if remap else None}


def _unaligned(t, off):
    """t's copy at `off` elements into a new tensor: its pointer off * the
    element size past an aligned one."""
    pad = torch.zeros(off + t.numel(), dtype=t.dtype, device=t.device)
    pad[off:] = t
    return pad[off:]


@pytest.mark.parametrize("n", EDGES)
@pytest.mark.parametrize("mode", COMPACT_MODES)
def test_compact_kernel_matches_plain(dev, n, mode):
    """K16 against its twin: the keep byte read as vectors (keep, none,
    all, composed, k1), a ballot a round (the remaps, and unaligned: the
    rows and the keep bytes at offsets that break 16-byte alignment), 1,
    9 and 16 rows, a remap that drops every read."""
    from miniasm_tpu_torch.utils import compact as cp

    rows, keep, mp = (x.to(dev) for x in _compact_case(
        np.random.default_rng(n % 997), n, mode))
    kw = _compact_kw(mode, keep, mp)
    cols = rows
    if mode == "composed":
        # apply_cut's: rows 1, 2, 4, 5 from another tensor
        other = rows.flip(0).contiguous()
        cols = [rows[0], other[1], other[2], rows[3], other[4], other[5],
                rows[6], rows[7], rows[8]]
    if mode == "unaligned":
        cols = [_unaligned(r, 1 + j % 3) for j, r in enumerate(rows)]
        kw["keep"] = _unaligned(keep, 3)
        if n:
            assert kw["keep"].data_ptr() % 16 and cols[0].data_ptr() % 16
    before = _count("compact")
    got = cp.compact(cols, **kw)
    torch.cuda.synchronize()
    assert _count("compact") - before == (1 if n else 0)
    want = cp.compact_plain(cols, **kw)
    assert got.shape == want.shape and torch.equal(got, want)
    assert got.is_contiguous()
    if mode == "all" and n:
        assert got.shape[1] == n
    if mode in ("none", "drop_all"):
        assert got.shape[1] == 0


def _most_blocks(name, smem_cap=0):
    """The most blocks K16 (on 3 rows) or K19 launches on this card (its
    grid's third word), read from a call on a few items; with smem_cap,
    with its bits in global scratch."""
    from miniasm_tpu_torch.parallel import full
    from miniasm_tpu_torch.utils import compact as cp

    g = [0, 0, 0, 0]
    if name == "compact":
        cp.compact(torch.zeros((3, 5), dtype=torch.int32, device="cuda"),
                   grid=g, smem_cap=smem_cap)
    else:
        full.shard_arcs(*[x.cuda() for x in _shard_case(
            np.random.default_rng(0), 5)], grid=g, smem_cap=smem_cap)
    assert g[0] == 1 and g[2] > 0 and (g[3] > 0) == (smem_cap > 0)
    return g[2]


# where the plan of a compaction changes: the card's whole grid at one
# item a lane (most blocks x 256 items; past it a lane takes two rounds),
# and at 32 (x 8192; past it a block takes a second word of bits)
GRID_EDGES = [("lanes", -1), ("lanes", 0), ("lanes", 1), ("words", -1),
              ("words", 0), ("words", 1)]


# the rounds a lane takes at each edge
ROUNDS = {("lanes", -1): 1, ("lanes", 0): 1, ("lanes", 1): 2,
          ("words", -1): 32, ("words", 0): 32, ("words", 1): 64}


def _grid_n(most, where, d):
    return most * 256 * (1 if where == "lanes" else 32) + d


def _check_plan(g, n, most, spill=False):
    """The grid a compaction chose on n items: at most the card's blocks,
    their chunks cover n, one chunk less would not; the bits in shared
    memory, or with spill in global scratch."""
    blocks, chunk, m, words = g
    assert m == most and 1 <= blocks <= most
    assert blocks * chunk >= n > (blocks - 1) * chunk
    assert (words > 0) == spill


@pytest.mark.parametrize("where,d", GRID_EDGES)
def test_compact_kernel_grid_edges(dev, where, d):
    """K16 at the edges of its grid's first round, 3 rows, 40% kept."""
    from miniasm_tpu_torch.utils import compact as cp

    most = _most_blocks("compact")
    n = _grid_n(most, where, d)
    rows, keep, _ = (x.to(dev) for x in _compact_case(
        np.random.default_rng(5), n, "keep", k=3))
    g = [0, 0, 0, 0]
    got = cp.compact(rows, keep, grid=g)
    torch.cuda.synchronize()
    _check_plan(g, n, most)
    assert g[1] // 256 == ROUNDS[where, d]
    assert torch.equal(got, cp.compact_plain(rows, keep))


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, (1 << 20) + 3])
def test_hit_flt_kernel_matches_plain(dev, n):
    from miniasm_tpu_torch.select import filter as flt

    cols, sub = staged_inputs(np.random.default_rng(7 + n % 101), n=n)
    sub[0, :50] = -100   # e - s wraps: ql and tl past 2**31
    args = (torch.from_numpy(cols).to(dev), torch.from_numpy(sub).to(dev),
            1500, 1000)
    before = _count("hit_flt")
    got = flt.hit_flt_sums(*args)
    torch.cuda.synchronize()
    assert _count("hit_flt") - before == (1 if n else 0)
    want = flt.hit_flt_plain(*args)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if n > 1000:
        assert want[0].any() and not want[0].all() and want[3].any()


def _marks_case(rng, n, T, order="random"):
    """K18's (9, n) hits and (T,) lengths on the CPU: staged_inputs with
    twice as many reads as hits where T is None (some reads in no hit),
    5% exact reverse self palindromes, and with order "sorted" the hits
    sorted by query, as the staged path holds them."""
    cols, sub = staged_inputs(rng, n=n, T=T or max(500, 2 * n))
    pal = rng.random(n) < 0.05
    cols[3, pal], cols[4, pal], cols[5, pal] = cols[0, pal], cols[1, pal], \
        cols[2, pal]
    cols[8, pal] = 1
    if order == "sorted":
        cols = np.ascontiguousarray(cols[:, np.argsort(cols[0],
                                                       kind="stable")])
    return torch.from_numpy(cols), torch.from_numpy(sub[1] - sub[0])


MARKS_KW = dict(max_hang=1000, int_frac=0.8, min_ovlp=2000)


@pytest.mark.parametrize("n", [0, 1, 257, (1 << 20) + 3])
@pytest.mark.parametrize("mode", ["contained", "sg", "contained_sorted"])
def test_hit_marks_kernel_matches_plain(dev, n, mode):
    """K18 against its plain version, one launch a call with hits: the
    containment's (2, T) marks on hits in no order and sorted by query
    (the staged path's order, whose warps store a run's used mark once),
    and the sg marks."""
    from miniasm_tpu_torch.core import hit2arc as h2a

    c, lens = (x.to(dev) for x in _marks_case(
        np.random.default_rng(17 + n % 89), n, None,
        "sorted" if mode == "contained_sorted" else "random"))
    mode = mode.split("_")[0]
    T = lens.shape[0]
    before = _count("hit_marks")
    got = h2a.hit_marks(c, mode, T, lens, **MARKS_KW)
    torch.cuda.synchronize()
    assert _count("hit_marks") - before == (1 if n else 0)
    want = h2a.hit_marks_plain(c, mode, T, lens, **MARKS_KW)
    got, want = [x if isinstance(x, tuple) else (x,) for x in (got, want)]
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if n > 1000:
        assert want[0].any() and not want[0].all()


# (n, T, shared memory): one read; the E. coli shape; the most reads two
# shared bitmaps of 48 KB hold, and one more, also at the E. coli set's
# 60 hits a read; many reads
MARKS_PATHS = {"one_read": (3_000, 1, True),
               "ecoli_shape": ((1 << 20) + 3, 23_000, True),
               "smem_edge": (100_000, 196_608, True),
               "past_smem": (100_000, 196_609, False),
               "past_smem_ecoli_density": (60 * 196_609, 196_609, False),
               "wide": ((1 << 20) + 3, 2_097_158, False)}


@pytest.mark.parametrize("case", sorted(MARKS_PATHS))
def test_hit_marks_contained_paths(dev, case):
    """The containment's one launch in shared memory and past it, on
    sorted hits: bit-equal to the plain version, the path the launch
    reports ([blocks, hits a block at most, shared bytes a block]) as
    expected."""
    from miniasm_tpu_torch.core import hit2arc as h2a

    n, T, smem = MARKS_PATHS[case]
    c, lens = (x.to(dev) for x in _marks_case(
        np.random.default_rng(len(case)), n, T, "sorted"))
    grid = [0, 0, 0]
    got = h2a.hit_marks(c, "contained", T, lens, **MARKS_KW, grid=grid)
    torch.cuda.synchronize()
    assert torch.equal(got, h2a.hit_marks_plain(c, "contained", T, lens,
                                                **MARKS_KW))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (grid[2] > 0) == smem and 1 <= grid[0] <= 8 * sms
    assert grid[0] * grid[1] >= n
    assert got[1].any()


def test_hit_marks_contained_near_2_27_hits(dev):
    """The containment's one launch over (1 << 27) - 5 hits sorted by
    query among 23,000 reads (the E. coli shape, shared memory), made on
    the card: bit-equal to the plain version on the card."""
    from miniasm_tpu_torch.core import hit2arc as h2a

    g = torch.Generator(device=dev)
    g.manual_seed(227)
    n, T = (1 << 27) - 5, 23_000

    def draw(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, dtype=torch.int32,
                             device=dev)

    qs, ts = draw(0, 9000), draw(0, 9000)
    cols = torch.stack([draw(0, T).sort().values, qs, qs + draw(0, 9000),
                        draw(0, T), ts, ts + draw(0, 9000),
                        torch.zeros_like(qs), torch.zeros_like(qs),
                        draw(0, 2)])
    lens = torch.randint(3000, 18000, (T,), generator=g, dtype=torch.int32,
                         device=dev)
    grid = [0, 0, 0]
    got = h2a.hit_marks(cols, "contained", T, lens, **MARKS_KW, grid=grid)
    torch.cuda.synchronize()
    assert grid[2] > 0
    assert torch.equal(got, h2a.hit_marks_plain(cols, "contained", T, lens,
                                                **MARKS_KW))
    assert got[0].any() and got[1].all()


def test_contained_pass_one_copy_of_marks(dev, tmp_path):
    """hit_contained on the card: one K18 launch, one device-to-host copy
    of both marks (and one count read by each of K16's two compactions,
    the trim table and the hits), the CPU run's hits, trim table and
    names."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.core.hits import build_hits
    from miniasm_tpu_torch.eval.simulate import simulate, write_paf
    from miniasm_tpu_torch.io.paf import load_paf
    from miniasm_tpu_torch.select.contained import hit_contained

    paf = str(tmp_path / "r.paf")
    write_paf(simulate(genome_len=200_000, coverage=20.0, seed=7), paf)
    opt = Opt()
    res = {}
    for d in ("cpu", "cuda"):
        load = load_paf(paf, opt.min_span, opt.min_match)
        hits = build_hits(load, device=torch.device(d))
        T = load.d.n_seq
        sub = torch.zeros((3, T), dtype=torch.int32, device=d)
        sub[1] = torch.from_numpy(load.d.lens_array().astype(np.int32))
        ops = _TailOps()
        cuda.reset_launches()
        with ops.mode:
            h, s = hit_contained(opt, load.d, sub, hits)
        if d == "cuda":
            torch.cuda.synchronize()
            n = cuda.launch_counts()
            assert n["hit_marks"] == 1 and n["compact"] == 2
            assert ops.d2h == 1 + 2, ops.d2h
        res[d] = (h.cols.cpu(), s.cpu(), list(load.d.names))
    assert torch.equal(res["cpu"][0], res["cuda"][0])
    assert torch.equal(res["cpu"][1], res["cuda"][1])
    assert res["cpu"][2] == res["cuda"][2] and res["cpu"][0].shape[1] > 0


SHARD_KINDS = ["mixed", "q_only", "m_only", "no_arcs", "self"]


def _shard_case(rng, n, T=3000, kind="mixed"):
    """(rows, out, marks, mdel) for K19: tail_inputs' rows and K1 output
    with a gid row; the marks as 0/1 rows [used cont pal].  q_only and
    m_only keep one lane bit of every row, no_arcs makes every code
    negative (no arc, m_contained still counts), self makes every row a
    self-hit.  Also the CPU cases of tests/test_torch_compact.py."""
    colmat, out, tab, mdel = tail_inputs(rng, n=n, T=T)
    if kind == "q_only":
        out[4] &= 1
    elif kind == "m_only":
        out[4] &= 2
    elif kind == "no_arcs":
        out[5] = out[10] = -1
    elif kind == "self":
        colmat[3] = colmat[0]
    gid = torch.arange(n, dtype=torch.int32) * 2
    rows = torch.cat([colmat, gid[None]]).contiguous()
    marks = torch.stack([tab & 1, (tab >> 1) & 1, (tab >> 2) & 1])
    return rows, out, marks.contiguous(), mdel


def _check_shard_arcs(args, kind="mixed", grid=None):
    from miniasm_tpu_torch.parallel import full

    before = _count("shard_arcs")
    arcmat, cnt = full.shard_arcs(*args, grid=grid)
    torch.cuda.synchronize()
    n = args[0].shape[1]
    assert _count("shard_arcs") - before == (1 if n else 0)
    want, wcnt = full.shard_arcs_plain(*args)
    assert torch.equal(cnt, wcnt)
    assert arcmat.shape == want.shape and torch.equal(arcmat, want)
    assert arcmat.is_contiguous()
    if n > 1000:
        side = want[4] & 1
        assert int(wcnt[0]) > want.shape[1]
        if kind == "mixed":
            assert side.any() and not side.all()
        elif kind in ("q_only", "m_only"):
            assert want.shape[1] and bool((side == 0).all()) == (
                kind == "q_only")
        else:
            assert want.shape[1] == 0


@pytest.mark.parametrize("n", EDGES)
@pytest.mark.parametrize("kind", SHARD_KINDS)
def test_shard_arcs_kernel_matches_plain(dev, n, kind):
    args = [x.to(dev) for x in _shard_case(
        np.random.default_rng(19 + n % 83), n, kind=kind)]
    _check_shard_arcs(args, kind)


@pytest.mark.parametrize("where,d", GRID_EDGES)
def test_shard_arcs_kernel_grid_edges(dev, where, d):
    """K19 at the edges of its grid's first round."""
    most = _most_blocks("shard_arcs")
    n = _grid_n(most, where, d)
    args = [x.to(dev) for x in _shard_case(np.random.default_rng(23), n)]
    g = [0, 0, 0, 0]
    _check_shard_arcs(args, grid=g)
    _check_plan(g, n, most)
    assert g[1] // 256 == ROUNDS[where, d]


# the bits of a launch in global scratch (a shared-memory cap of one
# byte): one word of 32 rounds a lane in one block, several blocks, and
# several words a lane ("words": past the whole grid's first word)
SPILL_NS = [1, 257, 8193, (1 << 20) + 3, "words"]


def _spill_check(g, n, most):
    """The plan in global scratch: 32 rounds a lane a word, as few words
    as the card's grid needs."""
    _check_plan(g, n, most, spill=True)
    assert g[1] == 8192 * -(-n // (most * 8192))


@pytest.mark.parametrize("n", SPILL_NS)
@pytest.mark.parametrize("mode", ["keep", "none", "keep_remap"])
def test_compact_kernel_bits_in_global_scratch(dev, n, mode):
    """K16 with its keep bits in global scratch, as past what shared
    memory holds: bit-equal to its twin, one launch."""
    from miniasm_tpu_torch.utils import compact as cp

    most = _most_blocks("compact", smem_cap=1)
    if n == "words":
        n = 2 * most * 8192 + 1
    rows, keep, mp = (x.to(dev) for x in _compact_case(
        np.random.default_rng(n % 991), n, mode,
        k=9 if mode == "keep_remap" else 3))
    kw = _compact_kw(mode, keep, mp)
    g = [0, 0, 0, 0]
    before = _count("compact")
    got = cp.compact(rows, **kw, grid=g, smem_cap=1)
    torch.cuda.synchronize()
    assert _count("compact") - before == 1
    _spill_check(g, n, most)
    assert torch.equal(got, cp.compact_plain(rows, **kw))


@pytest.mark.parametrize("n", SPILL_NS)
def test_shard_arcs_kernel_bits_in_global_scratch(dev, n):
    """K19 with its lane bits in global scratch."""
    most = _most_blocks("shard_arcs", smem_cap=1)
    if n == "words":
        n = 2 * most * 8192 + 1
    args = [x.to(dev) for x in _shard_case(np.random.default_rng(n % 89),
                                           n)]
    from miniasm_tpu_torch.parallel import full

    g = [0, 0, 0, 0]
    arcmat, cnt = full.shard_arcs(*args, grid=g, smem_cap=1)
    torch.cuda.synchronize()
    _spill_check(g, n, most)
    want, wcnt = full.shard_arcs_plain(*args)
    assert torch.equal(cnt, wcnt) and torch.equal(arcmat, want)


def _tiled(t, n):
    """t repeated along its last axis to n items."""
    reps = -(-n // t.shape[-1])
    return t.repeat(*([1] * (t.dim() - 1)), reps)[..., :n].contiguous()


def test_compact_kernel_past_shared_memory(dev):
    """K16 on 2**28 columns (its bits past what shared memory holds; the
    kernel takes up to 2**31 - 1): a seeded case of 2**20 + 3 columns
    tiled, one row, 40% kept."""
    from miniasm_tpu_torch.utils import compact as cp

    n = 1 << 28
    rows, keep, _ = _compact_case(np.random.default_rng(31), (1 << 20) + 3,
                                  "keep", k=1)
    rows, keep = _tiled(rows.to(dev), n), _tiled(keep.to(dev), n)
    g = [0, 0, 0, 0]
    got = cp.compact(rows, keep, grid=g)
    torch.cuda.synchronize()
    assert g[3] > 0 and g[0] * g[1] >= n
    want = cp.compact_plain(rows, keep)
    assert got.shape == want.shape and torch.equal(got, want)


def test_shard_arcs_kernel_past_shared_memory(dev):
    """K19 on 2**27 rows (its bits past what shared memory holds; the
    kernel takes up to 2**30 - 1): a seeded case of 2**20 + 3 rows
    tiled."""
    from miniasm_tpu_torch.parallel import full

    n = 1 << 27
    rows, out, marks, mdel = _shard_case(np.random.default_rng(37),
                                         (1 << 20) + 3)
    args = [_tiled(rows.to(dev), n), _tiled(out.to(dev), n),
            marks.to(dev), mdel.to(dev)]
    g = [0, 0, 0, 0]
    arcmat, cnt = full.shard_arcs(*args, grid=g)
    torch.cuda.synchronize()
    assert g[3] > 0 and g[0] * g[1] >= n
    want, wcnt = full.shard_arcs_plain(*args)
    assert torch.equal(cnt, wcnt) and torch.equal(arcmat, want)
    assert int(wcnt[1]) > n // 4


def _device_events(fn):
    """The device events of one call of fn (after a warm call), by
    torch.profiler, in the order they start; a session that records none
    is made again, three times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        if ev:
            return ev
    raise AssertionError("the profiler recorded no device event")


def _one_call_events(name):
    """Prints, as a JSON list, the device events of one call of K16, K19
    or K13 on seeded inputs, or of the graft entry's forward step (run in
    a process of its own by _child_events)."""
    from miniasm_tpu_torch.eval import dryrun
    from miniasm_tpu_torch.parallel import full
    from miniasm_tpu_torch.select import fused2
    from miniasm_tpu_torch.utils import compact as cp

    rng = np.random.default_rng(29)
    if name == "entry":
        fwd, (cm,) = dryrun.entry(device="cuda")
        fn = lambda: fwd(cm)  # noqa: E731
    elif name == "compact":
        rows, keep, mp = (x.cuda() for x in _compact_case(
            rng, 300_000, "keep_remap"))
        fn = lambda: cp.compact(rows, keep, mp)  # noqa: E731
    elif name == "arc_order":
        colmat, out, mdel = (x.cuda() for x in arc_inputs(rng, 300_000))
        fn = lambda: fused2.arc_order(colmat, out, mdel, 2998)  # noqa: E731
    else:
        args = [x.cuda() for x in _shard_case(rng, 300_000)]
        fn = lambda: full.shard_arcs(*args)  # noqa: E731
    print(json.dumps(_device_events(fn)))


def _child_event_names(name):
    """_one_call_events(name) in a process of its own: in the test process,
    after the profiled CLI runs of other tests, a session held the copy
    but not the kernel.  Returns the events' names in the order they
    start."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = %r; import test_torch_cuda as t; "
            "t._one_call_events(%r)" % ([os.path.dirname(here), here], name))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _child_events(name):
    """_child_event_names(name) as (kernels, memsets)."""
    ev = _child_event_names(name)
    return ([e for e in ev if not e.startswith(("Memset", "Memcpy"))],
            [e for e in ev if e.startswith("Memset")])


@pytest.mark.parametrize("name", ["compact", "shard_arcs"])
def test_compaction_one_launch_a_call(dev, name):
    """One call of K16 or K19 launches one kernel, and no memset (at most
    one is allowed), besides the copy that reads its count back."""
    kernels, memsets = _child_events(name)
    assert len(kernels) == 1 and name in kernels[0], kernels
    assert len(memsets) <= 1, memsets


def test_select_tail_one_launch_no_memset(dev):
    """One call of the main path's select tail (K13 with K12's marks: the
    marks, the flags row and the ordered arcs) launches one kernel and no
    memset."""
    kernels, memsets = _child_events("arc_order")
    assert len(kernels) == 1 and "arc_order_kernel" in kernels[0], kernels
    assert not memsets, memsets


@pytest.mark.parametrize("T", [5, 1023, 1024, 1025, 2049])
def test_arc_order_kernel_scan_edges(dev, T):
    """K13 with its block scan in common.cuh: reads on both sides of the
    1024 rows a block takes a round, of one and two scan rounds."""
    colmat, out, mdel = arc_inputs(np.random.default_rng(T), n=20_000,
                                   T=T)
    want, _ = check_arc_order(dev, colmat, out, mdel)
    assert int(want[1]) > 0


MASK_OPS = {"nonzero", "masked_select", "masked_scatter", "bool_index"}


class _MaskOps(_TailOps):
    """_TailOps, and each boolean-mask index or index_put on CUDA
    tensors (recorded as "bool_index")."""

    def __init__(self):
        super().__init__()
        from torch.utils._python_dispatch import TorchDispatchMode

        ops, inner = self, self.mode

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.overloadpacket.__name__
                if name in ("index", "index_put", "index_put_"):
                    idx = args[1] if len(args) > 1 else []
                    if any(isinstance(i, torch.Tensor)
                           and i.dtype in (torch.bool, torch.uint8)
                           for i in idx or []):
                        ops.names.add("bool_index")
                return inner.__torch_dispatch__(func, types, args, kwargs)

        self.mode = Mode()


def test_staged_and_sharded_device_paths_have_no_mask_ops(dev, tmp_path):
    """On the card the staged selection (-S 5: both passes and the
    containment), the staged graph build and the sharded step (a one-rank
    NCCL group) run no nonzero, boolean-mask index or masked_select: their
    compactions go through K16 and K19; each K16-K19 launches as counted;
    the results equal the CPU's."""
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.config import Opt
    from miniasm_tpu_torch.core.hits import build_hits
    from miniasm_tpu_torch.eval.simulate import simulate, write_paf
    from miniasm_tpu_torch.graph.asg import graph_from_hits
    from miniasm_tpu_torch.io.paf import load_paf
    from miniasm_tpu_torch.parallel import group
    from miniasm_tpu_torch.parallel.full import select_step, shard_rows
    from miniasm_tpu_torch.pipeline import _select_staged
    from miniasm_tpu_torch.utils.timers import StageClock

    paf = str(tmp_path / "r.paf")
    write_paf(simulate(genome_len=200_000, coverage=20.0, seed=7), paf)
    opt = Opt()
    res = {}
    for d in ("cpu", "cuda"):
        load = load_paf(paf, opt.min_span, opt.min_match)
        hits = build_hits(load, device=torch.device(d))
        ops = _MaskOps()
        cuda.reset_launches()
        with ops.mode:
            h, sub = _select_staged(hits, load.d, opt, 100, False, False)
            g = graph_from_hits(opt, load.d.lens_array(),
                                load.d.del_array(), sub, h)
        res[d] = (h.cols.cpu(), sub.cpu(), g)
        if d == "cuda":
            n = cuda.launch_counts()
            assert not ops.names & MASK_OPS, ops.names & MASK_OPS
            # cut, filter, cut, the trim table, the hits, the arcs
            assert n["compact"] == 6 and n["hit_flt"] == 1
            # the containment's one launch, sg
            assert n["hit_marks"] == 2 and n["hit2arc"] == 0
    (ch, cs, cg), (gh, gs, gg) = res["cpu"], res["cuda"]
    assert torch.equal(ch, gh) and torch.equal(cs, gs) and gh.shape[1] > 0
    for f in ("u", "v", "l", "ol", "sdel", "slen"):
        assert np.array_equal(getattr(cg, f), getattr(gg, f)), f

    steps = {}
    for d in ("cpu", "cuda"):
        rdv = tmp_path / ("rdv_" + d)
        g = group.init(0, 1, "file://" + str(rdv), device=d)
        try:
            rows, n_seq, block, _ = shard_rows(paf, opt, None, g,
                                               StageClock({}, g.device))
            ops = _MaskOps()
            cuda.reset_launches()
            with ops.mode:
                arcmat, meta, counts = select_step(rows, n_seq, block, opt,
                                                   g)
            steps[d] = (arcmat.cpu(), meta, counts)
            if d == "cuda":
                assert cuda.launch_counts()["shard_arcs"] == 1
                assert not ops.names & MASK_OPS, ops.names & MASK_OPS
        finally:
            group.destroy()
    assert torch.equal(steps["cpu"][0], steps["cuda"][0])
    assert np.array_equal(steps["cpu"][1], steps["cuda"][1])
    assert steps["cpu"][2] == steps["cuda"][2] and steps["cpu"][2][6] > 0
