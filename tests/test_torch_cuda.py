"""Card tests of the port's CUDA kernels (miniasm_tpu_torch/csrc): each
kernel against its plain PyTorch twin on the same CUDA tensors, bit for
bit, plus one small end-to-end run on the card against the CPU run.

Marked `cuda`; they skip on a machine without a card.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import io

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


@pytest.mark.parametrize("int_frac", [0.5, 0.8])
def test_hit2arc_kernel_matches_plain(dev, int_frac):
    from miniasm_tpu_torch.core import hit2arc as h2a

    cols, sub = staged_inputs(np.random.default_rng(6))
    lens = torch.from_numpy(sub[1] - sub[0]).to(dev)
    args = (torch.from_numpy(cols).to(dev), lens, 1000, int_frac, 2000)
    got = h2a.hit2arc_rows(*args)
    torch.cuda.synchronize()
    want = h2a.hit2arc_rows_plain(*args)
    assert torch.equal(got, want)
    assert len(set(want[0].clamp(min=-5, max=0).tolist())) == 5


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
    assert n["cut_hit2arc"] == 0 and n["hit2arc"] > 0


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


def test_unpack4_kernel_matches_plain(dev):
    from miniasm_tpu_torch.io.native import pafload

    rng = np.random.default_rng(10)
    packed = torch.from_numpy(rng.integers(0, 2**32, (4, 300_000))
                              .astype(np.uint32).view(np.int32))
    want = pafload.unpack4_plain(packed)
    got = pafload.unpack4(packed.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    # 200,000 columns into the middle of a colmat, the rest untouched
    out = torch.full((7, 500_000), -7, dtype=torch.int32, device=dev)
    pafload.unpack4(packed.to(dev), 200_000, out, 123_457)
    torch.cuda.synchronize()
    o = out.cpu()
    assert torch.equal(o[:, 123_457:323_457], want[:, :200_000])
    assert (o[:, :123_457] == -7).all() and (o[:, 323_457:] == -7).all()


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


@pytest.mark.parametrize("case,fmt3", [("grouped", "1"), ("grouped", "0"),
                                       ("shuffled", "1"), ("long", "1")])
def test_loader_on_card_matches_cpu(dev, tmp_path, monkeypatch, case, fmt3):
    from miniasm_tpu_torch import cuda
    from miniasm_tpu_torch.io.native import pafload

    monkeypatch.setattr(pafload, "_CHUNK", 4096)  # several pieces
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
    pieces = -(-cols["cpu"].shape[1] // 1024)
    if case == "grouped" and fmt3 == "1":
        assert n["decode3"] == pieces and n["unpack4"] == pieces
    elif case == "long":
        assert n["decode3"] == n["unpack4"] == pieces - 1
    else:
        assert n["decode3"] == 0 and n["unpack4"] > 0


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
    the CPU (their plain versions), bit for bit on all 4,096 columns."""
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
