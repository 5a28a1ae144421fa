"""The reference's C (portbench/ref/native.c) against its specs: the radix
order against radix.py, the PAF read against paf.read_paf_numpy column for
column; a build that fails stops the run with its message; and the
reference's bytes are the all-NumPy reference's."""

import gzip
import os
import sys
import types

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench.gen import inputs  # noqa: E402
from portbench.ref import miniasm_ref as M  # noqa: E402
from portbench.ref import native, paf  # noqa: E402
from portbench.ref.radix import radix_argsort  # noqa: E402

U64 = np.uint64


def _keys(case, rng):
    if case == "empty":
        return np.zeros(0, U64)
    if case in ("one", "64", "65", "1e5"):
        n = {"one": 1, "64": 64, "65": 65, "1e5": 10**5}[case]
        return rng.integers(0, 2**63, n, dtype=np.int64).astype(U64) * U64(2)
    if case == "all_equal":
        return np.full(5000, 0xDEADBEEF12345678, U64)
    if case == "big_tie_bucket":
        # 300 equal keys in one bucket beside a spread of others
        k = rng.integers(0, 2**40, 2000).astype(U64)
        k[rng.choice(2000, 300, replace=False)] = U64(0x1234)
        return k
    if case == "top_bytes_in_order":
        # the top bytes already ascend, so their passes move nothing
        hi = np.sort(rng.integers(0, 200, 3000)).astype(U64) << U64(56)
        return hi | rng.integers(0, 2**48, 3000).astype(U64)
    if case == "hit_keys":
        # qid<<32|qs: reads of up to 300 hits, many of them at qs = 0
        reads = rng.integers(1, 300, 400)
        qid = np.repeat(np.arange(reads.size), reads)
        qs = rng.integers(0, 20000, qid.size)
        qs[rng.random(qid.size) < 0.3] = 0
        p = rng.permutation(qid.size)
        return (qid[p].astype(U64) << U64(32)) | qs[p].astype(U64)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["empty", "one", "64", "65", "1e5",
                                  "all_equal", "big_tie_bucket",
                                  "top_bytes_in_order", "hit_keys"])
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_radix_order_is_the_specs(case, seed):
    k = _keys(case, np.random.default_rng(seed))
    got = native.radix_order(k)
    assert got.dtype == np.int64
    assert (got == radix_argsort(k)).all()


def _same_read(fn, min_span=2000, min_match=100):
    for intern in ("order", "split"):
        a = paf.read_paf(fn, min_span, min_match, intern)
        b = paf.read_paf_numpy(fn, min_span, min_match, intern)
        assert set(a) == set(b)
        assert a["names"] == b["names"] and a["n_lines"] == b["n_lines"]
        for k in set(b) - {"names", "n_lines"}:
            assert a[k].dtype == b[k].dtype == np.int64, k
            assert np.array_equal(a[k], b[k]), (intern, k)
    return a


@pytest.mark.parametrize("traffic", ["minimap93", "mhap78"])
@pytest.mark.parametrize("circular", [False, True])
def test_paf_read_is_the_specs_on_the_writers_files(tmp_path, traffic,
                                                    circular):
    cfg = {"genome_len": 200_000, "coverage": 30.0, "circular": circular,
           "layout_seed": 61}
    with open(os.path.join(os.path.dirname(HERE), "traffic",
                           traffic + ".json")) as f:
        import json
        t = json.load(f)
    fn, lines = inputs.make_paf(cfg, t, 2**31 + 61, str(tmp_path))
    a = _same_read(fn)
    assert a["n_lines"] == lines and a["qid"].size > 1000


HAND = (
    # 12 fields, a '-' strand
    b"r1\t9000\t100\t5100\t-\tr2\t8000\t0\t5000\t4900\t5000\t60\n"
    # 10 fields: the block length of the line before
    b"r2\t8000\t10\t4010\t+\tr3\t7000\t0\t4000\t3000\n"
    # 9 fields: dropped, and no block length for the next
    b"r3\t7000\t0\t4000\t+\tr4\t6000\t0\t4000\n"
    # a leading non-digit reads 0; digits past 2^32 wrap
    b"r4\t6000\tx100\t4100\t+\tr5\t99999999999\t0\t4000\t4000\t4000\t0\n"
    # names of mixed widths; more than 12 fields and tags
    b"a\t3000\t0\t2500\t+\tlongername_0001\t3000\t500\t3000\t2400\t2500\t0"
    b"\ttp:A:S\tcm:i:9\n"
    # an empty line, a line without tabs
    b"\nnot a record\n"
    # a short overlap (kept out), then names seen only here
    b"r9\t5000\t0\t100\t+\tr10\t5000\t0\t100\t100\t100\t0\n"
    b"longername_0001\t3000\t0\t2600\t-\tr1\t9000\t0\t2600\t2500\t2600\t0\n"
    # a 10-field line at the end, without a final newline
    b"r5\t4000\t0\t3000\t+\ta\t3000\t0\t3000\t2900"
)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("cut", [len(HAND), HAND.index(b"r3\t7000"),
                                 HAND.index(b"\nnot")])
def test_paf_read_is_the_specs_on_hand_written_lines(tmp_path, gz, cut):
    fn = str(tmp_path / ("h.paf.gz" if gz else "h.paf"))
    data = HAND[:cut]
    with (gzip.open(fn, "wb") if gz else open(fn, "wb")) as f:
        f.write(data)
    a = _same_read(fn)
    b = _same_read(fn, min_span=0, min_match=0)
    assert b["qid"].size >= a["qid"].size


def test_paf_read_of_the_hand_lines():
    """The rules themselves, on the hand-written lines."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        fn = os.path.join(d, "h.paf")
        with open(fn, "wb") as f:
            f.write(HAND)
        a = paf.read_paf(fn, 0, 0)
    assert a["n_lines"] == 7
    assert a["names"] == ["r1", "r2", "r3", "r4", "r5", "a",
                          "longername_0001", "r9", "r10"]
    assert a["rev"].tolist()[:2] == [1, 0]
    assert a["bl"].tolist()[:2] == [5000, 5000]
    assert a["qs"][2] == 0 and a["lens"][4] == 99999999999 % 2**32
    assert a["bl"][-1] == 2600


def test_a_failed_build_fails_the_run(tmp_path, monkeypatch):
    """No quiet fall back: without a compiler the reference raises
    BuildError, and the harness's run stops with its own code and the
    compiler's message."""
    from portbench import run as R

    monkeypatch.setattr(native, "CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CC", "false")
    with pytest.raises(native.BuildError, match="did not build"):
        native.radix_order(np.arange(5, dtype=U64))
    monkeypatch.setenv("MINIASM_TPU_TORCH_DEVICE", "cpu")
    args = types.SimpleNamespace(workload="ecoli_exact", seed=2**31 + 13,
                                 seconds=0.2, trace=0)
    with pytest.raises(R.Failed, match="did not build") as e:
        R.run(args, device_check=False, sizes={"genome_len": 60_000})
    assert e.value.code == 5
    assert not os.listdir(tmp_path / "cache")


def _cfg(name):
    import json

    with open(os.path.join(os.path.dirname(HERE), "configs",
                           name + ".json")) as f:
        return json.load(f)


def _traffic(name):
    import json

    with open(os.path.join(os.path.dirname(HERE), "traffic",
                           name + ".json")) as f:
        return json.load(f)


# sha256 and sizes of the all-NumPy reference's output (commit a1c1d30),
# on one seed of each E. coli cell, a linear 3 Mb and a circular 2 Mb
# genome, and -p paf, whose hits come in miniasm's radix order
BYTES = [
    ("ecoli_exact", {}, "minimap93", 2**31 + 2401, "ug",
     "e167ebedacbbbbfa74b4d88b30f9d42052a8593acd65db93f9fa29f51144c172",
     151509, {"lines": 479403, "records": 363950, "reads": 17384,
              "arcs": 44070}),
    ("ecoli_half", {}, "mhap78", 2**31 + 2402, "ug",
     "eba4a07f0727076b3c73aea70db3eac82c8974367e4e4d324a83832ed6b23318",
     130182, {"lines": 402058, "records": 305078, "reads": 17384,
              "arcs": 46760}),
    ("linear_3mb", {"genome_len": 3_000_000, "circular": False,
                    "layout_seed": 2403}, "mhap78", 2403, "ug",
     "e90dd8cc8373991e32fd5b67bcbbd3b32dfcd24a0115ad8aea9f820551e0c713",
     80505, {"lines": 261335, "records": 198048, "reads": 11222,
             "arcs": 28602}),
    ("circular_2mb", {"genome_len": 2_000_000, "circular": True,
                      "layout_seed": 2404}, "minimap93", 2**31 + 2404, "ug",
     "97163938815ca9bed605bd3abfd916706204583bc8fac4501ba83ca3ae5848e0",
     66942, {"lines": 206385, "records": 156831, "reads": 7491,
             "arcs": 20198}),
    ("circular_2mb_paf", {"genome_len": 2_000_000, "layout_seed": 2405},
     "mhap78", 2405, "paf",
     "535b29fbbb2ce01afd7a795214426938afbdce3f716c9c5fd2bc3b6d7986e5d9",
     1670168, None),
]


@pytest.mark.parametrize("case", BYTES, ids=[c[0] for c in BYTES])
def test_assemble_gives_the_numpy_references_bytes(tmp_path, case):
    import hashlib

    _, sizes, traffic, seed, fmt, digest, n_bytes, counts = case
    cfg = dict(_cfg("ecoli_k12_pb30"), **sizes)
    fn, _ = inputs.make_paf(cfg, _traffic(traffic), seed, str(tmp_path))
    stats = {}
    out = M.assemble(fn, ["-p", fmt], stats=stats)
    assert (hashlib.sha256(out).hexdigest(), len(out)) == (digest, n_bytes)
    if counts:
        assert {k: stats[k] for k in counts} == counts
