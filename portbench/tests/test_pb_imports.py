"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program: each imported module's
top-level name is compared whole, since miniasm_tpu_torch begins with
miniasm_tpu.  The reference's C includes only system headers and opens
no file."""

import ast
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(PB))

from portbench import run as R  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "miniasm_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def _sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _sources(PB)}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    for p in _sources(os.path.join(PB, "ref")):
        tops = set(_imports(p))
        assert "miniasm_tpu_torch" not in tops, p
        assert tops <= {"__future__", "ctypes", "getopt", "gzip",
                        "hashlib", "io", "numpy", "os", "subprocess",
                        "time"}, \
            (p, tops)


def _c_sources():
    ref = os.path.join(PB, "ref")
    return [os.path.join(ref, f) for f in sorted(os.listdir(ref))
            if f.endswith((".c", ".h"))]


def test_reference_c_includes_only_system_headers_and_opens_no_file():
    srcs = _c_sources()
    assert srcs
    for p in srcs:
        text = open(p).read()
        incs = re.findall(r"^\s*#\s*include\s*(\S+)", text, re.M)
        assert set(incs) <= {"<stdint.h>", "<stdlib.h>", "<string.h>"}, \
            (p, incs)
        code = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
        assert "miniasm_tpu" not in code, p
        for call in ("fopen", "open", "mmap", "dlopen", "system", "popen"):
            assert not re.search(r"\b%s\s*\(" % call, code), (p, call)


def test_forbidden_modules_compares_whole_names():
    mods = {"miniasm_tpu_torch": 1, "miniasm_tpu_torch.cli": 1, "numpy": 1}
    assert R.forbidden_modules(mods) == []
    assert R.forbidden_modules(dict(mods, **{"miniasm_tpu.cli": 1})) == \
        ["miniasm_tpu"]
    assert R.forbidden_modules({"jax.numpy": 1, "jaxlib": 1, "flaxen": 1}) \
        == ["jax", "jaxlib"]


def test_the_harness_loads_no_forbidden_module():
    import subprocess

    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import run, devtrace; "
            "from portbench.ref import miniasm_ref; "
            "from portbench.gen import inputs; "
            "import miniasm_tpu_torch.cli, miniasm_tpu_torch.pipeline; "
            "print(run.forbidden_modules())" % os.path.dirname(PB))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
