"""Nothing the benchmark runs loads JAX or the JAX package: neither in the
harness's own sources nor, at run time, in the process that runs a cell
(compared by whole top-level names: the port's name begins with the JAX
package's)."""
from __future__ import annotations

import ast
import subprocess
import sys

from tb_small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pumiumtally_tpu"}


def top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = [p for p in (ROOT / "tallybench").rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for p in files:
        assert not set(top_names(p)) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "tallybench" / "reference").rglob("*.py"):
        names = set(top_names(p))
        assert "pumiumtally_tpu_torch" not in names, p
        assert names <= {"__future__", "dataclasses", "math", "numpy",
                         "torch"}, (p, names)


def test_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from tb_small import run_small\n"
        "from tallybench import harness\n"
        "res = run_small('pincell-casmo8-f64.source')\n"
        "assert res['line']['correct'], res['nums']\n"
        "assert 'pumiumtally_tpu_torch' in sys.modules\n"
        "print('LOADED', harness.forbidden_modules())\n"
        % (str(ROOT), str(ROOT / "tallybench" / "tests")))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "LOADED []" in p.stdout


def test_forbidden_names_are_whole(monkeypatch):
    """The port loaded is no JAX package; a module of that top-level name
    is."""
    import types

    from tallybench import harness

    import pumiumtally_tpu_torch  # noqa: F401

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pumiumtally_tpu.api",
                        types.ModuleType("pumiumtally_tpu.api"))
    assert harness.forbidden_modules() == ["pumiumtally_tpu"]
