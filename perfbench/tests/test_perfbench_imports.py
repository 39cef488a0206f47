"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the port."""

import ast
import sys

from perfbench import harness
from perfbench.tests.conftest import REPO

PERFBENCH = REPO / "perfbench"


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax():
    for path in PERFBENCH.rglob("*.py"):
        assert not imported_top_names(path) & set(harness.FORBIDDEN), path


def test_reference_and_generators_import_nothing_of_the_port():
    for sub in ("reference", "gen"):
        for path in (PERFBENCH / sub).glob("*.py"):
            assert "riptrm_torch" not in imported_top_names(path), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import riptrm_torch  # noqa: F401  its name starts with the JAX package's prefix

    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "riptrm_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxish", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "riptrm_tpu", object())
    assert harness.forbidden_modules() == ["jaxlib", "riptrm_tpu"]
