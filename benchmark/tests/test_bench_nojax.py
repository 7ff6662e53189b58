"""No module of the benchmark or of the port imports JAX, jaxlib, flax or
the JAX package: a static look at every import statement, comparing each
module's top-level name whole (``ikpso_tpu_torch`` begins with
``ikpso_tpu``)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "ikpso_tpu"}


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value.split(".")[0]


def modules():
    out = sorted((ROOT / "benchmark").rglob("*.py")) + sorted(
        (ROOT / "ikpso_tpu_torch").rglob("*.py"))
    return [p for p in out if "__pycache__" not in p.parts]


def test_the_look_finds_modules():
    names = {p.relative_to(ROOT).as_posix() for p in modules()}
    assert "benchmark/run.py" in names and "ikpso_tpu_torch/bench.py" in names


@pytest.mark.parametrize("package", ["benchmark", "ikpso_tpu_torch"])
def test_no_jax_imports(package):
    bad = []
    for path in modules():
        if path.relative_to(ROOT).parts[0] != package:
            continue
        for line, top in imported_top_levels(path):
            if top in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}:{line} imports {top}")
    assert not bad, bad


def test_whole_name_comparison():
    src = "import ikpso_tpu_torch.bench\nfrom ikpso_tpu.pso import x\nimport jax.numpy\n"
    p = ROOT / "build" / "nojax_probe.py"
    p.parent.mkdir(exist_ok=True)
    p.write_text(src)
    try:
        tops = [t for _, t in imported_top_levels(p)]
    finally:
        p.unlink()
    assert tops == ["ikpso_tpu_torch", "ikpso_tpu", "jax"]
    assert [t for t in tops if t in FORBIDDEN] == ["ikpso_tpu", "jax"]


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from benchmark import run

    assert run.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "ikpso_tpu.fake", types.ModuleType("ikpso_tpu.fake"))
    assert "ikpso_tpu" in run.forbidden_modules()


def test_the_reference_takes_nothing_of_the_program():
    for path in sorted((ROOT / "benchmark" / "reference").rglob("*.py")):
        tops = {t for _, t in imported_top_levels(path)}
        assert not tops & (FORBIDDEN | {"ikpso_tpu_torch"}), path
