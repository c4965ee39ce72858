"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: every module under portbench/
parsed with ``ast``, top-level names compared whole (the port's name
begins with the JAX package's)."""

import ast
import os
import sys
import types

import pytest

from conftest import BENCH_DIR, result_line
from portbench import run

JAX = {"jax", "jaxlib", "flax", "pyaudiodsptools_tpu"}
PORT = "pyaudiodsptools_tpu_torch"


def modules():
    for dirpath, _dirs, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_module_imports_jax(path):
    assert not imported(path) & JAX


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "reference")
    for path in modules():
        if path.startswith(ref):
            assert PORT not in imported(path), path


def test_only_the_driving_modules_import_the_program():
    allowed = {"port.py", os.path.join("loops", "sharded.py")}
    for path in modules():
        rel = os.path.relpath(path, BENCH_DIR)
        if rel.startswith("tests"):
            continue
        if PORT in imported(path):
            assert rel in allowed, rel


def test_forbidden_names_are_whole_top_level_names():
    assert run.forbidden_modules([PORT, f"{PORT}.ops", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "x"]) == \
        ["jax", "jaxlib"]
    assert run.forbidden_modules(["pyaudiodsptools_tpu.ops"]) == \
        ["pyaudiodsptools_tpu"]


def test_a_run_with_jax_loaded_prints_no_result(checkout, capsys,
                                                monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "dynstrip.offline_pauses", "--seed", "5",
                   "--seconds", "0.5"], device="cpu", root=checkout)
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == "" and "jax" in err


def test_without_jax_the_same_run_prints_its_result(checkout, capsys):
    rc = run.main(["--workload", "dynstrip.offline_pauses", "--seed", "5",
                   "--seconds", "0.5"], device="cpu", root=checkout)
    assert rc == 0
    assert result_line(capsys.readouterr().out)["correct"] is True
