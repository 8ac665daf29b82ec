"""The reference imports nothing of the program, and nothing the benchmark
loads is JAX or the JAX package (top-level names compared whole)."""
import ast
import glob
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    paths = glob.glob(os.path.join(ROOT, "perfbench", "reference", "**", "*.py"), recursive=True)
    assert any(os.sep + "methods" + os.sep in p for p in paths)
    for path in paths:
        names = set(_imports(path))
        assert not names & {"pnpinversion_tpu_torch", "pnpinversion_tpu", "jax", "jaxlib"}, path
        assert names <= {"__future__", "dataclasses", "io", "json", "math", "os", "re",
                         "typing", "numpy", "torch", "PIL", "perfbench"}, (path, names)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import perfbench.reference.check, perfbench.flops, perfbench.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'pnpinversion_tpu_torch', 'pnpinversion_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole():
    assert harness.forbidden_modules(["pnpinversion_tpu_torch.models", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["pnpinversion_tpu.models", "jax", "flax.linen"]) == [
        "flax.linen", "jax", "pnpinversion_tpu.models"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                          "--workload", "sd14.di-p2p.sweep-b4", "--seed", "1",
                          "--seconds", "10", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_jax_loaded_by_a_reader_prints_no_result(tmp_path):
    """A per-layer reader that loads a module named ``jax`` after the window
    (here a stub) leaves the traced run without a result line."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    reader = tmp_path / "perfbench" / "metrics" / "mfu.sweep.py"
    reader.write_text("import jax  # noqa: F401\n" + reader.read_text())
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path / "stub"), ROOT]))
    out = subprocess.run([sys.executable, str(tmp_path / "perfbench" / "tests" / "rehearsal.py"),
                          "sd14.di-p2p.sweep-b4", "--dtype", "float32", "--trace", "1"],
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "{}" and "RC 3" in lines, out.stdout
    assert "loaded in the measuring process: jax" in out.stderr
