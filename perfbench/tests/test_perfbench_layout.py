"""Every cell of BENCHMARK.json resolves to its files by name, and a cell
added as new files only, in a copy of the benchmark, is found."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.load_cell(name)
    assert cell["work"] and cell["limits"], name
    assert os.path.exists(os.path.join(harness.HERE, "drivers", f"{cell['driver']}.py"))
    assert cell["end_to_end"] and cell["per_layer"]
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for m in cell["per_layer"]:
        assert m["moves"] in names
        assert hasattr(harness.load_module("metrics", m["name"]), "read")
    method = harness.method(cell["mix"])
    assert method.calls_per_chunk(cell["mix"]) > 0
    assert callable(method.outputs) and callable(method.work)
    for k in cell["limits"]["numbers"]:
        assert cell["limits"]["numbers"][k]["limit"] >= 0  # 0: an exact comparison


def test_contract_shape():
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"])) and c["reduced"] == []
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_cell_from_files_only(tmp_path):
    """A cell added by new files and a new BENCHMARK.json entry, nothing
    edited: a new mix whose method is a new family file."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "sd21.di-p2p.sweep-b4", "config": "sd21",
                               "traffic": "new.sweep-b4", "chips": 1, "why": "a test"})
    pb = tmp_path / "perfbench"
    mix = json.loads((pb / "mixes" / "di-p2p.sweep-b4.json").read_text())
    (pb / "mixes" / "new.sweep-b4.json").write_text(json.dumps(dict(mix, family="new-family")))
    shutil.copy(pb / "reference" / "methods" / "di-p2p.py",
                pb / "reference" / "methods" / "new-family.py")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sd14.di-p2p.sweep-b4" in m.get("workloads", []):
            m["workloads"].append("sd21.di-p2p.sweep-b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for kind in ("work", "limits"):
        shutil.copy(tmp_path / "perfbench" / kind / "sd14.di-p2p.sweep-b4.json",
                    tmp_path / "perfbench" / kind / "sd21.di-p2p.sweep-b4.json")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from perfbench import harness; "
            "c = harness.load_cell('sd21.di-p2p.sweep-b4'); "
            "assert c['config']['unet']['cross_attention_dim'] == 1024; "
            "assert c['mix']['method'] == 'directinversion+p2p'; "
            "m = harness.method(c['mix']); assert m.calls_per_chunk(c['mix']) == 100; "
            "assert m.__file__.endswith('new-family.py'); "
            "assert harness.HERE.startswith(sys.argv[1]); print('found', len(c['per_layer']))")
    import subprocess

    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("found")
