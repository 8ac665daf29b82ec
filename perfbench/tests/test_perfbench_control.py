"""The control of each cell comes out not correct: the reference computed one
precision below the configuration's, put in the program's place (fp8
operands for the bf16 cells, TF32 for the f32 runner), reads above the cell's
limits on at least one number. On the CPU at a tiny size for the fp8
controls (TF32 does not exist on the CPU); on the card at the cells' own size
(marked ``cuda``)."""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

CONTROLS = {"sd14.di-p2p.sweep-b4": "reference:fp8", "sd21.bld.sweep-b4": "reference:fp8",
            "sd14.di-p2p.runner-f32": "reference:tf32"}


def _readings(cell, controls, seeds, tiny):
    code = ("import sys, json; sys.path[0] = sys.argv[1]; from perfbench import control; "
            "from perfbench.tests import rehearsal as r; "
            "tiny = json.loads(sys.argv[5]); "
            "control.main(['--workload', sys.argv[2], '--seeds', sys.argv[3], '--controls', "
            "sys.argv[4], '--control-seeds', sys.argv[3]], "
            "rehearsal={'config': r.tiny_config(), 'mix': r.TINY_MIX} if tiny else None)")
    out = subprocess.run([sys.executable, "-c", code, ROOT, cell, seeds, controls,
                          json.dumps(tiny)], capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]


def _fails(reading, limits):
    return [k for k, v in limits.items() if k in reading and reading[k] > v["limit"]]


@pytest.mark.parametrize("cell", ["sd14.di-p2p.sweep-b4", "sd21.bld.sweep-b4"])
def test_fp8_control_is_not_correct_tiny(cell):
    limits = harness.load_cell(cell)["limits"]["numbers"]
    lines = _readings(cell, CONTROLS[cell], "11", tiny=True)
    ctl = next(ln for ln in lines if ln["candidate"] == CONTROLS[cell])
    assert _fails(ctl, limits), ctl


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_control_is_not_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control is read at the cell's own size")
    limits = harness.load_cell(cell)["limits"]["numbers"]
    lines = _readings(cell, CONTROLS[cell], "3000009001,3000009002,3000009003", tiny=False)
    ctl = [ln for ln in lines if ln["candidate"] == CONTROLS[cell]]
    prog = [ln for ln in lines if ln["candidate"] == "program"]
    assert len(ctl) == 3 and all(_fails(ln, limits) for ln in ctl), ctl
    assert not any(_fails(ln, limits) for ln in prog), prog
