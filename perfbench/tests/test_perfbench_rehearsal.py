"""A CPU rehearsal of each cell at a tiny size through the harness's own code
(``tests/rehearsal.py``): the run prints its result, the check passes, and
no module whose top-level name is JAX's or the JAX package's was loaded. Then
the faults the check must catch, planted in the program under a run: a step
that returns its state unchanged, half of a batch left out (its images copied
from the other half), an answer altered where it is produced. (A cell on one
chip has no exchange between chips to leave out.) The tiny runs compute in
f32, whose readings sit far below the cells' limits."""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CELLS = ["sd14.di-p2p.sweep-b4", "sd21.bld.sweep-b4", "sd14.di-p2p.runner-f32"]


def rehearse(cell, *args):
    out = subprocess.run([sys.executable, os.path.join(HERE, "rehearsal.py"), cell,
                          "--dtype", "float32", *args],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    result = json.loads(next(ln for ln in lines if ln.startswith("{")))
    rc = int(next(ln for ln in lines if ln.startswith("RC ")).split()[1])
    forbidden = json.loads(next(ln for ln in lines if ln.startswith("FORBIDDEN ")).split(" ", 1)[1])
    return result, rc, forbidden, out.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_loads_no_jax(cell):
    result, rc, forbidden, err = rehearse(cell)
    assert rc == 0 and forbidden == []
    assert result["correct"] is True, err[-2000:]
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    assert list(result)[-1] == "checked"


def test_traced_rehearsal_reads_the_host_metrics():
    result, rc, forbidden, _ = rehearse(CELLS[0], "--trace", "1")
    assert rc == 0 and forbidden == [] and result["correct"] is True
    m = result["metrics"]
    assert m["unet_rows_per_image.sweep"]["value"] == 200 / 50 * 4  # 4 steps: (4 + 12) / 4 rows
    assert 0 < m["host_outside_unet_share.sweep"]["value"] < 100
    assert "breakdown" in result and "busy_s" in result["device"]


# an answer is altered where it is produced: in the uint8 panel the strip is
# written from (strip_err), and for BLD, whose panels are compared only by
# strip_err, also at the decoder's output (decode_rel)
FAULTS = [(CELLS[0], f) for f in ("step_unchanged", "half_batch", "answer_altered")]
FAULTS += [(CELLS[1], f) for f in ("step_unchanged", "half_batch", "answer_altered",
                                   "decoder_altered")]
FAULTS += [(CELLS[2], f) for f in ("step_unchanged", "answer_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault):
    result, rc, forbidden, err = rehearse(cell, "--fault", fault, "--batch",
                                          "1" if cell == CELLS[2] else "4")
    assert rc == 0
    assert result.get("correct") is False, err[-2000:]
