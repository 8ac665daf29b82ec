"""The frozen count reproduces each cell's work file; at SD1.4, one image at
50 steps, it is the 167.31 TF of the main path's edit (the program's own
FLOP count, equal to the JAX package's up to its named amounts)."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import flops, harness  # noqa: E402

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_work_file_is_the_count(name):
    cell = harness.load_cell(name)
    counted = flops.work(cell["config"], cell["mix"])
    assert counted["flops_per_image"] == pytest.approx(cell["work"]["flops_per_image"], rel=1e-12)
    assert counted["flash"] == cell["work"]["flash"]
    assert counted["chunk_images"] == cell["work"]["chunk_images"]


def test_sd14_one_image_is_pr17_count():
    cell = harness.load_cell("sd14.di-p2p.runner-f32")
    counted = flops.work(cell["config"], cell["mix"])
    assert counted["flops_per_image"] == pytest.approx(167.31e12, abs=0.005e12)
    # the flash kernel's shapes and launches of one image (PERF.md's kernel table)
    assert counted["flash"] == [[8, 1024, 1024, 80, 250], [8, 4096, 4096, 40, 250],
                                [24, 1024, 1024, 80, 250], [24, 4096, 4096, 40, 250]]
