"""``scripts/rehearse_torch.py`` end to end on the CPU at TINY: its seeded
SD1.4 and SD2.1 directories written and loaded, ``run_sweep_sharded`` of its
three default methods and ``evaluate --sharded`` each in a fresh process
(``tests/_torch_mp_worker.py module``: the configs at TINY, the metric
towers tiny), over 3 items at 2 DDIM steps, scored by the metrics that need
no mask (PIE-Bench's masks are 512^2, TINY's panels 16^2). The report has every key of
``docs/rehearsal.json``'s and the card's line, each method edited every
item, and the CSV has a row per item with every method's metrics."""
import csv
import importlib.util
import json
import os
import sys

import pytest

import _torch_mp_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITEMS, SIZE = 3, 16
METRICS = ("structure_distance", "clip_similarity_source_image",
           "clip_similarity_target_image")


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "rehearse_torch", os.path.join(REPO, "scripts", "rehearse_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    configs = worker.rehearsal_configs()
    script.SD14, script.SD21 = configs["sd14"], configs["sd21"]
    script.PYTHON = [sys.executable, worker.__file__, "module"]
    script.STEPS, script.SIZE, script.METRICS = 2, SIZE, METRICS
    root = tmp_path_factory.mktemp("rehearsal")
    out = os.path.join(root, "rehearsal_torch.json")
    report = script.main(["--images", str(ITEMS), "--workdir", str(root / "work"), "--out", out,
                          "--device", "cpu", "--timeout", "120"])
    with open(out) as f:
        assert json.load(f) == report
    report["csv"] = str(root / "work" / "rehearsal_eval.csv")
    return script, report


def test_report_has_every_key(rehearsal):
    script, report = rehearsal
    assert {"card", "device", "images", "steps", "methods", "eval", "end_to_end_wall_s",
            "steady_sweep_s_per_image_avg"} <= set(report)
    assert sorted(report["methods"]) == sorted(script.DEFAULT_METHODS)
    for rec in report["methods"].values():
        assert set(rec) == {"wall_s", "images_done", "rc", "first_image_gap_s",
                            "steady_s_per_image"}
        assert rec["steady_s_per_image"] > 0 and rec["first_image_gap_s"] > 0
    assert {"wall_s", "rc", "method_image_pairs", "s_per_pair"} <= set(report["eval"])
    assert report["eval"]["method_image_pairs"] == ITEMS * len(script.DEFAULT_METHODS)


def test_every_method_edits_every_item(rehearsal):
    _, report = rehearsal
    assert report["images"] == ITEMS
    assert {m: (r["rc"], r["images_done"]) for m, r in report["methods"].items()} == {
        m: (0, ITEMS) for m in report["methods"]}
    assert report["eval"]["rc"] == 0


def test_csv_has_a_row_per_item_with_every_method(rehearsal):
    script, report = rehearsal
    with open(report["csv"]) as f:
        rows = list(csv.reader(f))
    head, body = rows[0], rows[1:]
    assert [r[0] for r in body] == [f"{i:06d}" for i in range(ITEMS)]
    for m in script.DEFAULT_METHODS:
        cols = [i for i, h in enumerate(head) if h.startswith(f"{script.eval_key(m)}|")]
        assert len(cols) == len(METRICS), (m, head)
        assert all(r[i] not in ("", "nan") for r in body for i in cols)


def test_gaps_read_bursts_of_a_batch(tmp_path):
    """Chunks of 4 strips starting at 0, 2 and 5 s: the per-image gaps are
    the chunks' distance over 4, whatever the strips' spacing within one."""
    spec = importlib.util.spec_from_file_location(
        "rehearse_torch", os.path.join(REPO, "scripts", "rehearse_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    log = tmp_path / "log.jsonl"
    ts = [0, 0.1, 0.2, 0.3, 2.0, 3.2, 4.4, 4.5, 5.0, 5.1, 5.2, 5.3]
    log.write_text("".join(json.dumps({"ts": t, "event": "image_done", "chunk": i // 4}) + "\n"
                           for i, t in enumerate(ts)))
    gaps, n = script.gaps(str(log))
    assert n == 12 and gaps == pytest.approx([0.5, 0.75])
