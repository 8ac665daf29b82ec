"""The port's batched evaluator (``evaluation.sharded.ShardedEvaluator``) on the
CPU at the tiny towers: against the JAX package's ``ShardedEvaluator`` on a
2-device mesh (built as ``tests/test_sharded_eval.py`` builds it, the port
given the JAX calculator's weights) and against the port's serial
calculator, one device and two; and ``evaluate(sharded=True)``'s CSV against
the serial one, "nan" sentinels and an unreadable target included."""
import csv
import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from pnpinversion_tpu.evaluation.calculator import MetricsCalculator as JaxCalculator
from pnpinversion_tpu.evaluation.sharded import ShardedEvaluator as JaxSharded
from pnpinversion_tpu.parallel.sweep import make_dp_mesh
from pnpinversion_tpu_torch.data.pie_bench import mask_encode
from pnpinversion_tpu_torch.evaluation import evaluate as tev
from pnpinversion_tpu_torch.evaluation.calculator import MetricsCalculator
from pnpinversion_tpu_torch.evaluation.sharded import SUPPORTED, ShardedEvaluator

torch.set_num_threads(2)

TOL = 1e-4  # of each metric's max over the batch: f32 on both sides, sums in other orders


@pytest.fixture(scope="module")
def calcs():
    jcalc = JaxCalculator(tiny=True)
    tcalc = MetricsCalculator(tiny=True, device="cpu",
                              jax_params=jax.tree.map(np.array, jcalc.params))
    return jcalc, tcalc


def _inputs(n: int = 3, size: int = 32):
    rng = np.random.RandomState(0)
    src = (rng.rand(n, size, size, 3) * 255).astype(np.uint8)
    tgt = (rng.rand(n, size, size, 3) * 255).astype(np.uint8)
    masks = np.zeros((n, size, size, 3), np.uint8)
    for i in range(n):
        masks[i, 4: 12 + i, 6:20] = 1
    return (src, tgt, masks, ["a cat on a mat", "a red car", "trees in autumn"][:n],
            ["a dog on a mat", "a blue car", "trees in winter"][:n])


def _close(got: np.ndarray, want: np.ndarray) -> bool:
    return float(np.abs(got - want).max()) <= TOL * max(float(np.abs(want).max()), 1e-6)


def test_matches_jax_sharded_and_the_serial_calculator(calcs):
    from pnpinversion_tpu_torch.evaluation.evaluate import calculate_metric

    jcalc, tcalc = calcs
    src, tgt, masks, sp, tp = _inputs()
    want = JaxSharded(jcalc, mesh=make_dp_mesh(2)).evaluate_batch(SUPPORTED, src, tgt, masks,
                                                                   sp, tp)
    for devices in (None, ["cpu", "cpu"]):  # one block; two blocks, the batch padded to 4
        ev = ShardedEvaluator(tcalc, devices)
        got = ev.evaluate_batch(SUPPORTED, src, tgt, masks, sp, tp)
        for m in SUPPORTED:
            assert got[m].shape == (3,) and got[m].dtype == np.float32, m
            assert _close(got[m], np.asarray(want[m])), (m, got[m], want[m])
            serial = np.array([calculate_metric(tcalc, m, src[i], tgt[i], masks[i], masks[i],
                                                sp[i], tp[i]) for i in range(3)])
            assert _close(got[m], serial), (m, got[m], serial)
    assert len(ev._models) == 2
    np.testing.assert_allclose(ev.text_features(sp).numpy(),
                               np.stack([tcalc._clip_text_features(p).numpy() for p in sp]),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unsupported"):
        ev.evaluate_batch(["fid"], src, tgt, masks, sp, tp)


def test_sharded_csv_equals_serial(calcs, tmp_path, monkeypatch):
    """``evaluate(sharded=True, batch_size=2)`` writes the serial CSV: the
    same cells within TOL, "nan" where the serial path has it (a full mask,
    an item without mask or source prompt); an unreadable target is "nan" in
    its row only."""
    _, tcalc = calcs
    size = 32
    rng = np.random.RandomState(1)
    src_dir, data = tmp_path / "src", tmp_path / "strips"
    mapping = {}
    for i in range(4):
        rel = f"0_x/{i:06d}.png"
        for root, arr in ((src_dir, rng.rand(size, size, 3)), (data, rng.rand(size, 4 * size, 3))):
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray((arr * 255).astype(np.uint8)).save(root / rel)
        mask = np.zeros((size, size), np.uint8)
        mask[4:20, 6:20] = 1
        if i == 2:
            mask[:] = 1  # the unedited part is empty: "nan"
        item = {"image_path": rel, "original_prompt": "a [cat]", "editing_prompt": "a [dog]",
                "editing_type_id": "0", "mask": mask_encode(mask)}
        if i == 3:  # a TI2I-like item: no mask, no source prompt
            del item["mask"], item["original_prompt"]
        mapping[f"{i:06d}"] = item
    (tmp_path / "mapping.json").write_text(json.dumps(mapping))
    orig = tev.mask_decode
    monkeypatch.setattr(tev, "mask_decode", lambda rle: orig(rle, (size, size)))
    monkeypatch.setattr(tev, "_normalized_items", _sized(tev._normalized_items, size))
    metrics = ["psnr", "ssim_unedit_part", "lpips_edit_part", "structure_distance",
               "clip_similarity_source_image", "clip_similarity_target_image"]
    kw = dict(src_image_folder=str(src_dir), tgt_image_folders={"1_directinversion+p2p": str(data)},
              edit_category_list=["0"], calc=tcalc)
    tev.evaluate(str(tmp_path / "mapping.json"), metrics, result_path=str(tmp_path / "s.csv"),
                 **kw)
    tev.evaluate(str(tmp_path / "mapping.json"), metrics, result_path=str(tmp_path / "b.csv"),
                 sharded=True, batch_size=2, **kw)
    serial = list(csv.reader(open(tmp_path / "s.csv")))
    batched = list(csv.reader(open(tmp_path / "b.csv")))
    assert serial[0] == batched[0] and len(serial) == len(batched) == 5
    for row_s, row_b in zip(serial[1:], batched[1:]):
        assert row_s[0] == row_b[0]
        for a, b in zip(row_s[1:], row_b[1:]):
            assert (a == "nan") == (b == "nan"), (row_s, row_b)
            if a != "nan":
                assert abs(float(a) - float(b)) <= TOL * max(abs(float(a)), 1e-3), (a, b)
    assert serial[3][2] == "nan" and serial[4][2] == serial[4][5] == "nan"

    (data / "0_x" / "000001.png").write_bytes(b"not an image")
    tev.evaluate(str(tmp_path / "mapping.json"), metrics, result_path=str(tmp_path / "c.csv"),
                 sharded=True, batch_size=2, **kw)
    broken = list(csv.reader(open(tmp_path / "c.csv")))
    assert broken[2][1:] == ["nan"] * len(metrics) and broken[1] == batched[1]
    with pytest.raises(ValueError, match="--sharded"):
        tev.evaluate(str(tmp_path / "mapping.json"), ["fid"], result_path=str(tmp_path / "d.csv"),
                     sharded=True, **kw)


def _sized(normalized_items, size: int):
    """``_normalized_items`` with a mask-less item's zero mask at the test's
    image size (the reader makes it 512², the benchmark's size)."""
    def items(annotation, categories):
        for it in normalized_items(annotation, categories):
            if not it["has_mask"]:
                it["mask"] = np.zeros((size, size, 3))
            yield it
    return items
