"""The PyTorch port's MetricsCalculator and evaluate() against the JAX
package's, on the CPU at the tiny towers: the JAX calculator's weights
(PRNGKey(0), those of the pinned goldens) carried into the port, every metric
on the golden inputs of ``scripts/make_metric_goldens.py`` against the live
JAX calculator and ``tests/goldens/metrics.json``, then the CSV of both
evaluators on a synthetic 2-item mapping."""
import csv
import json
import os

import jax
import numpy as np
import pytest
from PIL import Image

from pnpinversion_tpu.data.pie_bench import mask_encode
from pnpinversion_tpu.evaluation import evaluate as jev
from pnpinversion_tpu.evaluation.calculator import MetricsCalculator as JaxCalculator
from pnpinversion_tpu_torch.evaluation import evaluate as tev
from pnpinversion_tpu_torch.evaluation.calculator import MetricsCalculator

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "metrics.json")
SRC_PROMPT, TGT_PROMPT = "a cat sitting on a wooden table", "a dog sitting on a wooden table"
METRICS = ["structure_distance", "psnr", "lpips", "mse", "ssim",
           "psnr_unedit_part", "lpips_unedit_part", "mse_unedit_part", "ssim_unedit_part",
           "structure_distance_unedit_part", "psnr_edit_part", "lpips_edit_part",
           "mse_edit_part", "ssim_edit_part", "clip_similarity_source_image",
           "clip_similarity_target_image", "clip_similarity_target_image_edit_part"]
# f32 on both sides, sums in other orders: relative to the value. The
# structure distance is a mean of squared differences of two near-equal
# self-similarity matrices (~1e-7), so it keeps fewer digits: 1e-4.
RTOL = {"structure_distance": 1e-4, "structure_distance_unedit_part": 1e-4}
DEFAULT_RTOL = 1e-5
CLIP_ATOL = 1e-4  # 100 x cosine, ~15 in size: CLIP's clamp at 0 pins the metrics


@pytest.fixture(scope="module")
def calcs():
    """(JAX calculator, the port's with the same weights), one per module:
    the JAX side's compiles are most of this file's cost."""
    jcalc = JaxCalculator(tiny=True)
    tcalc = MetricsCalculator(tiny=True, device="cpu",
                              jax_params=jax.tree.map(np.array, jcalc.params))
    return jcalc, tcalc


def _golden_inputs():
    """The fixed inputs of scripts/make_metric_goldens.py::compute_goldens."""
    rng = np.random.RandomState(2024)
    src = Image.fromarray((rng.rand(512, 512, 3) * 255).astype(np.uint8))
    tgt = Image.fromarray((np.clip(np.asarray(src) / 255.0 + rng.randn(512, 512, 3) * 0.08,
                                   0, 1) * 255).astype(np.uint8))
    mask = np.zeros((512, 512, 3))
    mask[128:384, 160:352] = 1
    return src, tgt, mask


def _close(got, want, rtol):
    return abs(got - want) <= rtol * abs(want)


def test_every_metric_matches_jax_and_goldens(calcs):
    jcalc, tcalc = calcs
    src, tgt, mask = _golden_inputs()
    with open(GOLDENS) as f:
        goldens = json.load(f)
    for metric in METRICS:
        got = float(tev.calculate_metric(tcalc, metric, src, tgt, mask, mask, SRC_PROMPT,
                                         TGT_PROMPT))
        want = float(jev.calculate_metric(jcalc, metric, src, tgt, mask, mask, SRC_PROMPT,
                                          TGT_PROMPT))
        rtol = RTOL.get(metric, DEFAULT_RTOL)
        if metric.startswith("clip"):
            assert got == want == goldens[metric] == 0.0, metric
        else:
            assert _close(got, want, rtol) and _close(got, goldens[metric], rtol), (
                metric, got, want, goldens[metric])
    # the raw cosines behind the clamped CLIP metrics
    for name, img, txt in (("raw_clip_cos_source", src, SRC_PROMPT),
                           ("raw_clip_cos_target", tgt, TGT_PROMPT)):
        assert abs(tcalc.clip_cosine(img, txt) - goldens[name]) <= CLIP_ATOL, name


def test_checkpoint_dir_names_roadmap_a13():
    with pytest.raises(NotImplementedError, match="A13"):
        MetricsCalculator(tiny=True, device="cpu", checkpoint_dir="weights")


def _write_run(root):
    """Two items in the runners' layout: one with a mask, one TI2I-like item
    without one (so the masked metrics and the source CLIP score are "nan")."""
    rng = np.random.RandomState(3)
    mask = np.zeros((512, 512), np.uint8)
    mask[100:260, 200:400] = 1
    mapping = {
        "000000000000": {"image_path": "0_random_140/000000000000.jpg",
                         "original_prompt": "a [cat] on a mat",
                         "editing_prompt": "a [dog] on a mat", "editing_instruction": "",
                         "editing_type_id": "0", "blended_word": "cat dog",
                         "mask": mask_encode(mask)},
        "ti2i_01": {"image_path": "ti2i/01.jpg", "editing_prompt": ["a bronze fox"]},
    }
    folder = root / "output" / "directinversion+p2p" / "annotation_images"
    for i, item in enumerate(mapping.values()):
        src = (rng.rand(512, 512, 3) * 255).astype(np.uint8)
        strip = np.concatenate([src, src, src // 2, 255 - src], axis=1)
        rel = item["image_path"]
        tgt_rel = rel if i == 0 else rel.replace(".jpg", "_0.jpg")
        for path, img in ((root / "data" / "annotation_images" / rel, src),
                          (folder / tgt_rel, strip)):
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(img).save(path)
    path = root / "data" / "mapping_file.json"
    path.write_text(json.dumps(mapping))
    return str(path), str(root / "data" / "annotation_images"), {
        "1_directinversion+p2p": str(folder)}


def test_evaluate_csv_matches_jax(calcs, tmp_path):
    jcalc, tcalc = calcs
    mapping, src_folder, folders = _write_run(tmp_path)
    results = {}
    for name, module, calc in (("jax", jev, jcalc), ("torch", tev, tcalc)):
        out = str(tmp_path / f"{name}.csv")
        module.evaluate(mapping, tev.DEFAULT_METRICS, src_folder, folders, out,
                        [str(i) for i in range(10)], calc)
        with open(out) as f:
            results[name] = list(csv.reader(f))
    want, got = results["jax"], results["torch"]
    assert got[0] == want[0] == ["file_id"] + [f"1_directinversion+p2p|{m}"
                                               for m in tev.DEFAULT_METRICS]
    assert len(got) == len(want) == 3
    for g_row, w_row in zip(got[1:], want[1:]):
        assert g_row[0] == w_row[0]
        for metric, g, w in zip(tev.DEFAULT_METRICS, g_row[1:], w_row[1:]):
            assert (g == "nan") == (w == "nan"), (g_row[0], metric)
            if w != "nan":
                assert _close(float(g), float(w), RTOL.get(metric, DEFAULT_RTOL)) or (
                    float(g) == float(w)), (g_row[0], metric, g, w)
    assert got[2][1:].count("nan") == 6  # the item without a mask or source prompt


def test_crop_and_sentinels_match_jax():
    strip = Image.fromarray(np.arange(24 * 96 * 3, dtype=np.uint8).reshape(24, 96, 3))
    np.testing.assert_array_equal(np.asarray(tev.crop_edit_panel(strip)),
                                  np.asarray(jev.crop_edit_panel(strip)))
    full, empty = np.ones((8, 8, 3)), np.zeros((8, 8, 3))
    for metric in tev.DEFAULT_METRICS + ["psnr_edit_part"]:
        for mask in (full, empty):
            for has_mask, prompt in ((True, "a cat"), (False, ""), (True, " ")):
                assert (tev._nan_sentinel(metric, mask, has_mask, prompt)
                        == jev._nan_sentinel(metric, mask, has_mask, prompt))
    assert tev.all_tgt_image_folders("out") == jev.all_tgt_image_folders("out")


def test_cli_needs_cuda_or_device_cpu(tmp_path):
    """The CLI runs on the card by default: without CUDA it raises before
    scoring anything, rather than fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    out = tmp_path / "result.csv"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tev.main(["--annotation_mapping_file", str(tmp_path / "missing.json"),
                  "--result_path", str(out), "--tgt_methods", "1_directinversion+p2p"])
    assert not out.exists()
