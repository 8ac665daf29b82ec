"""The port's host-side training data (``training/data.py``,
``training/multitask.py``, ``training/prompt_dataset.py`` and the prompt
dataset's entry point) against the JAX package's copies: from the same files
and the same ``np.random.Generator`` seeds they give equal arrays and
records. No model runs here."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from _torch_parity import make_pair_dataset
from pnpinversion_tpu.training import data as jdata
from pnpinversion_tpu.training import multitask as jmt
from pnpinversion_tpu.training import prompt_dataset as jpd
from pnpinversion_tpu_torch.training import data
from pnpinversion_tpu_torch.training import multitask as mt
from pnpinversion_tpu_torch.training import prompt_dataset as pd


def assert_items_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]


def _img(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.mark.parametrize("n", [0, 1, 7, 20, 100, 1001])
def test_split_bounds(n):
    for split in ("train", "val", "test"):
        for splits in (data.SPLITS, (0.8, 0.1, 0.1), (1.0, 0.0, 0.0)):
            assert data.split_bounds(n, split, splits) == jdata.split_bounds(n, split, splits)


def test_edit_pair_dataset_weighted_concat_and_batches(tmp_path):
    """Random resize, shared crop and flip, two datasets mixed by weight,
    and process-disjoint batch streams: equal arrays and instructions."""
    roots = [make_pair_dataset(str(tmp_path / f"ds{i}"), n_items=5 + 3 * i, res=24)
             for i in range(2)]
    kw = dict(min_resize_res=16, max_resize_res=24, crop_res=12, flip_prob=0.5)
    for split in ("train", "val"):
        mk = lambda mod: [mod.EditPairDataset(r, split=split, **kw) for r in roots]
        ours, theirs = mk(data), mk(jdata)
        assert [len(d) for d in ours] == [len(d) for d in theirs]
        assert [d.seeds for d in ours] == [d.seeds for d in theirs]
    ours = [data.EditPairDataset(r, **kw) for r in roots]
    theirs = [jdata.EditPairDataset(r, **kw) for r in roots]
    for i in range(len(ours[0])):
        assert_items_equal(ours[0].get(i, np.random.default_rng(i)),
                           theirs[0].get(i, np.random.default_rng(i)))
    mix, jmix = data.WeightedConcat(ours, [1.0, 3.0]), jdata.WeightedConcat(theirs, [1.0, 3.0])
    assert len(mix) == len(jmix)
    np.testing.assert_array_equal(mix.p, jmix.p)
    for process in (0, 1):
        got = list(data.batches(mix, 3, seed=5, process_index=process, num_batches=3))
        want = list(jdata.batches(jmix, 3, seed=5, process_index=process, num_batches=3))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert_items_equal(g, w)
    single = next(data.batches(ours[1], 2, seed=1))
    assert_items_equal(single, next(jdata.batches(theirs[1], 2, seed=1)))
    empty = data.WeightedConcat([data.EditPairDataset(roots[0], split="val", **kw)])
    with pytest.raises(ValueError):
        empty.sample(np.random.default_rng(0))


@pytest.fixture
def seg_root(tmp_path):
    root = str(tmp_path / "cocostuff")
    rng = np.random.RandomState(0)
    for i in range(3):
        label = np.full((40, 48), 255, np.uint8)
        label[8:24, 8:24] = 5
        label[20:36, 30:44] = 11
        _img(os.path.join(root, "images", "train2017", f"{i:06d}.jpg"),
             rng.randint(0, 255, (40 + 8 * (i == 1), 48 - 16 * (i == 2), 3), np.uint8))
        _img(os.path.join(root, "annotations", "train2017", f"{i:06d}.png"),
             label[: 40 + 8 * (i == 1), : 48 - 16 * (i == 2)] if i != 1 else
             np.pad(label, ((0, 8), (0, 0)), constant_values=255))
    with open(os.path.join(root, "labels.txt"), "w") as f:
        for k in range(182):
            f.write(f"{k + 1}: class{k}\n")
    return root


def test_segmentation_paint_dataset(seg_root):
    for kw in (dict(crop_res=32), dict(crop_res=24, transparency=0.4, empty_percentage=0.5,
                                       flip_prob=0.5)):
        ours, theirs = mt.SegmentationPaintDataset(seg_root, **kw), jmt.SegmentationPaintDataset(
            seg_root, **kw)
        assert len(ours) == len(theirs) == 3
        for i in range(3):
            for seed in range(3):
                assert_items_equal(ours.get(i, np.random.default_rng(seed)),
                                   theirs.get(i, np.random.default_rng(seed)))


def test_keypoint_circle_dataset(tmp_path):
    root = str(tmp_path / "pose")
    rng = np.random.RandomState(1)
    _img(os.path.join(root, "im0.jpg"), rng.randint(0, 255, (64, 48, 3), np.uint8))
    _img(os.path.join(root, "im1.jpg"), rng.randint(0, 255, (40, 40, 3), np.uint8))
    items = [{"image": "im0.jpg", "joints": [[32, 32, 2], [8, 8, 0], [300, 300, 2], [40, 60, 1],
                                             [0, 2, 2]]},
             {"image": "im1.jpg", "joints": [[10, 30, 2], [20, 20, 2]]}]
    with open(os.path.join(root, "keypoints.json"), "w") as f:
        json.dump(items, f)
    kw = dict(crop_res=32, radius=4, transparency=0.25, flip_prob=0.5, max_prompt_num=4)
    ours, theirs = mt.KeypointCircleDataset(root, **kw), jmt.KeypointCircleDataset(root, **kw)
    for i in range(2):
        for seed in range(4):
            assert_items_equal(ours.get(i, np.random.default_rng(seed)),
                               theirs.get(i, np.random.default_rng(seed)))


@pytest.mark.parametrize("sample_weight,instruct", [(1.0, False), (2.0, True), (0.5, False)])
def test_paired_restoration_dataset(tmp_path, sample_weight, instruct):
    root = str(tmp_path / "gopro")
    rng = np.random.RandomState(2)
    for i, (h, w) in enumerate([(30, 40), (44, 36), (32, 32), (36, 50)]):
        for sub in ("input", "target"):
            _img(os.path.join(root, "train", sub, f"{i:03d}.png"),
                 rng.randint(0, 255, (h, w, 3), np.uint8))
    kw = dict(task="denoise", size=24, sample_weight=sample_weight, instruct=instruct)
    ours = mt.PairedRestorationDataset(root, **kw)
    theirs = jmt.PairedRestorationDataset(root, **kw)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        assert_items_equal(ours.get(i, np.random.default_rng(i)),
                           theirs.get(i, np.random.default_rng(i)))


def test_prompt_dataset_format_and_parsing():
    recs = [{"input": "a cat", "edit": "make it a dog", "output": "a dog"},
            {"input": "a house.", "edit": "add snow", "output": "a house in snow"}]
    assert pd.prepare_for_gpt(recs) == jpd.prepare_for_gpt(recs)
    cases = [("a cat", "make it red\n%%\na red cat\nEND"), ("a cat", "x\n%%\nA cat!"),
             ("a cat", "no delimiter"), ("a cat", None), ("a cat", "a\n%%\nb\n%%\nc"),
             ("a cat.", "add a hat\n%%\na cat with a hat")]
    for caption, text in cases:
        assert pd.parse_completion(caption, text) == jpd.parse_completion(caption, text)
    for i in range(12):
        prompt = f"a photo of a bridge {i}.{pd.DELIMITER_0}"
        assert pd.template_complete(prompt, i) == jpd.template_complete(prompt, i)
    for n, parts, seed in ((10, 3, 0), (7, 2, 5), (1, 1, 0)):
        for part in range(parts):
            np.testing.assert_array_equal(pd.partition_captions(n, parts, part, seed),
                                          jpd.partition_captions(n, parts, part, seed))


def test_generate_prompt_dataset_resume_and_dedup(tmp_path):
    """Existing records count and are never regenerated, repeated captions
    and urls are skipped, flagged captions dropped: the same file as JAX's."""
    captions = ["a cat", "a dog", "a cat", "a red bus", "a tree", "a boat", "a lamp"]
    urls = ["u0", "u1", "u2", "u1", "u4", "u5", "u6"]
    flagged = lambda text: "boat" in text
    out = {}
    for name, mod in (("jax", jpd), ("torch", pd)):
        path = str(tmp_path / name / "prompts.jsonl")
        os.makedirs(os.path.dirname(path))
        with open(path, "w") as f:
            f.write(json.dumps({"caption": "a tree", "edit": "e", "output": "o",
                                "url": "u9"}) + "\n")
        calls = iter(range(100))
        complete = lambda p: mod.template_complete(p, next(calls))
        n1 = mod.generate_prompt_dataset(captions[:3], complete, path, 3, urls=urls[:3])
        n2 = mod.generate_prompt_dataset(captions, complete, path, 6, urls=urls,
                                         moderation_fn=flagged)
        out[name] = (n1, n2, open(path).read())
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == (3, 4)


def test_prompt_dataset_cli(tmp_path):
    """The port's entry point and the JAX runner write the same records."""
    import runners.run_prompt_dataset as jrunner
    from pnpinversion_tpu_torch.runners import run_prompt_dataset as runner

    caps = tmp_path / "captions.txt"
    caps.write_text("a cat on a mat\na red car\n\na house by a lake\na cat on a mat\n")
    outs = []
    for main, name in ((jrunner.main, "jax"), (runner.main, "torch")):
        path = tmp_path / f"{name}.jsonl"
        main(["generate", "--captions_file", str(caps), "--output_path", str(path),
              "--num_samples", "10", "--num_partitions", "1", "--seed", "3"])
        outs.append(path.read_text())
    assert outs[1] == outs[0] and len(outs[0].splitlines()) == 3
    human = tmp_path / "human.jsonl"
    human.write_text(json.dumps({"input": "a", "edit": "b", "output": "c"}) + "\n")
    assert runner.main(["prepare-for-gpt", "--input_path", str(human),
                        "--output_path", str(tmp_path / "ft.jsonl")]) == 1
    assert (json.loads((tmp_path / "ft.jsonl").read_text())
            == jpd.prepare_for_gpt([{"input": "a", "edit": "b", "output": "c"}])[0])
