"""The PIE-Bench data layer of the PyTorch port against the JAX package's:
the RLE mask codec bit for bit, and the mapping-file reader on a synthetic
mapping with a PIE-Bench item and a TI2I item."""
import json
import os

import numpy as np
import pytest

from pnpinversion_tpu.data import pie_bench as jpb
from pnpinversion_tpu_torch.data import pie_bench as tpb


def _random_rle(rng, shape):
    """Seeded runs over a flat mask: some touch the border rows/columns, and
    the last run is cut by the end of the image."""
    length = shape[0] * shape[1]
    starts = np.sort(rng.choice(length - 1, 12, replace=False))
    runs = rng.randint(1, 3 * shape[1], 12)
    rle = [int(x) for pair in zip(starts, runs) for x in pair]
    return rle + [0, shape[1] + 3, length - 5, 40]  # row 0 into row 1; past the end


@pytest.mark.parametrize("seed,shape", [(0, (512, 512)), (1, (512, 512)), (2, (32, 48))])
def test_mask_decode_bit_identical(seed, shape):
    rle = _random_rle(np.random.RandomState(seed), shape)
    want = jpb.mask_decode(rle, shape)
    got = tpb.mask_decode(rle, shape)
    assert got.dtype == want.dtype == np.float64 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    assert got[0].all() and got[-1].all() and got[:, 0].all() and got[:, -1].all()


@pytest.mark.parametrize("seed", [0, 3])
def test_mask_encode_round_trip(seed):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(64, 64) > 0.7).astype(np.uint8)
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = 1  # as decode forces them
    rle = tpb.mask_encode(mask)
    assert rle == jpb.mask_encode(mask)
    np.testing.assert_array_equal(tpb.mask_decode(rle, (64, 64)), mask)


def _mapping(tmp_path):
    mask = np.zeros((512, 512), np.uint8)
    mask[100:300, 50:200] = 1
    mapping = {
        "000000000001": {"image_path": "0_random_140/000000000001.jpg",
                         "original_prompt": "a [cat] on a mat",
                         "editing_prompt": "a [dog] on a mat",
                         "editing_instruction": "make the cat a dog",
                         "editing_type_id": "0", "blended_word": "cat dog",
                         "mask": tpb.mask_encode(mask)},
        "000000000002": {"image_path": "1_change_object_80/000000000002.jpg",
                         "original_prompt": "a house", "editing_prompt": "a castle",
                         "editing_instruction": "", "editing_type_id": "1",
                         "blended_word": "", "mask": tpb.mask_encode(mask)},
        # a TI2I item: no category, no mask, no source prompt, a list of prompts
        "ti2i_07": {"image_path": "ti2i/07.png",
                    "editing_prompt": ["a watercolour [fox]", "a bronze [fox]"]},
    }
    path = tmp_path / "mapping_file.json"
    path.write_text(json.dumps(mapping))
    return str(tmp_path), str(path)


@pytest.mark.parametrize("categories", [None, ["0"]])
def test_items_match_jax(tmp_path, categories):
    data_path, mapping_file = _mapping(tmp_path)
    want = list(jpb.PieBenchDataset(data_path, mapping_file).items(categories))
    got = list(tpb.PieBenchDataset(data_path, mapping_file).items(categories))
    assert len(got) == len(want) == (4 if categories is None else 3)
    images_root = os.path.join(data_path, "annotation_images")
    for g, w in zip(got, want):
        for field in ("key", "image_path", "original_prompt", "editing_prompt",
                      "editing_instruction", "editing_type_id", "blended_word",
                      "prompt_index", "source_prompt", "target_prompt"):
            assert getattr(g, field) == getattr(w, field), field
        np.testing.assert_array_equal(g.mask, w.mask)
        assert g.rel_output_path(images_root) == w.rel_output_path(images_root)
        out = tpb.PieBenchDataset.output_path("out", "p2p", g, g.rel_output_path(images_root))
        assert out == jpb.PieBenchDataset.output_path("out", "p2p", w,
                                                       w.rel_output_path(images_root))
    ti2i = [g for g in got if g.editing_type_id == "ti2i"]
    assert [g.key for g in ti2i] == ["ti2i_07_0", "ti2i_07_1"]
    assert ti2i[1].rel_output_path(images_root) == "ti2i/07_1.png"
    assert not ti2i[0].mask.any() and ti2i[0].source_prompt == ""


def test_should_skip(tmp_path):
    path = tmp_path / "strip.jpg"
    for rerun in (False, True):
        assert tpb.PieBenchDataset.should_skip(str(path), rerun) is False
    path.write_bytes(b"x")
    assert tpb.PieBenchDataset.should_skip(str(path), False) is True
    assert tpb.PieBenchDataset.should_skip(str(path), True) is False


def test_load_512_matches_jax():
    rng = np.random.RandomState(4)
    image = (rng.rand(300, 420, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tpb.load_512(image), jpb.load_512(image))
    np.testing.assert_array_equal(tpb.load_512(image, left=10, top=5, bottom=7),
                                  jpb.load_512(image, left=10, top=5, bottom=7))
