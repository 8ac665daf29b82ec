"""The traffic generator is deterministic by seed, and every seed gives the
same sizes."""
import json
import os
import sys

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402
from perfbench.reference import check  # noqa: E402
from perfbench.traffic import generator  # noqa: E402

MIX = harness.load_cell("sd14.di-p2p.sweep-b4")["mix"]


def _read(data):
    mapping = json.load(open(os.path.join(data, "mapping_file.json")))
    images = [np.array(Image.open(os.path.join(data, "annotation_images", v["image_path"])))
              for v in mapping.values()]
    return mapping, images


def test_same_seed_same_inputs(tmp_path):
    a = _read(generator.generate(str(tmp_path / "a"), 3, 2**31 + 11, 1, MIX))
    b = _read(generator.generate(str(tmp_path / "b"), 3, 2**31 + 11, 1, MIX))
    assert a[0] == b[0]
    assert all((x == y).all() for x, y in zip(a[1], b[1]))


def test_seeds_differ_in_content_not_in_size(tmp_path):
    a = _read(generator.generate(str(tmp_path / "a"), 4, 5, 1, MIX))
    b = _read(generator.generate(str(tmp_path / "b"), 4, 6, 1, MIX))
    assert [x.shape for x in a[1]] == [x.shape for x in b[1]] == [(512, 512, 3)] * 4
    assert any((x != y).any() for x, y in zip(a[1], b[1]))
    for mapping in (a[0], b[0]):
        for item in mapping.values():
            share = check.rle_mask(item["mask"]).mean()
            assert 0.08 <= share <= 0.65
            src = item["original_prompt"].replace("[", "").replace("]", "").split()
            tgt = item["editing_prompt"].replace("[", "").replace("]", "").split()
            blend = item["blended_word"].split()
            assert blend[0] in src and blend[1] in tgt


def test_vocabulary_spells_the_pool(tmp_path):
    from perfbench.reference.text import Tokenizer

    tok = Tokenizer(generator.vocabulary(str(tmp_path), MIX))
    for pair in generator.prompt_pool():
        for p in pair[:2]:
            text = p.replace("[", "").replace("]", "")
            assert tok.decode(tok.encode(text)[1:-1]) == text
