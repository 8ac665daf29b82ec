"""Host-side helpers of the PyTorch port (own copies of the JAX package's
configs, tokenizer, P2P text helpers and image helpers) give identical
results."""
import dataclasses

import numpy as np
import pytest

from pnpinversion_tpu import configs as jconfigs
from pnpinversion_tpu.data.pie_bench import load_image as jax_load_image
from pnpinversion_tpu.utils import image as jimage
from pnpinversion_tpu.utils import text as jtext
from pnpinversion_tpu.utils.tokenizer import SimpleWordTokenizer as JaxTokenizer
from pnpinversion_tpu_torch import configs as tconfigs
from pnpinversion_tpu_torch.utils import image as timage
from pnpinversion_tpu_torch.utils import text as ttext
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

PROMPTS = ["a round cake with orange frosting on a wooden plate",
           "a square cake with orange frosting on a wooden plate",
           "a cat sitting next to a mirror", "a silver cat sculpture sitting next to a mirror"]


@pytest.mark.parametrize("name", ["SD14", "TINY"])
def test_configs_equal(name):
    assert dataclasses.asdict(getattr(tconfigs, name)) == dataclasses.asdict(
        getattr(jconfigs, name))


def test_tokenizer_ids_follow_call_order():
    jt, tt = JaxTokenizer(), default_tokenizer()
    for batch in (PROMPTS[:2], [""], PROMPTS[2:], PROMPTS[::-1]):
        assert tt(batch, max_length=77)["input_ids"] == jt(batch, max_length=77)["input_ids"]
    assert tt.decode(tt.encode(PROMPTS[3])) == jt.decode(jt.encode(PROMPTS[3]))


@pytest.mark.parametrize("pair", [(0, 1), (2, 3)])
def test_p2p_text_helpers(pair):
    prompts = [PROMPTS[i] for i in pair]
    jt, tt = JaxTokenizer(), default_tokenizer()
    for fn, args in ((jtext.get_time_words_attention_alpha, (prompts, 4, 0.4)),
                     (jtext.get_refinement_mapper, (prompts,)),
                     (jtext.get_equalizer, (prompts[1], ("square", "silver"), (2.0, 3.0)))):
        want = fn(*args, jt)
        got = getattr(ttext, fn.__name__)(*args, tt)
        for w, g in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            np.testing.assert_array_equal(g, w)
    same_len = [PROMPTS[0], PROMPTS[1]]
    np.testing.assert_array_equal(ttext.get_replacement_mapper(same_len, tt),
                                  jtext.get_replacement_mapper(same_len, jt))
    np.testing.assert_array_equal(ttext.get_word_inds(prompts[1], "cat", tt),
                                  jtext.get_word_inds(prompts[1], "cat", jt))


def test_image_helpers():
    rng = np.random.RandomState(0)
    img = (rng.rand(40, 56, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(timage.load_image(img, 32), jax_load_image(img, 32))
    text = "source prompt: a cat\ntarget prompt: a silver cat"
    np.testing.assert_array_equal(timage.txt_draw(text, (32, 32)), jimage.txt_draw(text, (32, 32)))
    panels = [img[:, :40]] * 4
    np.testing.assert_array_equal(timage.make_strip(panels),
                                  np.asarray(jimage.make_strip(panels)))
