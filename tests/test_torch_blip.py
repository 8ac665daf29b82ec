"""The BLIP captioner in the PyTorch port vs the JAX package, on the CPU in
f32: the WordPiece tokenizer on a hand-written vocab, the decoder's logits
(within 1e-5 of max), greedy and beam-search ids at ``TINY_BLIP_TEXT`` with
a tiny ViT (equal, id for id) and ``caption_batch``'s captions (equal). The
weights go to both sides from one numpy tree."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import numpy_params, rel_err, seeded_images
from pnpinversion_tpu.models import blip as jblip
from pnpinversion_tpu.models import vit as jvit
from pnpinversion_tpu.utils.tokenizer import BertWordPieceTokenizer as JaxWordPiece
from pnpinversion_tpu_torch.convert import from_jax_params
from pnpinversion_tpu_torch.models import blip as tblip
from pnpinversion_tpu_torch.models.vit import ViTConfig
from pnpinversion_tpu_torch.utils.tokenizer import BertWordPieceTokenizer

torch.set_num_threads(2)

RTOL = 1e-5  # the decoder's logits: forward only, f32 on both sides
# 64 entries, TINY_BLIP_TEXT's vocabulary: [CLS] = 1 (its start id), [SEP] = 2
VOCAB = (["[PAD]", "[CLS]", "[SEP]", "[UNK]", "a", "picture", "of", "cat", "dog", "on", "mat",
          "##s", "##ing", "sit", "the", "red", "blue", ",", ".", "un", "##known", "##ly"]
         + [f"w{i}" for i in range(42)])
TINY_VIT = dict(image_size=16, patch_size=8, width=32, layers=1, heads=2, style="dino",
                activation="gelu")


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("blip") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    assert len(VOCAB) == jblip.TINY_BLIP_TEXT.vocab_size
    return str(path)


@pytest.fixture(scope="module")
def models():
    """(JAX decoder tree, JAX ViT tree, port decoder, port ViT)."""
    dparams = numpy_params(jblip.init_blip_decoder_params, jblip.TINY_BLIP_TEXT, 501)
    vcfg = jvit.ViTConfig(**TINY_VIT)
    vparams = numpy_params(jvit.init_vit_params, vcfg, 502)
    return (jax.tree.map(jnp.asarray, dparams), jax.tree.map(jnp.asarray, vparams),
            from_jax_params(dparams, tblip.TINY_BLIP_TEXT).eval(),
            from_jax_params(vparams, ViTConfig(**TINY_VIT)).eval())


def test_text_configs_match_jax():
    import dataclasses

    for name in ("TINY_BLIP_TEXT",):
        assert dataclasses.asdict(getattr(tblip, name)) == dataclasses.asdict(getattr(jblip, name))
    assert dataclasses.asdict(tblip.BlipTextConfig()) == dataclasses.asdict(jblip.BlipTextConfig())
    assert (dataclasses.asdict(tblip.BLIP_VIT_B16_384)
            == dataclasses.asdict(jblip.BLIP_VIT_B16_384))


@pytest.mark.parametrize("text", ["a cats on a mat", "The red dog, sitting.", "zzz unknownly",
                                  "  A   Picture of  blue mats  ", ""])
def test_wordpiece_matches_jax(vocab_file, text):
    """encode (subwords, punctuation, an unknown word), decode, and the
    padded call, as the JAX tokenizer gives them."""
    ours, ref = BertWordPieceTokenizer(vocab_file), JaxWordPiece(vocab_file)
    assert ours.encode(text) == ref.encode(text)
    assert ours.decode(ours.encode(text)) == ref.decode(ref.encode(text))
    assert ours([text], max_length=6) == ref([text], max_length=6)
    assert (ours.cls_token_id, ours.sep_token_id, ours.unk_token_id, ours.pad_token_id) == (
        1, 2, 3, 0)


def test_decoder_logits_match_jax(models):
    jd, _, td, _ = models
    rng = np.random.RandomState(503)
    ids = rng.randint(0, 64, (3, 8))
    img = rng.randn(3, 5, 32).astype(np.float32)
    want = jax.jit(lambda p, i, x: jblip.blip_decoder_logits(p, i, x, jblip.TINY_BLIP_TEXT))(
        jd, jnp.asarray(ids), jnp.asarray(img))
    with torch.no_grad():
        got = td(torch.as_tensor(ids), torch.from_numpy(img))
    assert got.shape == (3, 8, 64) and got.dtype == torch.float32
    assert rel_err(got, want) <= RTOL


def _tokens(seed: int, n: int = 1) -> np.ndarray:
    return (np.random.RandomState(seed).randn(n, 5, 32) * 2.0).astype(np.float32)


@pytest.mark.parametrize("seed", [504, 505, 506, 507])
def test_greedy_ids_match_jax(models, seed):
    jd, _, td, _ = models
    img = _tokens(seed)
    want = jax.jit(lambda p, x: jblip.greedy_caption_ids(p, x, jblip.TINY_BLIP_TEXT, [4]))(
        jd, jnp.asarray(img))
    got = tblip.greedy_caption_ids(td, torch.from_numpy(img), [4])
    np.testing.assert_array_equal(got[0], np.asarray(want))


@functools.lru_cache(maxsize=None)
def _eos_biased(bias: float):
    """(JAX tree, port decoder) with ``bias`` added to [SEP]'s logit bias, so
    that hypotheses finish before max_len."""
    params = jax.tree.map(np.array, numpy_params(jblip.init_blip_decoder_params,
                                                 jblip.TINY_BLIP_TEXT, 501))
    params["cls_decoder"]["bias"][jblip.TINY_BLIP_TEXT.sep_token_id] += bias
    return (jax.tree.map(jnp.asarray, params),
            from_jax_params(params, tblip.TINY_BLIP_TEXT).eval())


@pytest.mark.parametrize("seed,min_length,eos_bias", [
    (508, 2, 0.0), (509, 2, 0.0), (511, 10, 0.0), (508, 4, 1.0), (509, 4, 1.0), (510, 4, 1.0),
    (511, 4, 1.0), (508, 5, 1.5), (510, 4, 1.5), (509, 3, 0.5)])
def test_beam_ids_match_jax(seed, min_length, eos_bias):
    """Beam search (3 beams) id for id: hypotheses finishing at several
    lengths ([SEP]'s bias raised) fill the finished pool; min_length 10
    (past max_len 8) leaves the result to the unfinished beams."""
    jd, td = _eos_biased(eos_bias)
    img = _tokens(seed)
    want = jax.jit(lambda p, x: jblip.beam_caption_ids(
        p, x, jblip.TINY_BLIP_TEXT, [4], num_beams=3, min_length=min_length))(
        jd, jnp.asarray(img))
    got = tblip.beam_caption_ids(td, torch.from_numpy(img), [4], num_beams=3,
                                 min_length=min_length)
    np.testing.assert_array_equal(got[0], np.asarray(want))


def test_beam_ids_batch_is_per_image(models):
    """Four images decoded together give each image's own ids."""
    _, _, td, _ = models
    imgs = np.concatenate([_tokens(s) for s in (508, 509, 510, 513)])
    together = tblip.beam_caption_ids(td, torch.from_numpy(imgs), [4], min_length=2)
    for i in range(4):
        alone = tblip.beam_caption_ids(td, torch.from_numpy(imgs[i : i + 1]), [4], min_length=2)
        np.testing.assert_array_equal(together[i], alone[0])


@pytest.mark.parametrize("num_beams", [1, 3])
def test_caption_batch_matches_jax(models, vocab_file, num_beams):
    """``BlipCaptioner.caption_batch`` on 3 images (the tiny ViT at 16^2,
    ImageNet normalisation, the prompt "a picture of"): the same captions."""
    jd, jv, td, tv = models
    jcap = jblip.BlipCaptioner(jv, jd, JaxWordPiece(vocab_file), jvit.ViTConfig(**TINY_VIT),
                               jblip.TINY_BLIP_TEXT, prompt="a picture of ",
                               num_beams=num_beams, min_length=3)
    tcap = tblip.BlipCaptioner(tv, td, BertWordPieceTokenizer(vocab_file),
                               prompt="a picture of ", num_beams=num_beams, min_length=3)
    assert tcap.prompt_ids() == [4, 5, 6]
    imgs = seeded_images(514, 3, size=24)
    want = jcap.caption_batch(imgs)
    got = tcap.caption_batch(imgs)
    assert got == want and all(isinstance(c, str) for c in got)
    assert tcap(imgs[1]) == want[1]


def test_random_init_runs_on_the_cpu(vocab_file):
    cap = tblip.BlipCaptioner.random_init(0, BertWordPieceTokenizer(vocab_file),
                                          ViTConfig(**TINY_VIT), tblip.TINY_BLIP_TEXT,
                                          device="cpu")
    caps = cap.caption_batch(seeded_images(515, 2))
    assert len(caps) == 2 and all(isinstance(c, str) for c in caps)
