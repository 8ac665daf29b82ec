"""Why the PnP sweep's edit of an image moves with the other images of its
batch on seeded weights (ROADMAP C17): not through the batched class, whose
images meet nowhere (an image's panels are the same bits alone, beside one
image and beside another), but through the word tokenizer that a pipeline
without a checkpoint threads: it numbers words in the order its process
first meets them, and the sweep embeds PnP's negative prompt after the
chunk's prompts, so a second item's new words shift the negative prompt's
ids. With the negative prompt's words numbered first, ``run_sweep`` gives
the first item the same strip at batch 1 and 2 (within the CPU's f32
rounding at another batch, 1 level); a CLIP BPE tokenizer (a checkpoint's)
numbers words by its vocabulary alone. TINY, f32, CPU."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_mp_worker import tiny_create
from _torch_parity import pipeline_params, tiny_configs, torch_pipeline
from pnpinversion_tpu_torch.data import seeded
from pnpinversion_tpu_torch.editors.pnp_editor import NEGATIVE_PROMPT
from pnpinversion_tpu_torch.parallel.sweep import BatchedPnP
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.utils.tokenizer import CLIPBPETokenizer, default_tokenizer

torch.set_num_threads(2)
METHOD = "directinversion+pnp"
PROMPTS = (("a cat sitting on a mat", "a dog sitting on a mat", "make it a dog", "cat dog"),
           ("a red car by the sea", "a blue boat by the sea", "make it a boat", "car boat"))


def test_batched_pnp_images_meet_nowhere():
    jcfg, tcfg = tiny_configs()
    pipe = torch_pipeline(pipeline_params(jcfg, seed=3), 2, tcfg)
    imgs = (np.random.RandomState(0).rand(3, 16, 16, 3) * 255).astype(np.uint8)
    src = pipe.encode_prompt(["a cat", "a dog", "a cow"])[:, None]
    tar = pipe.encode_prompt(["a tiger", "a wolf", "a bull"])[:, None]
    sweep = BatchedPnP(pipe)
    runs = [sweep.edit_batch(METHOD, imgs[sel], src[sel], tar[sel], 7.5)
            for sel in ([0], [0, 1], [0, 2])]
    for recon, edit in runs[1:]:
        assert np.array_equal(recon[0], runs[0][0][0]) and np.array_equal(edit[0], runs[0][1][0])


def test_word_ids_follow_first_sight_and_bpe_ids_do_not(tmp_path):
    def negative_ids(tokenizer, items):
        for src, tar, _, _ in items:
            tokenizer.encode(src), tokenizer.encode(tar)
        return tokenizer.encode(NEGATIVE_PROMPT)

    assert negative_ids(default_tokenizer(), PROMPTS[:1]) != negative_ids(default_tokenizer(),
                                                                          PROMPTS)
    vocab = seeded.bpe_vocab(str(tmp_path / "tokenizer"),
                             [t for p in PROMPTS for t in p[:2]] + [NEGATIVE_PROMPT])
    assert negative_ids(CLIPBPETokenizer(vocab), PROMPTS[:1]) == negative_ids(
        CLIPBPETokenizer(vocab), PROMPTS)


@pytest.mark.parametrize("numbered_first", [False, True])
def test_sweep_edit_moves_with_the_batch_only_through_word_ids(tmp_path, monkeypatch,
                                                              numbered_first):
    from pnpinversion_tpu_torch.runners import run_sweep

    def create(cls, *args, **kwargs):
        pipe = tiny_create(cls, *args, **kwargs)
        if numbered_first:
            pipe.tokenizer.encode(NEGATIVE_PROMPT)
        return pipe

    monkeypatch.setattr(SDPipeline, "create", classmethod(create))
    strips = []
    for batch in (1, 2):
        root = tmp_path / f"x{batch}"
        data = seeded.mini_pie_bench(str(root), batch, size=24, prompts=PROMPTS, ext="png")
        out = root / "out"
        assert run_sweep.main(["--method", METHOD, "--data_path", data, "--output_path", str(out),
                               "--num_ddim_steps", "2", "--batch_per_device", str(batch),
                               "--device", "cpu"]) == {"images": batch, "batch": batch}
        with open(os.path.join(data, "mapping_file.json")) as f:
            rel = json.load(f)["000000"]["image_path"]
        strips.append(np.asarray(Image.open(out / METHOD / "annotation_images" / rel)))
    # TINY's 16^2 panels: the largest uint8 difference of the reconstruction
    # and of the edit; 1 level is the CPU's f32 rounding at another batch
    diff = [int(np.abs(strips[0][:, p * 16:(p + 1) * 16].astype(int)
                       - strips[1][:, p * 16:(p + 1) * 16]).max()) for p in (2, 3)]
    assert diff[0] <= 1 and (diff[1] <= 1) == numbered_first, diff
