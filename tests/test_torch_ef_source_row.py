"""ROADMAP C9: edit-friendly DDPM's source row stays far from the image on
random weights (~34 uint8 levels at SD1.4, f32 as bf16). Is that the method
or the port? At TINY, f32 on the CPU, the JAX package's EF editor and the
port's edit the same image on the same weights and the same noise (one
numpy draw in both packages, as ``test_torch_ef.py`` shares it), at 10 DDIM
steps with skip 2 (the reference's 12 of 50, scaled): each strip's
reconstruction panel (the edit pass's source row) lies as far from the image
in both packages, and far (a TINY UNet's random eps re-injected through the
noise maps does not give the image back), so C9 is the method on random
weights, not a fault of the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_strips_match, jax_torch_pipelines, seeded_images
from pnpinversion_tpu.editors.ef_editor import EditFriendlyEditor as JaxEFEditor
from pnpinversion_tpu_torch.editors.ef_editor import METHOD, EditFriendlyEditor
from pnpinversion_tpu_torch.inversion import ef_ddpm as tef

torch.set_num_threads(2)

STEPS, SKIP, SIZE = 10, 2, 16
PROMPTS = ("a cat on a mat", "a dog on a mat")
NOISE = np.random.RandomState(901).randn(STEPS, 1, 8, 8, 4).astype(np.float32)
AGREE = 0.5  # uint8 levels of mean |source row - image| between the packages
FAR = 5.0  # uint8 levels: the source row is not the image


@pytest.fixture(scope="module")
def distances():
    draw = jax.random.normal

    def normal(key, shape, dtype=jnp.float32):
        if tuple(shape) != NOISE.shape:
            return draw(key, shape, dtype)
        return jnp.asarray(NOISE, dtype)

    def xts(generator, schedule, x0):
        return tef.xts_from_noise(schedule, x0, torch.from_numpy(NOISE).to(x0.dtype))

    jpipe, tpipe = jax_torch_pipelines(seed=902, steps=STEPS)
    img = seeded_images(903, 1)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        mp.setattr(tef, "sample_xts_from_x0", xts)
        want = np.asarray(JaxEFEditor(jpipe)(METHOD, img, *PROMPTS, skip=SKIP))
        got = EditFriendlyEditor(tpipe)(METHOD, img, *PROMPTS, skip=SKIP)

    def distance(strip):
        image, recon = (strip[:, k * SIZE:(k + 1) * SIZE].astype(float) for k in (1, 2))
        return float(np.abs(recon - image).mean())

    return got, want, distance(got), distance(want)


def test_strips_match(distances):
    got, want, _, _ = distances
    assert_strips_match(got, want)


def test_source_row_is_as_far_from_the_image_in_both_packages(distances):
    _, _, port, jax_ = distances
    assert abs(port - jax_) <= AGREE, (port, jax_)
    assert min(port, jax_) >= FAR, (port, jax_)
