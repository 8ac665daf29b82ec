"""LocalBlend at a mask that cuts: the PyTorch port's batched
``P2PControl.step_callback`` on N = 2 images against the JAX package's
``step_callback`` under ``jax.vmap``, with no UNet. The attention maps and
the blend-word selectors are seeded and sparse, so each image's 0.3
threshold keeps the edit on part of the latent only, at SD1.4's sizes
(16^2 maps, 64^2 latents)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnpinversion_tpu.control.p2p import make_p2p_control as jax_make_p2p_control
from pnpinversion_tpu.utils.tokenizer import SimpleWordTokenizer as JaxTokenizer
from pnpinversion_tpu_torch.control.p2p import make_p2p_control, stack_tensors
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

N, HEADS = 2, 8
PROMPTS = ["a cat on a mat", "a silver cat on a mat"]
KW = dict(num_steps=10, blend_words=(("cat",), ("cat",)), num_lb_slots=5, lb_res=16,
          latent_size=64)


def _inputs(seed):
    """Per image: sparse maps (slots, B, H, 16^2, 77), a sparse selector
    (B, 77) and latents (B, 64, 64, 4)."""
    rng = np.random.RandomState(seed)
    shape = (N, KW["num_lb_slots"], len(PROMPTS), HEADS, 16 * 16, 77)
    maps = (rng.rand(*shape) * (rng.rand(*shape) > 0.97)).astype(np.float32)
    # a bump of attention per image, graded from its peak down to nothing, so
    # that the threshold (0.3 of the peak) draws the mask's edge through it
    yy, xx = np.mgrid[:16, :16]
    bump = np.stack([3.0 * np.exp(-((yy - r) ** 2 + (xx - c) ** 2) / (2 * w ** 2))
                     for r, c, w in zip(*rng.randint(4, 12, (2, N)), rng.uniform(2, 4, N))])
    maps[..., 2] += bump.reshape(N, 1, 1, 1, 256).astype(np.float32)
    sel = (rng.rand(N, len(PROMPTS), 77) > 0.9).astype(np.float32)
    sel[..., 2] = 1.0
    latents = rng.randn(N, len(PROMPTS), 64, 64, 4).astype(np.float32)
    return maps, sel, latents


@pytest.mark.parametrize("step", [1, 2, 5])
def test_step_callback_matches_jax_vmap(step):
    jctrl, jtensors = jax_make_p2p_control(PROMPTS, JaxTokenizer(), **KW)
    tctrl, ttensors = make_p2p_control(PROMPTS, default_tokenizer(), **KW)
    assert tctrl.spec.lb_start_blend == jctrl.spec.lb_start_blend == 2
    assert jctrl.spec.lb_th == (0.3, 0.3) and not jctrl.spec.lb_substruct
    maps, sel, latents = _inputs(step)

    def one_image(lat, alpha, lb):
        tensors = dict(jtensors, lb_alpha_layers=alpha)
        return jctrl.step_callback(lat, tensors, {"lb_maps": lb}, jnp.asarray(step))[0]

    want = np.asarray(jax.jit(jax.vmap(one_image))(jnp.asarray(latents), jnp.asarray(sel),
                                                   jnp.asarray(maps)))
    tensors = stack_tensors([dict(ttensors, lb_alpha_layers=torch.from_numpy(s)) for s in sel])
    lb = torch.from_numpy(maps).transpose(0, 1).reshape(
        KW["num_lb_slots"], N * len(PROMPTS), HEADS, 256, 77)  # image-major rows
    got, _ = tctrl.step_callback(torch.from_numpy(latents.reshape(-1, 64, 64, 4)), tensors,
                                 {"lb_maps": lb}, step)
    got = got.reshape(want.shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the source row is never blended; before the blend starts nothing is
    np.testing.assert_array_equal(got[:, 0], latents[:, 0])
    # the edit is kept where the mask is on: src + (edit - src) is the edit up
    # to an f32 rounding of the larger of the two
    kept = np.isclose(got[:, 1], latents[:, 1], rtol=0, atol=1e-5).all(-1)
    if step + 1 <= jctrl.spec.lb_start_blend:
        assert kept.all()
    else:
        for i in range(N):  # the threshold cuts: part kept, part set to the source
            assert 0.02 < kept[i].mean() < 0.9, kept[i].mean()
            np.testing.assert_array_equal(got[i, 1][~kept[i]], latents[i, 0][~kept[i]])
        assert not np.array_equal(kept[0], kept[1])  # each image has its own mask


def test_step_callback_images_do_not_mix():
    """Replacing image 1's maps and latents leaves image 0's blend as it was."""
    tctrl, ttensors = make_p2p_control(PROMPTS, default_tokenizer(), **KW)
    maps, sel, latents = _inputs(7)
    other_maps, _, other_latents = _inputs(8)

    def run(m, lat):
        tensors = stack_tensors([dict(ttensors, lb_alpha_layers=torch.from_numpy(s))
                                 for s in sel])
        lb = torch.from_numpy(m).transpose(0, 1).reshape(KW["num_lb_slots"], -1, HEADS, 256, 77)
        out, _ = tctrl.step_callback(torch.from_numpy(lat.reshape(-1, 64, 64, 4)), tensors,
                                     {"lb_maps": lb}, 5)
        return out.reshape(lat.shape)

    base = run(maps, latents)
    maps[1], latents[1] = other_maps[1], other_latents[1]
    assert tctrl.spec.local_blend
    assert torch.equal(run(maps, latents)[0], base[0])
