"""Shared set-up of the parity tests between the PyTorch port
(``pnpinversion_tpu_torch``) and the JAX package.

Both sides get the same inputs and the same weights, made from a numpy seed:
``numpy_params`` fills the tree of a JAX ``init_*_params`` function (its
structure from ``jax.eval_shape``, so no init program is compiled) with
random values, and the port loads that tree with ``from_jax_params``.
Torch runs on the CPU in f32 with two threads, so these tests do not starve
the other test workers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)


def numpy_params(init_fn, config, seed: int):
    """Random f32 numpy leaves in ``init_fn(key, config)``'s tree: kernels
    uniform(+-1/sqrt(fan_in)), embeddings N(0, 0.02), biases and norm
    shifts uniform(+-0.1), norm scales uniform(0.9, 1.1) -- non-trivial
    everywhere, so a transposed or misnamed weight shows."""
    shapes = jax.eval_shape(lambda k: init_fn(k, config), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(s.shape)
        if name == "scale":
            v = rng.uniform(0.9, 1.1, shape)
        elif name == "bias":
            v = rng.uniform(-0.1, 0.1, shape)
        elif name.endswith("embedding"):
            v = rng.normal(0.0, 0.02, shape)
        else:
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[:-1]))
            v = rng.uniform(-1.0, 1.0, shape) / np.sqrt(fan_in)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pipeline_params(config, seed: int = 0):
    """{'unet', 'vae', 'text'} numpy trees for a StableDiffusionConfig."""
    from pnpinversion_tpu.models.clip_text import init_clip_text_params
    from pnpinversion_tpu.models.unet import init_unet_params
    from pnpinversion_tpu.models.vae import init_vae_params

    return {"unet": numpy_params(init_unet_params, config.unet, seed),
            "vae": numpy_params(init_vae_params, config.vae, seed + 1),
            "text": numpy_params(init_clip_text_params, config.text, seed + 2)}


def jax_pipeline(params, steps: int):
    """The JAX package's SDPipeline at TINY with these weights (built
    directly: its ``create`` would compile a random init we do not use)."""
    from pnpinversion_tpu.configs import TINY
    from pnpinversion_tpu.pipeline import SDPipeline
    from pnpinversion_tpu.schedulers.ddim import make_ddim_schedule
    from pnpinversion_tpu.utils.tokenizer import default_tokenizer

    return SDPipeline(config=TINY, params=jax.tree.map(jnp.asarray, params),
                      tokenizer=default_tokenizer(), schedule=make_ddim_schedule(steps),
                      dtype=jnp.float32)


def torch_pipeline(params, steps: int):
    from pnpinversion_tpu_torch.configs import TINY
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    return SDPipeline.create(TINY, num_ddim_steps=steps, device="cpu", jax_params=params)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())
