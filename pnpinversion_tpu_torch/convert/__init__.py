"""Weights into the port's modules.

- ``from_jax``: the JAX package's parameter trees (numpy leaves) carried over
  by name (``from_jax_params`` and the ``*_state_dict`` renamers, the parity
  tests' and the JAX trainer's way in);
- ``safetensors_io``, ``state_dict``, ``ldm``, ``metric_models`` and
  ``checkpoint``: weight files on local disk, in the layout the JAX package's
  convert CLI reads (``checkpoint.load_pipeline_modules``,
  ``checkpoint.load_metric_modules``); ``python -m
  pnpinversion_tpu_torch.convert`` checks a directory of them.
"""
from pnpinversion_tpu_torch.convert.from_jax import (  # noqa: F401
    _load,
    blip_decoder_state_dict,
    clip_modules_from_jax_params,
    clip_text_state_dict,
    from_jax_params,
    lpips_state_dict,
    metric_modules_from_jax_params,
    stylediffusion_mapper_from_jax,
    train_state_from_jax,
    unet_state_dict,
    vae_state_dict,
    vit_state_dict,
)
