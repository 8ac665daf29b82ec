"""What the FLOP-count tests (``test_torch_flops.py``,
``test_torch_flops_edit.py``) share: the JAX package's count
(``scripts/_flops.py``) of a traced program, and the amounts by which it
names its difference from the port's count (``pnpinversion_tpu_torch/utils/flops.py``)
of the same program:

- ``group_norm``: the JAX GroupNorm reduces through one-hot (C, G) membership
  products, two into the groups and two back to the channels, 8·B·C·G a norm
  (``pnpinversion_tpu/models/layers.py::group_norm``); the port reshapes. It
  is the whole of the 2.0e-5 between the two counts of one SD1.4 UNet call.
- ``self_replace``: the JAX P2P control computes the self-attention replace
  (the source row's scores and its probabilities applied to each edited row,
  at every self-attention site of at most 32²) on every step and selects it
  with ``where``; the port computes it only on the steps inside the window.
- ``time_embedding``, in JAX's programs over several images only: ``vmap``
  leaves work that does not depend on the image unbatched, so the JAX sweep
  computes the timestep MLP and each ResNet's time projection once a call
  for all its images; the port computes them for every row.
"""
from __future__ import annotations

import contextlib
import importlib.util
import os

import jax
import numpy as np
import torch

from pnpinversion_tpu_torch.utils import mfu

torch.set_num_threads(2)  # the TINY edits run for real; leave cores to the other test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4  # the raw counts' bound; the named differences are held exactly
PROMPTS = mfu.MAIN_PATH_PROMPTS
EDIT_KW = mfu.MAIN_PATH_KW


def _jax_flops_module():
    spec = importlib.util.spec_from_file_location("_flops", os.path.join(REPO, "scripts",
                                                                         "_flops.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JFLOPS = _jax_flops_module()


def jax_count(fn, *args) -> float:
    """The JAX package's count of fn(*args): its jaxpr walked by
    ``scripts/_flops.py::count_flops``, with no while loop left out."""
    total, whiles = JFLOPS.count_flops(jax.make_jaxpr(fn)(*args).jaxpr)
    assert not whiles
    return total


@contextlib.contextmanager
def group_norm_dots():
    """Tallies, over the port's GroupNorm calls in the block, the FLOPs of
    the JAX GroupNorm's four membership products: 8·B·C·G a call."""
    from pnpinversion_tpu_torch.models import layers

    tally = [0.0]
    plain = layers.group_norm

    def counted(x, weight, bias, groups, eps=1e-5):
        tally[0] += 8.0 * x.shape[0] * x.shape[1] * groups
        return plain(x, weight, bias, groups, eps)

    layers.group_norm = counted
    try:
        yield tally
    finally:
        layers.group_norm = plain


def self_replace_flops(cfg, images: int = 1, batch_size: int = 2) -> float:
    """The products of the P2P self-attention replace in one UNet call:
    at each self-attention site of at most 32², the source row's scores
    (2·H·S²·d) and its probabilities applied to the B - 1 edited rows
    (2·(B-1)·H·S²·d), for each image."""
    from pnpinversion_tpu_torch.control.p2p import SELF_EDIT_MAX_SEQ
    from pnpinversion_tpu_torch.models.unet import UNet

    with torch.device("meta"):
        sites = [site for pair in UNet(cfg).sites for site in pair]
    chs, res0 = cfg.block_out_channels, cfg.sample_size
    total = 0.0
    for site in sites:
        if site.is_cross or site.seq_len > SELF_EDIT_MAX_SEQ:
            continue
        level = min(int(np.log2(res0 // site.resolution)), len(chs) - 1)
        d = chs[level] // site.heads
        total += 2.0 * batch_size * site.heads * site.seq_len ** 2 * d
    return images * total


def time_embedding_flops(unet) -> float:
    """The per-row products of the timestep embedding: its MLP and every
    ResNet's time projection."""
    linears = [unet.time_embedding.linear_1, unet.time_embedding.linear_2]
    linears += [m.time_emb_proj for m in unet.modules() if hasattr(m, "time_emb_proj")]
    return sum(2.0 * m.in_features * m.out_features for m in linears)


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)
