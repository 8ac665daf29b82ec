"""The frozen count of each cell's work: model FLOPs per image and the
attention work the long self-attention path takes, counted once by running
the reference networks on ``meta`` tensors under PyTorch's
``FlopCounterMode`` (every product and convolution from its shapes; softmax,
norms and the samplers' elementwise work not counted), in the call structure
of the cell's method. The counts are written into ``work/<cell>.json``; the
benchmark divides by them and never counts the program's own work at run
time. ``python -m perfbench.flops <cell>`` prints a cell's work;
``perfbench/tests/test_perfbench_work.py`` holds the files to it.

The structure counted, per chunk of N images, is the method's own
(``work`` in ``reference/methods/<family>.py``).

The flash list holds (B·H, Sq, Sk, d, launches per chunk) of every
self-attention of at least 1024 positions (``ops/attention.py::use_flash``:
Sq ≥ 1024, both lengths multiples of 128).
"""
from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import diffusion as D
from perfbench.reference import models as R


def count(fn) -> float:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return float(mode.get_total_flops())


class SelfReplace:
    """P2P's self-attention replace on every image's target row, on meta."""

    def __init__(self, rows: int):
        self.rows = rows

    def attend(self, site, q, k, v, scale):
        if site.cross or site.resolution ** 2 > D.SELF_EDIT_MAX_SEQ:
            return None
        out = R.plain_attention(q, k, v, scale)
        qi, ki, vi = (t.view((-1, self.rows) + t.shape[1:]) for t in (q, k, v))
        R.matmul(R.attention_probs(qi[:, 1], ki[:, 1], scale), vi[:, 2])
        return out


def flash(unet: R.UNet, rows: int, calls: int) -> list:
    """(B·H, Sq, Sk, d, calls) of each long self-attention of a call of ``rows``."""
    out = []
    for tr in [a for b in list(unet.down_blocks) + [unet.mid_block] + list(unet.up_blocks)
               for a in b.attentions]:
        site = tr.sites[0]
        seq = site.resolution ** 2
        if seq >= 1024 and seq % 128 == 0:
            out.append((rows * site.heads, seq, seq, tr.proj_in.weight.shape[0] // site.heads,
                        calls))
    return out


class Meta:
    """Inputs of a configuration's shapes on ``meta``: token ids, images,
    latents and text contexts of ``k`` rows."""

    def __init__(self, config: dict):
        self.latent, self.size = config["unet"]["sample_size"], config["vae"]["sample_size"]
        self.ctx_dim = config["unet"]["cross_attention_dim"]

    def ids(self, k):
        return torch.zeros((k, 77), dtype=torch.long, device="meta")

    def img(self, k):
        return torch.zeros((k, self.size, self.size, 3), dtype=torch.uint8, device="meta")

    def lat(self, k):
        return torch.zeros((k, 4, self.latent, self.latent), device="meta")

    def ctx(self, k):
        return torch.zeros((k, 77, self.ctx_dim), device="meta")


def work(config: dict, mix: dict) -> dict:
    """{"flops_per_image", "flash"} of one chunk of the mix's batch."""
    from perfbench import harness

    n = mix["batch_per_device"]
    total, flash_list = harness.method(mix).work(R.build(config, "meta"), mix, Meta(config))
    merged = {}
    for bh, sq, sk, d, k in flash_list:
        merged[(bh, sq, sk, d)] = merged.get((bh, sq, sk, d), 0) + k
    return {"flops_per_image": total / n,
            "flash": [list(k) + [v] for k, v in sorted(merged.items())],
            "chunk_images": n}


def cell_work(cell: str) -> dict:
    from perfbench.harness import load_cell

    c = load_cell(cell)
    return work(c["config"], c["mix"])


if __name__ == "__main__":
    for name in sys.argv[1:]:
        print(json.dumps({name: cell_work(name)}))
