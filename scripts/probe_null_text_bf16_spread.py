#!/usr/bin/env python
"""Batched null-text in bf16: how far each image's embeddings move between
its batched and its single-image run, in the PyTorch port and in the JAX
package (``jax.vmap`` of its null-text), at TINY on the CPU.

Both packages get the same numpy weights (cast to bf16), the same DDIM
trajectories (the port's f32 inversion of seeded latents, cast to bf16) and
the same embeddings. The script prints one JSON object: per image, max |a -
b| / max |b| of the per-step uncond embeddings for

- ``port_batched_vs_single`` and ``jax_vmap_vs_single``: the spread of each
  implementation between a batch of N and the image alone;
- ``port_vs_jax_batched`` and ``port_vs_jax_single``: the two
  implementations against each other;
- the same four in f32, where the spread should be rounding only.

    JAX_PLATFORMS=cpu python scripts/probe_null_text_bf16_spread.py [--steps 3]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import pipeline_params  # noqa: E402
from pnpinversion_tpu.configs import TINY as JTINY  # noqa: E402
from pnpinversion_tpu.inversion.ddim_inversion import (  # noqa: E402
    null_text_optimization as jax_null_text,
)
from pnpinversion_tpu.schedulers.ddim import make_ddim_schedule as jax_schedule  # noqa: E402
from pnpinversion_tpu_torch.configs import TINY  # noqa: E402
from pnpinversion_tpu_torch.convert import from_jax_params  # noqa: E402
from pnpinversion_tpu_torch.inversion.ddim_inversion import (  # noqa: E402
    ddim_invert_loop,
    null_text_optimization,
)
from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule  # noqa: E402

G = 7.5


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--inner", type=int, default=10)
    parser.add_argument("--images", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    torch.set_num_threads(4)
    n, steps = args.images, args.steps
    params = pipeline_params(JTINY, seed=args.seed)["unet"]
    rng = np.random.RandomState(args.seed + 1)
    latents = rng.randn(n, 1, 8, 8, 4).astype(np.float32)
    cond = (rng.randn(n, 1, 77, 32) * 0.5).astype(np.float32)
    uncond = (rng.randn(n, 1, 77, 32) * 0.5).astype(np.float32)
    unet32 = from_jax_params(params, TINY.unet)
    with torch.no_grad():
        traj = ddim_invert_loop(unet32, make_ddim_schedule(steps), torch.from_numpy(latents),
                                torch.from_numpy(cond)).numpy()
    out = {"images": n, "steps": steps, "inner": args.inner, "tiny": True}
    for name, tdtype, jdtype in (("bf16", torch.bfloat16, jnp.bfloat16),
                                 ("f32", torch.float32, jnp.float32)):
        t0 = time.perf_counter()
        unet = from_jax_params(params, TINY.unet).to(tdtype)
        unet.requires_grad_(False)
        sched = make_ddim_schedule(steps)

        def port(sl):
            x = (torch.from_numpy(a[sl]).to(tdtype) for a in (traj, uncond, cond))
            tr, un, co = x
            return null_text_optimization(unet, sched, tr, un, co, G,
                                          num_inner_steps=args.inner).float().numpy()

        jparams = jax.tree.map(lambda x: jnp.asarray(x, jdtype), params)
        jsched = jax_schedule(steps)

        def one(tr, un, co):
            return jax_null_text(jparams, jsched, tr, un, co, G, JTINY.unet,
                                 num_inner_steps=args.inner)

        jargs = [jnp.asarray(a, jdtype) for a in (traj, uncond, cond)]
        jax_batched = np.asarray(jax.jit(jax.vmap(one))(*jargs).astype(jnp.float32))
        single = jax.jit(one)
        jax_single = [np.asarray(single(*(a[i] for a in jargs)).astype(jnp.float32))
                      for i in range(n)]
        port_batched = port(slice(None))
        port_single = [port(slice(i, i + 1))[0] for i in range(n)]
        out[name] = {
            "port_batched_vs_single": [rel(port_batched[i], port_single[i]) for i in range(n)],
            "jax_vmap_vs_single": [rel(jax_batched[i], jax_single[i]) for i in range(n)],
            "port_vs_jax_batched": [rel(port_batched[i], jax_batched[i]) for i in range(n)],
            "port_vs_jax_single": [rel(port_single[i], jax_single[i]) for i in range(n)],
            "seconds": time.perf_counter() - t0,
        }
        print(name, json.dumps(out[name]), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
