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

import os

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


def tiny_configs(in_channels: int = 4):
    """(JAX config, port config): TINY, with an ``in_channels``-channel UNet
    input (8 for the instruction editors' UNet)."""
    import dataclasses

    from pnpinversion_tpu.configs import TINY as JTINY
    from pnpinversion_tpu_torch.configs import TINY

    return tuple(dataclasses.replace(c, unet=dataclasses.replace(c.unet, in_channels=in_channels))
                 for c in (JTINY, TINY))


def jax_pipeline(params, steps: int, config=None, dtype=jnp.float32):
    """The JAX package's SDPipeline (TINY unless ``config`` is given) with
    these weights, cast to ``dtype`` (built directly: its ``create`` would
    compile a random init we do not use)."""
    from pnpinversion_tpu.configs import TINY
    from pnpinversion_tpu.pipeline import SDPipeline
    from pnpinversion_tpu.schedulers.ddim import make_ddim_schedule
    from pnpinversion_tpu.utils.tokenizer import default_tokenizer

    return SDPipeline(config=config or TINY,
                      params=jax.tree.map(lambda x: jnp.asarray(x, dtype), params),
                      tokenizer=default_tokenizer(), schedule=make_ddim_schedule(steps),
                      dtype=dtype)


def torch_pipeline(params, steps: int, config=None, dtype=torch.float32):
    from pnpinversion_tpu_torch.configs import TINY
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    return SDPipeline.create(config or TINY, num_ddim_steps=steps, device="cpu", dtype=dtype,
                             jax_params=params)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_strips_match(got: np.ndarray, want: np.ndarray, size: int = 16,
                        flipped: float = 1e-3) -> None:
    """Two editors' 4-panel strips: the instruction and ground-truth panels
    are exact; the decoded panels are truncated to uint8, which flips a value
    wherever the f32 noise of the loops and a decode straddles an integer, so
    they may differ by 1 on at most ``flipped`` of their values (1e-3 for
    loops whose f32 noise is ~1e-6 of max)."""
    assert got.shape == want.shape == (size, 4 * size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[:, : 2 * size], want[:, : 2 * size])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= flipped


def jax_torch_pipelines(seed: int, steps: int, in_channels: int = 4, bf16: bool = False):
    """(JAX pipeline, port pipeline) at TINY (``tiny_configs(in_channels)``)
    with the same numpy weights and word tokenizers, in f32, or in bf16 (the
    same bf16-rounded weights on both sides)."""
    from pnpinversion_tpu.utils.tokenizer import SimpleWordTokenizer
    from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

    jcfg, tcfg = tiny_configs(in_channels)
    params = pipeline_params(jcfg, seed=seed)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jpipe = jax_pipeline(params, steps, jcfg, jdt)
    tpipe = torch_pipeline(params, steps, tcfg, tdt)
    jpipe.tokenizer, tpipe.tokenizer = SimpleWordTokenizer(), default_tokenizer()
    return jpipe, tpipe


def jax_torch_editors(seed: int, steps: int):
    """(JAX P2P editor, port P2P editor) on ``jax_torch_pipelines``."""
    from pnpinversion_tpu.editors.p2p_editor import P2PEditor as JaxP2PEditor
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor

    jpipe, tpipe = jax_torch_pipelines(seed, steps)
    return JaxP2PEditor(jpipe), P2PEditor(tpipe)


def seeded_images(seed: int, n: int, size: int = 16) -> np.ndarray:
    """n random uint8 (size, size, 3) images from a numpy seed."""
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 255).astype(np.uint8)


def assert_panels_close(got: np.ndarray, want: np.ndarray, max_levels: int = 2) -> None:
    """Panels of one image from the batched class and from the single-image
    editor: f32 summation-order noise of another batch size, within the JAX
    package's limit for its own batched path (tests/test_sharded_runner.py)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= max_levels


def make_pair_dataset(root: str, n_items: int = 6, res: int = 20, seeds_per_item: int = 2) -> str:
    """An ip2p seeds.json dataset of random JPEG pairs under ``root``."""
    import json
    import os

    from PIL import Image

    rng = np.random.default_rng(0)
    seeds = []
    for i in range(n_items):
        name = f"{i:07d}"
        d = os.path.join(root, name)
        os.makedirs(d)
        with open(os.path.join(d, "prompt.json"), "w") as f:
            json.dump({"input": f"a cat {i}", "edit": f"make it {i}", "output": f"a dog {i}"}, f)
        for s in range(seeds_per_item):
            for suffix in ("0", "1"):
                arr = rng.integers(0, 255, (res, res, 3), dtype=np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"{s}_{suffix}.jpg"))
        seeds.append([name, list(range(seeds_per_item))])
    with open(os.path.join(root, "seeds.json"), "w") as f:
        json.dump(seeds, f)
    return root


WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_mp_worker.py")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(scenario: str, cfg: dict, out_dir: str, n: int = 2, timeout: float = 150.0,
              beside=None) -> list:
    """Runs ``tests/_torch_mp_worker.py SCENARIO`` as n gloo ranks on the
    loopback (a free port for rank 0) with ``cfg`` (plus ``out``: out_dir)
    and returns each rank's JSON result; ``beside()``, where given, runs in
    this process while the ranks run. A rank that fails or outlasts
    ``timeout`` seconds fails the test, and every rank is ended."""
    import json
    import subprocess
    import sys

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{scenario}.json")
    with open(path, "w") as f:
        json.dump({**cfg, "out": out_dir}, f)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    address = f"127.0.0.1:{free_port()}"
    logs = [open(os.path.join(out_dir, f"{scenario}_rank{r}.log"), "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, WORKER, scenario, path, "--num_processes", str(n),
                               "--process_id", str(r), "--coordinator_address", address],
                              env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        if beside is not None:
            beside()
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, p in enumerate(procs):
        with open(os.path.join(out_dir, f"{scenario}_rank{r}.log")) as f:
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{f.read()[-4000:]}"
    results = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results
