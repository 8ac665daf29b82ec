"""One editing family's ``run_sweep_sharded --tp 2`` on the CPU at TINY, f32,
for the ``tests/test_torch_tp_*.py`` files.

``run_family`` launches two gloo ranks on the loopback (one tp group, dp = 1)
through ``tests/_torch_mp_worker.py`` (scenario ``tp_sweep``, no JAX in the
ranks) and, beside them, runs a one-process ``run_sweep`` and the JAX
runner's sweep on a (dp = 1, tp = 2) mesh of the virtual CPU devices, every
run on the same seeded weights (by config: SD1.4's TINY, the instruction
editors' 8-channel TINY, a TINY SD2.1 with 16-dim heads and a GELU text
tower) and the same noise: the port's draws are replaced by the values JAX
draws (``_torch_mp_worker.install_family``). ``check`` holds a method's
runs to what the tests ask: each strip written once (by tp index 0) and each
image counted once; the strips within LEVELS uint8 levels of one process's
(every panel) and of JAX's (the image and the two decoded panels; each
package draws the text panel with its own font path); the two ranks'
records (their host decisions and the digests of their decoded panels,
``parallel/agreement.py``) equal."""
import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_mp_worker import install_family
from _torch_parity import jax_pipeline, pipeline_params, run_ranks, tiny_configs
from test_torch_bld import jax_bld_noise
from pnpinversion_tpu_torch.data import seeded
from pnpinversion_tpu_torch.runners.run_sweep import FOLDERS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, STEPS, SIZE, TP = 2, 2, 16, 2  # items (one batch of the group), DDIM steps, TINY's image
LEVELS = 2  # uint8 levels: the P2P tp sweep's limit (test_torch_tensor_parallel.py)
SRC, TAR = "a cat sitting on a mat", "a dog sitting on a mat"
INSTRUCTION = "make the cat a dog"
CAPTION = "a photo of a cat on a mat"
VOCAB = " ".join(dict.fromkeys(f"{SRC} {TAR} {INSTRUCTION} {CAPTION}".split()))
CLIP = dict(image_size=16, patch_size=8, width=32, layers=2, heads=2, projection_dim=16)
SEEDS = {"sd14": 31, "ip2p": 32, "sd21": 33, "clip": 34}


def dataset(root: str) -> str:
    """A mini PIE-Bench of N seeded 24^2 PNG images with one prompt pair and
    one instruction (``data/seeded.py``), so each process's word tokenizer
    and each family reads the same items, and the captions' file."""
    data = seeded.mini_pie_bench(root, N, size=24, prompts=((SRC, TAR, INSTRUCTION, "cat dog"),),
                                 ext="png")
    with open(os.path.join(root, "captions.json"), "w") as f:
        json.dump({f"{i:06d}": CAPTION for i in range(N)}, f)
    return data


def configs(kind: str):
    """(JAX config, port config) of a config name: SD1.4's TINY, the
    8-channel TINY (ip2p) or a TINY SD2.1 (16-dim heads, GELU text tower)."""
    if kind == "ip2p":
        return tiny_configs(8)
    jcfg, tcfg = tiny_configs()
    if kind == "sd21":
        jcfg, tcfg = (dataclasses.replace(c, unet=dataclasses.replace(c.unet, head_dim=16),
                                          text=dataclasses.replace(c.text, activation="gelu"))
                      for c in (jcfg, tcfg))
    return jcfg, tcfg


def family_inputs(kinds, families, epsilon=None, inner=None) -> dict:
    """What ``install_family`` takes: the seeded weights of each config name
    in ``kinds``, JAX's draws of each family in ``families`` (ef, bld,
    instruct, p2z, stylediffusion; the others draw nothing), the inner
    loops' stop threshold and steps where given."""
    pipes = {}
    for kind in kinds:
        jcfg, tcfg = configs(kind)
        pipes[kind] = (tcfg, pipeline_params(jcfg, seed=SEEDS[kind]))
    inputs = {"pipes": pipes, "vocab": VOCAB, "draws": {}, "epsilon": epsilon, "inner": inner}
    shape = (1, 8, 8, 4)  # one image's latent
    if "ef" in families:
        inputs["draws"]["ef"] = np.random.RandomState(101).randn(
            STEPS, *shape).astype(np.float32)
    # BLD's and the instruction editors' samplers split their keys alike; the
    # seeds are the batched classes' (the JAX classes' too)
    if "bld" in families:
        inputs["draws"]["bld"] = jax_bld_noise(42, shape, STEPS)
    if "instruct" in families:
        inputs["draws"]["instruct"] = jax_bld_noise(1234, shape, STEPS)
    if "p2z" in families:
        from test_torch_pix2pix_zero import jax_editor_draws

        inputs["draws"]["p2z"] = jax_editor_draws(1234, STEPS)
    if "stylediffusion" in families:
        from pnpinversion_tpu.models import stylediffusion as jsd
        from pnpinversion_tpu.models import vit as jvit
        from pnpinversion_tpu_torch.convert import from_jax_params, stylediffusion_mapper_from_jax
        from pnpinversion_tpu_torch.models.vit import ViTConfig

        # the JAX class's tower (PRNGKey(42)) and networks' start (PRNGKey(0))
        cparams = jax.tree.map(np.asarray, jvit.init_vit_params(jax.random.PRNGKey(42),
                                                                jvit.ViTConfig(**CLIP)))
        inputs["clip"] = (ViTConfig(**CLIP),
                          from_jax_params(cparams, ViTConfig(**CLIP)).state_dict())
        tokens = (CLIP["image_size"] // CLIP["patch_size"]) ** 2 + 1
        m0 = jsd.mapper_at_step(jsd.init_mapper_params(jax.random.PRNGKey(0), 1,
                                                       tokens_in=tokens, width=CLIP["width"]), 0)
        inputs["mapper0"] = stylediffusion_mapper_from_jax(jax.tree.map(np.asarray, m0))
    return inputs


def _argv(method: str, data: str, out: str, root: str) -> list:
    argv = ["--method", method, "--data_path", data, "--output_path", out,
            "--num_ddim_steps", str(STEPS), "--batch_per_device", str(N)]
    if method.endswith("pix2pix-zero"):
        argv += ["--caption_file", os.path.join(root, "captions.json")]
    return argv


def strips(out: str, method: str) -> dict:
    folder = os.path.join(out, FOLDERS.get(method, method), "annotation_images", "0_random")
    return {name: np.asarray(Image.open(os.path.join(folder, name)).convert("RGB"))
            for name in sorted(os.listdir(folder))}


def _one_process(inputs: dict, argv: list) -> dict:
    """A one-process ``run_sweep`` with the ranks' settings, recorded."""
    from pnpinversion_tpu_torch.parallel import agreement
    from pnpinversion_tpu_torch.runners import run_sweep

    undo = install_family(inputs)
    try:
        with agreement.recording() as record:
            done = run_sweep.main(argv + ["--device", "cpu"])
    finally:
        for owner, name, value in reversed(undo):
            setattr(owner, name, value)
    return {"done": done, "record": record}


def _jax_sweep(kind: str, inputs: dict, argv: list) -> None:
    """The JAX runner's sweep on a (dp = 1, tp = 2) mesh of two virtual CPU
    devices, on the same weights and draws (EF's noise by replacing
    ``jax.random.normal`` at its shape; the others are JAX's own), with the
    same stop threshold and StyleDiffusion's inner steps where given."""
    sys.path.insert(0, REPO)
    import runners.run_sweep_sharded as jrunner
    from pnpinversion_tpu.inversion import ddim_inversion as jdi
    from pnpinversion_tpu.inversion import stylediffusion as jsdi
    from pnpinversion_tpu.models import vit as jvit
    from pnpinversion_tpu.pipeline import SDPipeline as JaxPipeline

    jcfg = configs(kind)[0]
    params = inputs["pipes"][kind][1]
    method = argv[argv.index("--method") + 1]

    def create(cls, cfg, num_ddim_steps=50, checkpoint_dir=None, dtype=None, quantize=None):
        assert cfg.name == kind, (cfg.name, kind)
        pipe = jax_pipeline(params, num_ddim_steps, jcfg)
        pipe.tokenizer.encode(VOCAB)
        return pipe

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPipeline, "create", classmethod(create))
        if method.startswith("edit-friendly"):
            noise, draw = inputs["draws"]["ef"], jax.random.normal
            mp.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
                jnp.asarray(noise, dtype) if tuple(shape) == noise.shape
                else draw(key, shape, dtype)))
        if inputs.get("epsilon") is not None:
            for module, name in ((jdi, "null_text_optimization"), (jdi, "null_latent_offsets"),
                                 (jsdi, "train_mappers")):
                mp.setattr(module, name, functools.partial(getattr(module, name),
                                                           epsilon=inputs["epsilon"]))
        if method.startswith("stylediffusion"):
            mp.setattr(jrunner, "STYLEDIFFUSION_CLIP_CFG", jvit.ViTConfig(**CLIP))
            if inputs["inner"] is not None:
                mp.setattr(jrunner, "STYLEDIFFUSION_INNER_STEPS", inputs["inner"])
        jrunner.main(argv + ["--n_devices", str(TP), "--tp", str(TP)])


def run_family(root: str, methods: dict, families=(), inner=None, epsilon=None) -> dict:
    """The two ranks' ``run_sweep_sharded --tp 2`` of each method of
    ``methods`` ({method: config name}), with the one-process and JAX sweeps
    beside them. Returns {"ranks": [each rank's {method: {"sweep",
    "record"}}], "events": the tp runs' log, and by method: "tp", "one" and
    "jax" strips and "one_run" (the one process's result and record)}."""
    data = dataset(root)
    inputs = family_inputs(set(methods.values()), families, epsilon, inner)
    path = os.path.join(root, "inputs.pt")
    torch.save(inputs, path)
    log = os.path.join(root, "log.jsonl")
    runs = {m: _argv(m, data, os.path.join(root, "tp"), root)
            + ["--device", "cpu", "--tp", str(TP), "--run_log", log] for m in methods}
    out = {}

    def beside():
        for m in methods:
            one = os.path.join(root, "one")
            out[m] = {"one_run": _one_process(inputs, _argv(m, data, one, root))}
            out[m]["one"] = strips(one, m)
            _jax_sweep(methods[m], inputs, _argv(m, data, os.path.join(root, "jax"), root))
            out[m]["jax"] = strips(os.path.join(root, "jax"), m)

    ranks = run_ranks("tp_sweep", {"inputs": path, "runs": runs}, os.path.join(root, "ranks"),
                      n=TP, beside=beside, timeout=120.0)
    for m in methods:
        out[m]["tp"] = strips(os.path.join(root, "tp"), m)
    events = [json.loads(line) for line in open(log)]
    return {"ranks": ranks, "events": events, **out}


def _close(got: dict, want: dict, panels: slice) -> int:
    """The largest uint8 difference of the strips' ``panels`` columns."""
    assert sorted(got) == sorted(want) == [f"{i:06d}.png" for i in range(N)]
    worst = 0
    for name in want:
        assert got[name].shape == want[name].shape == (SIZE, 4 * SIZE, 3)
        diff = np.abs(got[name][:, panels].astype(int) - want[name][:, panels].astype(int))
        worst = max(worst, int(diff.max()))
    return worst


def check_written_once(run: dict, method: str) -> None:
    """Each strip written once, by tp index 0, and each image counted once."""
    assert [r[method]["sweep"] for r in run["ranks"]] == [
        {"images": N if r == 0 else 0, "images_total": N, "batch": N, "rank": r, "world": TP}
        for r in range(TP)]
    events = [e for e in run["events"] if e.get("method") == method]
    assert sorted(e["key"] for e in events if e["event"] == "image_done") == [
        f"{i:06d}" for i in range(N)]
    assert [(e["process_index"], e["images_total"]) for e in events
            if e["event"] == "sweep_done"] == [(0, N)]


def check_one_process(run: dict, method: str) -> None:
    """Every panel within LEVELS of one process's sweep."""
    assert run[method]["one_run"]["done"] == {"images": N, "batch": N}
    assert _close(run[method]["tp"], run[method]["one"], slice(0, 4 * SIZE)) <= LEVELS


def check_jax(run: dict, method: str) -> None:
    """The image and the two decoded panels within LEVELS of the JAX
    runner's (dp = 1, tp = 2) sweep's."""
    assert _close(run[method]["tp"], run[method]["jax"], slice(SIZE, 4 * SIZE)) <= LEVELS


def rank_records(run: dict, method: str) -> dict:
    """The ranks' records, checked equal (one digest: one batch of N
    images); returns rank 0's."""
    records = [r[method]["record"] for r in run["ranks"]]
    assert records[0] == records[1], records
    assert [kind for kind, _ in records[0]["digests"]] == ["panels"]
    return records[0]
