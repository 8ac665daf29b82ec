"""One rank of the port's multi-process CPU tests: joins a gloo group on the
loopback and runs one scenario. JAX is blocked in a rank (``main``): the
ranks run the port alone; the tests import ``tiny_create`` from here.

    python tests/_torch_mp_worker.py SCENARIO CONFIG --num_processes N \\
        --process_id R --coordinator_address 127.0.0.1:PORT

Scenarios: ``shard`` (process_shard and allreduce_metrics), ``sweep``
(``runners.run_sweep_sharded`` at TINY), ``train`` (``EditTrainer`` steps
with ZeRO and without), ``train_cli`` (the training runner at TINY), ``tp``
(the tensor-parallel sweep, w8 included, and a training step over a (dp, tp)
grid), ``tp_sweep`` (``run_sweep_sharded`` of each method given, on the seeded
weights and JAX's draws of ``install_family``, each run's host decisions and
panel digests recorded: ``parallel/agreement.py``). ``launch`` starts two ``shard`` ranks through
``multihost.launch_local``; ``module -m NAME ARGS`` runs a port module's
main at TINY (``scripts/rehearse_torch.py``'s steps in its test:
``rehearsal_configs``, the tiny metric towers). CONFIG is a JSON file of the scenario's
arguments; each rank writes its results under ``out``.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pnpinversion_tpu_torch.parallel import multihost  # noqa: E402
from pnpinversion_tpu_torch.pipeline import SDPipeline  # noqa: E402

_ORIG_CREATE = SDPipeline.create.__func__
TIMEOUT_S = 60.0  # a lost rank fails the test's run well inside its limit


def tiny_create(cls, config=None, num_ddim_steps=50, checkpoint_dir=None, device=None,
                dtype=None, quantize=None, jax_params=None, **kw):
    """``SDPipeline.create`` at TINY (the config's UNet input channels kept),
    on the CPU in f32, with the port's own random weights from seed 0 (or
    ``jax_params``), w8 with ``quantize``."""
    import dataclasses

    from pnpinversion_tpu_torch.configs import TINY

    assert checkpoint_dir is None and torch.device(device).type == "cpu", (checkpoint_dir,
                                                                          device)
    cfg = dataclasses.replace(TINY, unet=dataclasses.replace(
        TINY.unet, in_channels=config.unet.in_channels))
    return _ORIG_CREATE(cls, cfg, seed=0, num_ddim_steps=num_ddim_steps, device="cpu",
                        dtype=torch.float32, quantize=quantize, jax_params=jax_params)


def rehearsal_configs() -> dict:
    """The configs a TINY rehearsal writes and loads its weights at, by the
    name of the config they stand for: SD1.4's TINY and a TINY SD2.1 (16-dim
    heads, a GELU text tower)."""
    import dataclasses

    from pnpinversion_tpu_torch.configs import TINY

    return {"sd14": dataclasses.replace(TINY, name="sd14"),
            "sd21": dataclasses.replace(
                TINY, unet=dataclasses.replace(TINY.unet, head_dim=16),
                text=dataclasses.replace(TINY.text, activation="gelu"), name="sd21")}


def _run_module(argv):
    """``-m NAME ARGS``: the module's ``__main__`` with the sweep's SD1.4 and
    SD2.1 configs at TINY (their weights load from the given directories)
    and the evaluator's metric towers tiny."""
    import runpy

    from pnpinversion_tpu_torch.evaluation import calculator
    from pnpinversion_tpu_torch.runners import run_sweep

    class TinyCalculator(calculator.MetricsCalculator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, tiny=True, **kwargs)

    assert argv[0] == "-m", argv
    configs = rehearsal_configs()
    run_sweep.SD14, run_sweep.SD21 = configs["sd14"], configs["sd21"]
    calculator.MetricsCalculator = TinyCalculator
    sys.argv = [argv[1]] + list(argv[2:])
    runpy.run_module(argv[1], run_name="__main__", alter_sys=True)


def family_create(cls, config=None, num_ddim_steps=50, checkpoint_dir=None, device=None,
                  dtype=None, quantize=None, pipes=None, vocab="", **kw):
    """``SDPipeline.create`` on the CPU in f32 with the seeded weights of
    ``pipes`` ({config name: (port config, JAX params)}), its word tokenizer
    having seen ``vocab`` first (so every process numbers the words alike)."""
    assert checkpoint_dir is None and torch.device(device).type == "cpu", (checkpoint_dir,
                                                                          device)
    cfg, params = pipes[config.name]
    pipe = _ORIG_CREATE(cls, cfg, seed=0, num_ddim_steps=num_ddim_steps, device="cpu",
                        dtype=torch.float32, quantize=quantize, jax_params=params)
    pipe.tokenizer.encode(vocab)
    return pipe


class Replay:
    """A port draw function (generator, shape, dtype) -> tensor that returns
    ``values`` (the draws JAX makes) in order, from the first again with each
    new generator (every batched call seeds its own)."""

    def __init__(self, values):
        self.values, self.gen, self.i = [np.asarray(v, np.float32) for v in values], None, 0

    def __call__(self, generator, shape, dtype):
        if generator is not self.gen:
            self.gen, self.i = generator, 0
        value = self.values[self.i]
        self.i += 1
        return torch.from_numpy(value).reshape(tuple(shape)).to(dtype)


def _overriding(fn, fixed: dict, *args, **kwargs):
    """``fn`` with ``fixed``'s keyword arguments over the caller's."""
    return fn(*args, **{**kwargs, **fixed})


def install_family(inputs: dict) -> list:
    """A tp-family test's settings in this process (a rank, or the test's
    one-process reference): ``family_create`` for ``SDPipeline.create``; the
    port's draws replaced by JAX's (``draws``: EF's noise, BLD's and the
    instruction editors' sequences, pix2pix-zero's posterior noise and
    rolls); the inner loops' stop threshold ``epsilon`` and steps ``inner``
    where given (in JAX too, by the test: its null-text and null-latent take
    the default 10 steps, StyleDiffusion the runner's constant);
    StyleDiffusion's CLIP tower and networks' start from JAX's. Returns
    [(owner, name, old value)] to undo it."""
    import copy
    import functools

    from pnpinversion_tpu_torch.editors import (
        bld_editor,
        instruct_editor,
        pix2pix_zero_editor,
        stylediffusion_editor,
    )
    from pnpinversion_tpu_torch.inversion import ddim_inversion, ef_ddpm, stylediffusion
    from pnpinversion_tpu_torch.models.vit import ViT
    from pnpinversion_tpu_torch.parallel import sweep

    new = {(SDPipeline, "create"): classmethod(functools.partial(
        family_create, pipes=inputs["pipes"], vocab=inputs["vocab"]))}
    draws = inputs.get("draws", {})
    if "ef" in draws:
        noise = torch.from_numpy(np.asarray(draws["ef"], np.float32))
        new[(ef_ddpm, "sample_xts_from_x0")] = (
            lambda generator, schedule, x0: ef_ddpm.xts_from_noise(schedule, x0,
                                                                 noise.to(x0.dtype)))
    if "bld" in draws:
        new[(bld_editor, "draw_noise")] = Replay(draws["bld"])
    if "instruct" in draws:
        new[(instruct_editor, "draw_noise")] = Replay(draws["instruct"])
    if "p2z" in draws:
        noise, shifts = draws["p2z"]
        new[(pix2pix_zero_editor, "draw_noise")] = Replay([noise])
        new[(pix2pix_zero_editor, "draw_shifts")] = lambda generator, size, steps: shifts
    loops = {k: inputs.get(name) for k, name in (("epsilon", "epsilon"),
                                                 ("num_inner_steps", "inner"))
             if inputs.get(name) is not None}
    if loops:  # over what the batched classes pass
        for owner, fn in ((sweep, ddim_inversion.null_text_optimization),
                          (sweep, ddim_inversion.null_latent_offsets),
                          (stylediffusion_editor, stylediffusion.train_mappers)):
            new[(owner, fn.__name__)] = functools.partial(_overriding, fn, loops)
    if "clip" in inputs:
        clip_cfg, state = inputs["clip"]
        tower = ViT(clip_cfg)
        tower.load_state_dict(state)
        tower = tower.eval().requires_grad_(False)
        new[(sweep, "make_clip_vision")] = lambda device, config=None, seed=42: copy.deepcopy(
            tower)  # a fresh tower each time: a tp group splits its own
        start = inputs["mapper0"]
        new[(stylediffusion_editor, "initial_mapper")] = lambda clip, images, device: {
            k: v.expand((images,) + v.shape[1:]).clone() for k, v in start.items()}
    undo = []
    for (owner, name), value in new.items():
        undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)
    return undo


def _shard(cfg, rank, world):
    items = list(range(cfg["items"]))
    shard = multihost.process_shard(items)
    sums = np.array([float(sum(shard)), float(sum(x * x for x in shard))], np.float32)
    mean = multihost.allreduce_metrics(sums, len(shard))
    # rank-dependent tensors, one a strided view, through 24-byte buckets
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4) * (rank + 1)
    tensors = [base[:, 1:3], torch.full((5,), float(rank)), torch.ones(2, 2) * 10 ** rank]
    n = multihost.all_reduce_(tensors, bucket_bytes=24)
    # each rank's own block filled (rank r's value), the others' blocks junk,
    # along axis 1 of a (3, 4) and axis 0 of a (6,), then gathered
    whole = [torch.full((3, 4), -1.0), torch.full((6,), -1.0)]
    for t, axis in zip(whole, (1, 0)):
        multihost.block(t, axis, rank, world).fill_(10.0 * (rank + 1))
    gathers = multihost.all_gather_blocks_(whole, [1, 0], bucket_bytes=48)
    return {"shard": shard, "mean": [float(v) for v in mean], "collectives": n,
            "reduced": [t.tolist() for t in tensors], "base": base.tolist(),
            "gathered": [t.tolist() for t in whole], "gathers": gathers}


def _sweep(cfg, rank, world):
    """The sharded sweep as given; with ``again``, rank 0 deletes its strips
    and both ranks run it once more (rank 1 then has nothing pending)."""
    from pnpinversion_tpu_torch.runners import run_sweep_sharded

    SDPipeline.create = classmethod(tiny_create)
    out = {"runs": [run_sweep_sharded.main(cfg["argv"])]}
    if cfg.get("again"):
        if rank == 0:
            for path in cfg["delete"]:
                os.unlink(path)
        out["runs"].append(run_sweep_sharded.main(cfg["argv"]))
    return out


def _train(cfg, rank, world):
    """From the checkpoint ``start`` (written at one rank), one step of the
    global ``batch`` with the global ``draws``, ZeRO on and off; each state
    saved (rank 0 writes) under ``out``/zero and ``out``/no_zero."""
    import torch.distributed as dist

    from pnpinversion_tpu_torch.training import trainer as tr

    inputs = torch.load(cfg["inputs"], weights_only=False)  # written by the test itself
    pipe = SDPipeline.create(inputs["config"], device="cpu", dtype=torch.float32,
                             jax_params=inputs["params"], num_ddim_steps=4)
    b = inputs["batch"]["edited"].shape[1] // world
    rows = {k: v[:, rank * b: (rank + 1) * b] for k, v in inputs["batch"].items()}
    out = {"parts": None}
    for zero in (True, False):
        t = tr.EditTrainer(inputs["config"], {"vae": pipe.vae, "text": pipe.text_encoder},
                           pipe.unet, tr.TrainConfig(dtype=torch.float32, zero=zero,
                                                     **inputs["kw"]),
                           inputs["batch"]["edited"].shape[1], inputs["null_ids"],
                           group=dist.group.WORLD)
        assert t.restore(cfg["start"])
        m = t.train_step(rows, draws=inputs["draws"])
        t.save(os.path.join(cfg["out"], "zero" if zero else "no_zero"))
        out["zero" if zero else "no_zero"] = {k: float(v) for k, v in m.items()}
        if zero:
            out["parts"] = t.parts
            out["moment_numel"] = sum(m_.numel() for m_ in t.mu)
    return out


def _train_cli(cfg, rank, world):
    """``runners.run_training_instructpix2pix`` as given, at TINY (the
    runner's 8 input channels)."""
    from pnpinversion_tpu_torch.runners import run_training_instructpix2pix as runner

    SDPipeline.create = classmethod(tiny_create)
    runner.main(cfg["argv"])
    return {}


def _tp(cfg, rank, world):
    """Over a (world / tp, tp) grid: ``runners.run_sweep_sharded`` with
    ``--tp`` on the weights ``params``, float and w8; then, from the one-rank
    checkpoint ``start``, one trainer step of the global ``batch`` with the
    global ``draws`` (ZeRO on), saved under ``out``/tp; then one more
    microbatch's backward, whose replicated gradients each rank hashes."""
    import functools
    import hashlib

    from pnpinversion_tpu_torch.parallel.tensor_parallel import make_groups
    from pnpinversion_tpu_torch.runners import run_sweep_sharded
    from pnpinversion_tpu_torch.training import trainer as tr

    inputs = torch.load(cfg["inputs"], weights_only=False)  # written by the test itself
    SDPipeline.create = classmethod(functools.partial(tiny_create,
                                                      jax_params=inputs["sweep_params"]))
    out = {"sweep": run_sweep_sharded.main(cfg["argv"]),
           "w8": run_sweep_sharded.main(cfg["argv_w8"])}
    SDPipeline.create = classmethod(_ORIG_CREATE)
    grid = make_groups(cfg["tp"])
    pipe = SDPipeline.create(inputs["config"], device="cpu", dtype=torch.float32,
                             jax_params=inputs["params"], num_ddim_steps=4)
    b = inputs["batch"]["edited"].shape[1] // grid.dp
    rows = {k: v[:, grid.dp_index * b: (grid.dp_index + 1) * b]
            for k, v in inputs["batch"].items()}
    t = tr.EditTrainer(inputs["config"], {"vae": pipe.vae, "text": pipe.text_encoder},
                       pipe.unet, tr.TrainConfig(dtype=torch.float32, **inputs["kw"]),
                       inputs["batch"]["edited"].shape[1], inputs["null_ids"],
                       group=grid.dp_group, tp_group=grid.tp_group)
    assert t.restore(cfg["start"])
    out["metrics"] = {k: float(v) for k, v in t.train_step(rows, draws=inputs["draws"]).items()}
    t.save(os.path.join(cfg["out"], "tp"))
    d = {k: v[grid.dp_index * b: (grid.dp_index + 1) * b] for k, v in inputs["draws"][0].items()}
    t.microbatch_loss(t.unet, rows["edited"][0].float(), rows["cond_image"][0].float(),
                      rows["ids"][0].long(), d).backward()
    out["grid"] = [grid.dp_index, grid.tp_index]
    out["split"] = sum(a is not None for a in t.tp_axes)
    out["replicated_grads"] = {
        n: hashlib.sha1(p.grad.numpy().tobytes()).hexdigest() if p.grad is not None else None
        for n, p, a in zip(t.names, t.params, t.tp_axes) if a is None}
    return out


def _tp_sweep(cfg, rank, world):
    """``runners.run_sweep_sharded`` of each of ``runs`` ({method: argv}),
    with ``install_family``'s settings from ``inputs``, each run recorded."""
    from pnpinversion_tpu_torch.parallel import agreement
    from pnpinversion_tpu_torch.runners import run_sweep_sharded

    install_family(torch.load(cfg["inputs"], weights_only=False))  # written by the test
    out = {}
    for method, argv in cfg["runs"].items():
        with agreement.recording() as record:
            out[method] = {"sweep": run_sweep_sharded.main(argv), "record": record}
    return out


SCENARIOS = {"shard": _shard, "sweep": _sweep, "train": _train, "train_cli": _train_cli,
             "tp": _tp, "tp_sweep": _tp_sweep}


def main(argv):
    for name in ("jax", "jaxlib", "pnpinversion_tpu"):
        if sys.modules.get(name) is not None:
            raise RuntimeError(f"{name} was imported into a rank")
        sys.modules[name] = None  # any import of them now raises ImportError
    torch.set_num_threads(1)
    ap = argparse.ArgumentParser()
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("config")
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--coordinator_address", required=True)
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    multihost.initialize(args.coordinator_address, args.num_processes, args.process_id,
                         "gloo", timeout_s=TIMEOUT_S)
    try:
        out = SCENARIOS[args.scenario](cfg, args.process_id, args.num_processes)
    finally:
        multihost.shutdown()
    with open(os.path.join(cfg["out"], f"rank{args.process_id}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1] == "launch":  # two shard ranks started by launch_local
        multihost.launch_local("_torch_mp_worker", ["shard", sys.argv[2]], 2)
    elif sys.argv[1] == "module":
        for name in ("jax", "jaxlib", "pnpinversion_tpu"):
            sys.modules[name] = None
        torch.set_num_threads(2)
        _run_module(sys.argv[2:])
    else:
        main(sys.argv[1:])
