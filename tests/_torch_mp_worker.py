"""One rank of the port's multi-process CPU tests: joins a gloo group on the
loopback and runs one scenario. JAX is blocked in a rank (``main``): the
ranks run the port alone; the tests import ``tiny_create`` from here.

    python tests/_torch_mp_worker.py SCENARIO CONFIG --num_processes N \\
        --process_id R --coordinator_address 127.0.0.1:PORT

Scenarios: ``shard`` (process_shard and allreduce_metrics), ``sweep``
(``runners.run_sweep_sharded`` at TINY), ``train`` (``EditTrainer`` steps
with ZeRO and without), ``train_cli`` (the training runner at TINY), ``tp``
(the tensor-parallel sweep, w8 included, and a training step over a (dp, tp)
grid). ``launch`` starts two ``shard`` ranks through
``multihost.launch_local``. CONFIG is a JSON file of the scenario's
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


SCENARIOS = {"shard": _shard, "sweep": _sweep, "train": _train, "train_cli": _train_cli,
             "tp": _tp}


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
    else:
        main(sys.argv[1:])
