"""The port's data-parallel trainer (``EditTrainer(..., group=)``, ZeRO-1) on
the CPU at TINY with an 8-channel UNet, in f32, as two gloo ranks on the
loopback, against the one-process step and the JAX package's
``EditTrainer`` on a 2-device mesh with ``zero_shardings``.

One JAX trainer per module, as ``tests/test_torch_training.py`` builds it:
its step compiled once and run twice, the first step making the
mid-training state (moments not zero, the warm-up under way) that the port
starts from, written as a one-rank checkpoint. The ranks restore it (a
one-rank checkpoint at two ranks), take the next step on their rows of the
same global batch with JAX's draws for it, ZeRO on and off, and save (rank 0
writes the gathered state). The ranks import no JAX."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (make_pair_dataset, pipeline_params, rel_err, run_ranks, tiny_configs,
                           torch_pipeline)
from pnpinversion_tpu.training import trainer as jtr
from pnpinversion_tpu_torch.convert import train_state_from_jax, unet_state_dict
from pnpinversion_tpu_torch.training import trainer as tr

torch.set_num_threads(2)

A, B, SIZE, W = 2, 4, 16, 2
# the test_torch_training.py settings, without the lr scaling (so the one-rank
# step has the two-rank step's lr; the scaling by n_dp is tested apart)
KW = dict(base_lr=1e-3, scale_lr=False, warmup_steps=10, clip_grad=0.05, accum=A,
          uncond_prob=0.3, ema_decay=0.9999)
TOL_JAX = 1e-5  # test_torch_training.py's tolerance against JAX
TOL_RANKS = 1e-6  # two ranks against one: the same arithmetic, sums in another order


def jax_draws(rng, a: int = A, b: int = B, h: int = SIZE // 2) -> list:
    """The draws of the JAX train step's microbatches (the global batch's)
    from its key ``rng``, split as ``EditTrainer._microbatch_loss`` splits them."""
    out = []
    for key in jax.random.split(rng, a):
        kz, kt, kn, kd = jax.random.split(key, 4)
        out.append({"z": jax.random.normal(kz, (b, h, h, 4), jnp.float32),
                    "t": jax.random.randint(kt, (b,), 0, 1000),
                    "noise": jax.random.normal(kn, (b, h, h, 4), jnp.float32),
                    "r": jax.random.uniform(kd, (b,))})
    return [{k: torch.as_tensor(np.array(v)) for k, v in d.items()} for d in out]


def _leaves(state: dict) -> dict:
    return {(part, name): np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for part in ("params", "ema", "mu", "nu") for name, v in state[part].items()}


def _worst(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max(rel_err(got[k], want[k]) for k in want if np.abs(want[k]).max() > 0)


def _ranks_err(got: dict, want: dict) -> float:
    """Two ranks against one: each parameter and EMA tensor against its own
    max, each moment against the max of that moment over all tensors. The
    rows' gradient sums run in another order, and a tensor whose gradient is
    ~1e-7 keeps only that order's rounding in its own moments' last digits
    (measured: params 2.7e-7 and EMA 1.8e-7 of their max, mu 1.2e-6 and nu
    3.1e-6 of their own tensor's max but 7.3e-8 and 1.0e-7 of the moment's)."""
    assert got.keys() == want.keys()
    worst = 0.0
    for part in ("params", "ema", "mu", "nu"):
        keys = [k for k in want if k[0] == part]
        if part in ("params", "ema"):
            worst = max([worst] + [rel_err(got[k], want[k]) for k in keys
                                   if np.abs(want[k]).max() > 0])
        else:
            top = max(float(np.abs(want[k]).max()) for k in keys)
            worst = max([worst] + [float(np.abs(got[k] - want[k]).max()) / top for k in keys])
    return worst


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def port_trainer(s, **kw) -> tr.EditTrainer:
    pipe = s["pipe"]
    return tr.EditTrainer(s["tcfg"], {"vae": pipe.vae, "text": pipe.text_encoder}, pipe.unet,
                          tr.TrainConfig(dtype=torch.float32, **{**KW, **kw}), B, s["null_ids"])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from pnpinversion_tpu.parallel.sweep import make_dp_tp_mesh
    from pnpinversion_tpu.utils.tokenizer import SimpleWordTokenizer

    jcfg, tcfg = tiny_configs(8)
    params = pipeline_params(jcfg, seed=21)
    tok = SimpleWordTokenizer()
    ids = np.asarray(tok(["make it red", "add a hat", "turn it blue", "remove the hat"],
                         padding="max_length", max_length=77, truncation=True)["input_ids"],
                     np.int32)
    null_ids = np.asarray(tok([""], padding="max_length", max_length=77,
                              truncation=True)["input_ids"], np.int32)[0]
    jt = jtr.EditTrainer(jcfg, {"vae": params["vae"], "text": params["text"]}, params["unet"],
                         make_dp_tp_mesh(n_devices=W),
                         jtr.TrainConfig(dtype=jnp.float32, zero=True, **KW), B, null_ids)
    rng = np.random.RandomState(0)
    img = lambda: rng.uniform(-1, 1, (A, B, SIZE, SIZE, 3)).astype(np.float32)
    batch = {"edited": img(), "cond_image": img(), "ids": np.stack([ids] * A)}
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    jt.train_step(batch, keys[0])
    mid = jax.device_get(jt.state)
    metrics = {k: float(v) for k, v in jt.train_step(batch, keys[1]).items()}
    after = jax.device_get(jt.state)
    s = dict(tcfg=tcfg, null_ids=null_ids, batch=batch, pipe=torch_pipeline(params, 4, tcfg),
             metrics=metrics, after=after, draws=jax_draws(keys[1]))

    root = tmp_path_factory.mktemp("dp")
    t = port_trainer(s)
    t.load_state_dict(train_state_from_jax(mid, tcfg.unet))
    start = t.save(str(root / "start"))
    inputs = str(root / "inputs.pt")
    torch.save({"config": tcfg, "params": params, "kw": KW, "null_ids": null_ids,
                "batch": {k: torch.as_tensor(v) for k, v in batch.items()},
                "draws": s["draws"]}, inputs)
    s["ranks"] = run_ranks("train", {"inputs": inputs, "start": start}, str(root / "ranks"))
    s["zero"] = _load(str(root / "ranks" / "zero" / "step_00000002.pt"))
    s["no_zero"] = _load(str(root / "ranks" / "no_zero" / "step_00000002.pt"))
    s["one_metrics"] = {k: float(v) for k, v in t.train_step(batch, draws=s["draws"]).items()}
    s["one"] = {k: (dict(v) if isinstance(v, dict) else v) for k, v in t.state_dict().items()}
    s["zero_path"] = str(root / "ranks" / "zero" / "step_00000002.pt")
    return s


@pytest.mark.parametrize("world", [2, 3, 4])
def test_zero_partition_picks_jax_axis(world):
    """For every UNet leaf: the axis ``zero_partition`` picks in the port's
    layout is the one ``zero_shardings`` picks in JAX's (a leaf marked along
    that axis and carried across by the weight converter varies along the
    port's), and replicated leaves stay whole."""
    from pnpinversion_tpu.models.unet import init_unet_params
    from pnpinversion_tpu.parallel.sweep import make_dp_tp_mesh

    jcfg, tcfg = tiny_configs(8)
    shapes = jax.eval_shape(lambda k: init_unet_params(k, jcfg.unet), jax.random.PRNGKey(0))
    specs = jtr.zero_shardings(make_dp_tp_mesh(n_devices=world), shapes)

    def marker(s, sh):
        spec = tuple(sh.spec) + (None,) * (len(s.shape) - len(sh.spec))
        axis = [i for i, a in enumerate(spec) if a == "dp"]
        if not axis:
            return np.zeros(s.shape, np.float32)
        shape = [1] * len(s.shape)
        shape[axis[0]] = s.shape[axis[0]]
        return np.broadcast_to(np.arange(s.shape[axis[0]], dtype=np.float32).reshape(shape),
                               s.shape).copy()

    marked = unet_state_dict(jax.tree.map(marker, shapes, specs))
    split = 0
    for name, v in marked.items():
        varies = [a for a in range(v.ndim) if v.shape[a] > 1
                  and not np.all(np.diff(v, axis=a) == 0)]
        assert tr.zero_partition(v.shape, world) == (varies[0] if varies else None), name
        split += bool(varies)
    assert split > 0  # (at TINY, 3 divides few widths)


@pytest.mark.parametrize("scale_lr,warmup", [(True, 10), (True, 0)])
@pytest.mark.parametrize("n_dp", [2, 4])
def test_lambda_linear_lr_scales_with_ranks(scale_lr, warmup, n_dp):
    kw = dict(base_lr=1e-4, scale_lr=scale_lr, warmup_steps=warmup, accum=3)
    want = jtr.lambda_linear_lr(jtr.TrainConfig(**kw), n_dp, 8)
    got = tr.lambda_linear_lr(tr.TrainConfig(**kw), n_dp, 8)
    for step in (0, 3, 10, 1000):
        assert got(step) == pytest.approx(float(want(jnp.asarray(step, jnp.float32))), rel=1e-7)


def test_two_rank_zero_step_equals_one_rank_step(setup):
    s = setup
    for rank in s["ranks"]:
        for key in ("loss", "grad_norm"):
            assert rank["zero"][key] == pytest.approx(s["one_metrics"][key], rel=TOL_RANKS)
    assert s["zero"]["count"] == s["zero"]["step"] == 2
    assert _ranks_err(_leaves(s["zero"]), _leaves(s["one"])) <= TOL_RANKS


def test_two_rank_zero_step_matches_jax_mesh(setup):
    """Against the JAX trainer's step on the 2-device mesh (its moments
    sharded by ``zero_shardings``): loss, grad norm, every tensor."""
    s = setup
    assert s["ranks"][0]["zero"]["loss"] == pytest.approx(s["metrics"]["loss"], rel=TOL_JAX)
    assert s["ranks"][0]["zero"]["grad_norm"] == pytest.approx(s["metrics"]["grad_norm"],
                                                               rel=TOL_JAX)
    assert s["metrics"]["grad_norm"] > KW["clip_grad"]  # the clip acted
    want = _leaves(train_state_from_jax(s["after"], s["tcfg"].unet))
    assert _worst(_leaves(s["zero"]), want) <= TOL_JAX


def test_zero_shards_the_moments_and_no_zero_gives_the_same_update(setup):
    s = setup
    whole = sum(v.numel() for v in s["one"]["mu"].values())
    parts = s["ranks"][0]["parts"]
    assert parts == s["ranks"][1]["parts"] and sum(p is not None for p in parts) > len(parts) // 2
    for rank in s["ranks"]:
        assert rank["moment_numel"] < 0.6 * whole  # about half of each split tensor
        assert rank["no_zero"] == rank["zero"]
    assert _ranks_err(_leaves(s["no_zero"]), _leaves(s["zero"])) <= TOL_RANKS


def test_two_rank_checkpoint_resumes_at_one_rank(setup):
    """The two ranks' checkpoint restores at one rank bit for bit, and the
    next step from it matches the next step of the one-rank run."""
    s = setup
    restored = port_trainer(s)
    assert restored.restore(s["zero_path"])
    assert (restored.count, restored.step) == (2, 2)
    got = _leaves(restored.state_dict())
    assert all(np.array_equal(got[k], v) for k, v in _leaves(s["zero"]).items())
    ref = port_trainer(s)
    ref.load_state_dict(s["one"])
    ms = [t.train_step(s["batch"], tr.step_generator(5, 2, "cpu")) for t in (restored, ref)]
    assert float(ms[0]["loss"]) == pytest.approx(float(ms[1]["loss"]), rel=TOL_RANKS)
    assert _worst(_leaves(restored.state_dict()), _leaves(ref.state_dict())) <= TOL_JAX


def test_training_cli_two_ranks_then_one(tmp_path, monkeypatch):
    """The runner as two ranks (2 steps of a global batch of 4, ZeRO), rank
    0's log only, then ``--resume`` at one rank to step 3."""
    from _torch_mp_worker import tiny_create
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.runners import run_training_instructpix2pix as runner

    data = make_pair_dataset(str(tmp_path / "ds"), n_items=20, res=20)
    out = tmp_path / "run"
    argv = ["--data_path", data, "--output_dir", str(out), "--batch_per_step", "4",
            "--accumulate_grad_batches", "2", "--max_steps", "2", "--save_every", "0",
            "--log_every", "1", "--min_resize_res", "16", "--max_resize_res", "16",
            "--crop_res", "16", "--dtype", "f32", "--seed", "0", "--device", "cpu",
            "--dist_backend", "gloo"]
    run_ranks("train_cli", {"argv": argv}, str(tmp_path / "ranks"))
    log = [json.loads(line) for line in open(out / "train_log.jsonl")]
    assert [r["event"] for r in log] == ["train", "train", "done"]  # rank 0's alone
    assert log[0]["lr"] == pytest.approx(2 * 2 * 4 * 1e-4)  # scaled with n_dp = 2
    assert os.listdir(out) == ["train_log.jsonl", "step_00000002.pt"] or sorted(
        os.listdir(out)) == ["step_00000002.pt", "train_log.jsonl"]
    monkeypatch.setattr(SDPipeline, "create", classmethod(tiny_create))
    runner.main([a if a != "2" or i != argv.index("--max_steps") + 1 else "3"
                 for i, a in enumerate(argv)][:-2] + ["--resume"])
    log = [json.loads(line) for line in open(out / "train_log.jsonl")]
    assert [r["event"] for r in log][3:] == ["train", "done"] and log[3]["step"] == 3
    assert log[3]["lr"] == pytest.approx(2 * 1 * 4 * 1e-4)  # one rank now
    with pytest.raises(ValueError, match="--tp 2 does not divide the 1 processes"):
        runner.main(argv + ["--tp", "2"])
