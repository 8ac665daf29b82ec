"""The port's InstructPix2Pix trainer (``pnpinversion_tpu_torch.training.trainer``)
against the JAX package's ``EditTrainer``, at TINY with an 8-channel UNet, in
f32 on the CPU.

Both sides get one numpy tree of weights; the port gets the very draws (the
posterior noise, timesteps, q_sample noise and dropout uniforms) that JAX
splits from its keys. One JAX trainer per module, on a one-device mesh: its
train step is compiled once and run twice, the first step making the
mid-training state (moments not zero, the warm-up under way) that the port
takes over with ``convert.train_state_from_jax``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (make_pair_dataset, numpy_params, pipeline_params, rel_err, tiny_configs,
                           torch_pipeline)
from pnpinversion_tpu.training import trainer as jtr
from pnpinversion_tpu_torch.convert import from_jax_params, train_state_from_jax
from pnpinversion_tpu_torch.training import trainer as tr

torch.set_num_threads(2)

A, B, SIZE = 2, 2, 16
# dropout far likelier than the default 0.05, so the draws drop prompts and
# images; clipping on and a warm-up under way, so every branch of the step runs
KW = dict(base_lr=1e-3, scale_lr=False, warmup_steps=10, clip_grad=0.05, accum=A,
          uncond_prob=0.3, ema_decay=0.9999)


def _batch(seed: int, ids: np.ndarray) -> dict:
    rng = np.random.RandomState(seed)
    img = lambda: rng.uniform(-1, 1, (A, B, SIZE, SIZE, 3)).astype(np.float32)
    return {"edited": img(), "cond_image": img(), "ids": np.stack([ids] * A)}


def jax_draws(rng, a: int = A, b: int = B, h: int = SIZE // 2) -> list:
    """The draws of the JAX train step's microbatches from its key ``rng``,
    split as ``EditTrainer._microbatch_loss`` splits them."""
    out = []
    for key in jax.random.split(rng, a):
        kz, kt, kn, kd = jax.random.split(key, 4)
        out.append({"z": jax.random.normal(kz, (b, h, h, 4), jnp.float32),
                    "t": jax.random.randint(kt, (b,), 0, 1000),
                    "noise": jax.random.normal(kn, (b, h, h, 4), jnp.float32),
                    "r": jax.random.uniform(kd, (b,))})
    return [{k: torch.as_tensor(np.array(v)) for k, v in d.items()} for d in out]


@pytest.fixture(scope="module")
def setup():
    from pnpinversion_tpu.parallel.sweep import make_dp_tp_mesh
    from pnpinversion_tpu.utils.tokenizer import SimpleWordTokenizer

    jcfg, tcfg = tiny_configs(8)
    params = pipeline_params(jcfg, seed=21)
    tok = SimpleWordTokenizer()
    ids = np.asarray(tok(["make it red", "add a hat"], padding="max_length", max_length=77,
                         truncation=True)["input_ids"], np.int32)
    null_ids = np.asarray(tok([""], padding="max_length", max_length=77,
                              truncation=True)["input_ids"], np.int32)[0]
    jt = jtr.EditTrainer(jcfg, {"vae": params["vae"], "text": params["text"]}, params["unet"],
                         make_dp_tp_mesh(n_devices=1),
                         jtr.TrainConfig(dtype=jnp.float32, zero=False, **KW), B, null_ids)
    batch = _batch(0, ids)
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    jt.train_step(batch, keys[0])
    mid = jax.device_get(jt.state)
    metrics = {k: float(v) for k, v in jt.train_step(batch, keys[1]).items()}
    after = jax.device_get(jt.state)
    pipe = torch_pipeline(params, 4, tcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, ids=ids, null_ids=null_ids, jt=jt,
                batch=batch, keys=keys, mid=mid, metrics=metrics, after=after, pipe=pipe)


def port_trainer(s, **kw) -> tr.EditTrainer:
    pipe = s["pipe"]
    cfg = tr.TrainConfig(dtype=torch.float32, **{**KW, **kw})
    return tr.EditTrainer(s["tcfg"], {"vae": pipe.vae, "text": pipe.text_encoder}, pipe.unet,
                          cfg, B, s["null_ids"])


def test_cond_dropout_masks_exact():
    r = np.array([0.0, 0.01, 0.05, 0.07, 0.1, 0.12, 0.149, 0.15, 0.2, 0.9, 0.99], np.float32)
    for u in (0.05, 0.3):
        want = jtr.cond_dropout_masks(jnp.asarray(r), u)
        got = tr.cond_dropout_masks(torch.as_tensor(r), u)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scale_lr,warmup", [(True, 10), (False, 7), (True, 0)])
def test_lambda_linear_lr(scale_lr, warmup):
    kw = dict(base_lr=1e-4, scale_lr=scale_lr, warmup_steps=warmup, accum=3)
    want = jtr.lambda_linear_lr(jtr.TrainConfig(**kw), 1, 8)
    got = tr.lambda_linear_lr(tr.TrainConfig(**kw), 1, 8)
    for step in (0, 1, 3, 5, 7, 10, 11, 1000):
        w = float(want(jnp.asarray(step, jnp.float32)))
        assert got(step) == pytest.approx(w, rel=1e-7, abs=0.0)


def test_extend_conv_in_keeps_the_model():
    """The zero-extended 8-channel UNet on [latent, anything] computes the
    4-channel UNet's eps (the ip2p initialisation), and its weights are the
    JAX function's, moved to OIHW."""
    from pnpinversion_tpu.models.unet import init_unet_params
    from pnpinversion_tpu_torch.convert import unet_state_dict
    from pnpinversion_tpu_torch.models.unet import UNet

    jcfg4, tcfg4 = tiny_configs(4)
    p4 = numpy_params(init_unet_params, jcfg4.unet, 5)
    unet4 = from_jax_params(p4, tcfg4.unet)
    unet8 = tr.extend_conv_in(unet4, 8)
    assert isinstance(unet8, UNet) and unet8.config.in_channels == 8
    assert tuple(unet8.conv_in.weight.shape) == (32, 8, 3, 3)
    want = unet_state_dict(jax.device_get(jtr.extend_conv_in(jax.tree.map(jnp.asarray, p4), 8)))
    got = unet8.state_dict()
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    rng = np.random.RandomState(3)
    x, junk = (torch.as_tensor(rng.randn(2, 8, 8, 4).astype(np.float32)) for _ in range(2))
    ctx = torch.as_tensor(rng.randn(2, 77, 32).astype(np.float32))
    with torch.no_grad():
        eps4 = unet4(x, 3, ctx)[0]
        eps8 = unet8(torch.cat([x, junk], -1), 3, ctx)[0]
    assert rel_err(eps8, eps4) <= 1e-5
    with pytest.raises(ValueError):
        tr.extend_conv_in(unet8, 4)


def test_microbatch_loss_matches_jax(setup):
    """One microbatch's loss, the JAX method jitted on the same key."""
    s = setup
    key = jax.random.PRNGKey(11)
    frozen = {"vae": s["params"]["vae"], "text": s["params"]["text"]}
    b = s["batch"]
    want = jax.jit(s["jt"]._microbatch_loss)(jax.tree.map(jnp.asarray, s["params"]["unet"]), frozen,
                                    b["edited"][0], b["cond_image"][0], b["ids"][0], key)
    kz, kt, kn, kd = jax.random.split(key, 4)
    draws = {"z": jax.random.normal(kz, (B, 8, 8, 4)), "t": jax.random.randint(kt, (B,), 0, 1000),
             "noise": jax.random.normal(kn, (B, 8, 8, 4)), "r": jax.random.uniform(kd, (B,))}
    draws = {k: torch.as_tensor(np.array(v)) for k, v in draws.items()}
    t = port_trainer(s)
    with torch.no_grad():
        got = t.microbatch_loss(t.unet, torch.as_tensor(b["edited"][0]),
                                torch.as_tensor(b["cond_image"][0]),
                                torch.as_tensor(b["ids"][0]).long(), draws)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def _leaves(state: dict) -> dict:
    """{(part, name): array} over the parts of a port state dict."""
    return {(part, name): np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for part in ("params", "ema", "mu", "nu") for name, v in state[part].items()}


def test_train_step_from_a_mid_training_state_matches_jax(setup):
    """Accumulation over 2 microbatches of 2, clipping on, from the JAX
    trainer's state after one step: the loss, the grad norm and every
    parameter, EMA and moment tensor after the next step, each within 1e-5
    of its max (measured: the loss equal, the grad norm 1.5e-7 rel apart, the
    tensors within 3.3e-6 of max: params 3.2e-6, EMA 2.4e-6, mu 2.3e-6, nu
    3.3e-6)."""
    s = setup
    t = port_trainer(s)
    t.load_state_dict(train_state_from_jax(s["mid"], s["tcfg"].unet))
    assert (t.count, t.step) == (1, 1)
    m = t.train_step(s["batch"], draws=jax_draws(s["keys"][1]))
    assert float(m["loss"]) == pytest.approx(s["metrics"]["loss"], rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(s["metrics"]["grad_norm"], rel=1e-5)
    assert s["metrics"]["grad_norm"] > KW["clip_grad"]  # the clip acted
    assert (t.count, t.step) == (2, 2)
    want = _leaves(train_state_from_jax(s["after"], s["tcfg"].unet))
    got = _leaves(t.state_dict())
    assert got.keys() == want.keys()
    worst = max(rel_err(got[k], want[k]) for k in want if np.abs(want[k]).max() > 0)
    assert worst <= 1e-5, worst
    assert t.learning_rate() == pytest.approx(s["jt"].learning_rate(), rel=1e-7)


def test_remat_matches_no_remat(setup):
    s = setup
    out = []
    for remat in (False, True):
        t = port_trainer(s, remat=remat)
        m = t.train_step(s["batch"], tr.step_generator(0, 0, "cpu"))
        out.append((m, t.state_dict()))
    (m0, s0), (m1, s1) = out
    assert float(m1["loss"]) == pytest.approx(float(m0["loss"]), rel=1e-6)
    assert float(m1["grad_norm"]) == pytest.approx(float(m0["grad_norm"]), rel=1e-6)
    a, b = _leaves(s0), _leaves(s1)
    assert max(rel_err(b[k], a[k]) for k in a if np.abs(a[k]).max() > 0) <= 1e-6


def test_save_restore_step_is_bit_for_bit(setup, tmp_path):
    """Two steps, a save, a third step; a fresh trainer restored from the
    save takes the third step to the very same state."""
    s = setup
    t = port_trainer(s)
    for step in range(2):
        t.train_step(s["batch"], tr.step_generator(3, step, "cpu"))
    path = t.save(str(tmp_path))
    assert os.path.basename(path) == "step_00000002.pt"
    m_ref = t.train_step(s["batch"], tr.step_generator(3, 2, "cpu"))

    fresh = port_trainer(s)
    assert not fresh.restore(directory=str(tmp_path / "none"))
    assert fresh.restore(directory=str(tmp_path))
    assert (fresh.count, fresh.step) == (2, 2)
    m = fresh.train_step(s["batch"], tr.step_generator(3, 2, "cpu"))
    assert float(m["loss"]) == float(m_ref["loss"])
    assert float(m["grad_norm"]) == float(m_ref["grad_norm"])
    a, b = _leaves(t.state_dict()), _leaves(fresh.state_dict())
    assert all(np.array_equal(a[k], b[k]) for k in a)
    v = fresh.val_step(s["batch"], tr.step_generator(3, 9, "cpu"))
    assert v.dtype == torch.float32 and torch.isfinite(v)


def _cli_argv(root: str, out: str) -> list:
    return ["--data_path", root, "--output_dir", out, "--batch_per_step", "2",
            "--accumulate_grad_batches", "2", "--max_steps", "2", "--save_every", "0",
            "--log_every", "1", "--val_every", "2", "--val_batches", "1",
            "--min_resize_res", "16", "--max_resize_res", "16", "--crop_res", "16",
            "--dtype", "f32", "--seed", "0"]


def test_training_cli_end_to_end(tmp_path, monkeypatch):
    """2 steps on a seeds.json dataset (TINY, the CPU), then ``--resume``
    continues to step 3; the JSONL log has its events and fields."""
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.runners import run_training_instructpix2pix as runner

    root = make_pair_dataset(str(tmp_path / "ds"), n_items=20, res=20)
    _, tcfg = tiny_configs(8)
    orig = SDPipeline.create.__func__
    monkeypatch.setattr(SDPipeline, "create", classmethod(
        lambda cls, cfg, **kw: orig(cls, tcfg, num_ddim_steps=4, device=kw["device"])))
    out = tmp_path / "run"
    argv = _cli_argv(root, str(out)) + ["--device", "cpu"]
    runner.main(argv)
    log = [json.loads(line) for line in open(out / "train_log.jsonl")]
    assert [r["event"] for r in log] == ["train", "train", "val", "done"]
    for r in log[:2]:
        assert {"loss", "grad_norm", "lr", "s_per_step", "step"} <= set(r)
        assert np.isfinite(r["loss"]) and r["grad_norm"] > 0
    assert "peak_mem_gb" not in log[0]  # a device metric: only on the card
    assert sorted(os.listdir(out)) == ["step_00000002.pt", "train_log.jsonl"]

    runner.main(argv + ["--resume", "--max_steps", "3"])
    log = [json.loads(line) for line in open(out / "train_log.jsonl")]
    assert log[4]["event"] == "train" and log[4]["step"] == 3
    assert log[-1] == {**log[-1], "event": "done", "step": 3}
    assert sorted(f for f in os.listdir(out) if f.endswith(".pt")) == [
        "step_00000002.pt", "step_00000003.pt"]


def test_training_entry_points_refuse_what_they_cannot_do(tmp_path):
    """No CUDA and no ``--device cpu``: the runner raises (no quiet CPU
    run), also before starting ``--n_devices`` processes; ``--checkpoint_dir``
    is read strictly (a directory without weights raises); of the JAX
    runner's multi-device flags, a ``--tp`` that does not divide the
    processes raises (one process on the CPU included) and
    ``--num_processes`` needs a rank and an address; ``--quant``, which the
    JAX runner does not offer, is refused, and the trainer refuses a w8
    UNet (``PNPI_QUANT=w8``)."""
    from pnpinversion_tpu_torch.runners import run_training_instructpix2pix as runner

    argv = _cli_argv(str(tmp_path / "ds"), str(tmp_path / "run"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            runner.main(argv)
    with pytest.raises(FileNotFoundError, match="no pipeline weights"):
        runner.main(argv + ["--device", "cpu", "--checkpoint_dir", str(tmp_path / "none")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            runner.main(argv + ["--n_devices", "2"])
    with pytest.raises(ValueError, match="--tp 2 does not divide the 1 processes"):
        runner.main(argv + ["--device", "cpu", "--tp", "2"])
    with pytest.raises(ValueError, match="--tp 2 does not divide the 3 processes"):
        runner.main(argv + ["--device", "cpu", "--n_devices", "3", "--tp", "2"])
    with pytest.raises(SystemExit):
        runner.main(argv + ["--device", "cpu", "--quant", "w8"])
    from pnpinversion_tpu_torch.ops.quant import quantize_unet_dots

    jcfg, tcfg = tiny_configs(8)
    unet = quantize_unet_dots(from_jax_params(pipeline_params(jcfg)["unet"], tcfg.unet))
    with pytest.raises(ValueError, match="float UNet"):
        tr.EditTrainer(tcfg, {"vae": None, "text": None}, unet, tr.TrainConfig(), 4,
                       np.zeros(77, np.int32))
    with pytest.raises(ValueError, match="process_id"):
        runner.main(argv + ["--device", "cpu", "--num_processes", "2"])
