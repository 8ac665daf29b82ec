"""The port's tensor-parallel axis (``parallel/tensor_parallel.py``, ``--tp``)
on the CPU at TINY, f32.

In one process: each split layer's column blocks, concatenated, equal the
whole layer's output (float and w8, Linear and Conv2d); the gather puts the
blocks in rank order through NCCL's and gloo's collectives (faked); the
(dp, tp) grid of ranks is the JAX ``make_dp_tp_mesh``'s; and the layers
split are the leaves ``param_shardings`` splits (less the embedding tables,
which the port keeps whole).

In one launch of four gloo ranks on the loopback (dp = 2 x tp = 2, no JAX in
the ranks): ``run_sweep_sharded --tp 2`` over four items, its strips within
2 uint8 levels of a one-process ``run_sweep`` and of the JAX runner's
(dp = 2, tp = 2) sweep of the same images, each strip written once and each
image counted once; the same with ``--quant w8``; and one trainer step of
the grid against the one-rank step within 1e-5, the replicated gradients
equal on the ranks of a tp group, and the grid's checkpoint resumed at one
rank."""
import copy
import functools
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_mp_worker import tiny_create
from _torch_parity import jax_pipeline, pipeline_params, run_ranks, tiny_configs, torch_pipeline
from pnpinversion_tpu_torch.convert import from_jax
from pnpinversion_tpu_torch.data.pie_bench import mask_encode
from pnpinversion_tpu_torch.models.layers import Conv2d, Linear
from pnpinversion_tpu_torch.ops import quant
from pnpinversion_tpu_torch.parallel import tensor_parallel as tpar
from pnpinversion_tpu_torch.pipeline import SDPipeline
from pnpinversion_tpu_torch.training import trainer as tr

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, TP = 4, 2
N, STEPS, SIZE = 4, 2, 16  # items (two a dp group), DDIM steps, TINY's image size
SRC, TAR, BLEND = "a cat sitting on a mat", "a dog sitting on a mat", "cat dog"
METHOD = "directinversion+p2p"
LEVELS = 2  # uint8 levels: tests/test_sharded_runner.py's tp-against-dp limit
TOL = 1e-5  # the grid's step against one rank's: the same arithmetic, sums in another order
A, B = 2, 4  # microbatches a step, the global batch's rows
KW = dict(base_lr=1e-3, scale_lr=False, warmup_steps=10, clip_grad=0.05, accum=A,
          uncond_prob=0.3, ema_decay=0.9999)


def _layer(kind: str, gen: torch.Generator):
    """(layer, input) of a kind, with seeded weights and a non-zero bias."""
    k, stride = {"conv3x3": (3, 1), "conv3x3_s2": (3, 2), "conv1x1": (1, 1)}.get(kind, (0, 1))
    if k:
        layer, x = Conv2d(12, 16, k, stride=stride), torch.randn(2, 12, 9, 9, generator=gen)
        x = x.contiguous(memory_format=torch.channels_last)
    else:
        layer, x = Linear(12, 16), torch.randn(2, 5, 12, generator=gen)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen) * 0.2)
        layer.bias.copy_(torch.randn(16, generator=gen))
    return layer, x


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("kind", ["linear", "conv3x3", "conv3x3_s2", "conv1x1"])
def test_column_blocks_concatenate_to_the_layer(kind, w8):
    gen = torch.Generator().manual_seed(3)
    layer, x = _layer(kind, gen)
    if w8:
        layer = (quant.QLinear if kind == "linear" else quant.QConv2d).from_float(layer)
    axis = -1 if kind == "linear" else 1
    with torch.no_grad():
        whole = layer(x)
        for tp in (2, 4):
            blocks = [tpar.column_block_(copy.deepcopy(layer), r, tp)(x) for r in range(tp)]
            assert all(b.shape[axis] == 16 // tp for b in blocks)
            torch.testing.assert_close(torch.cat(blocks, dim=axis), whole, rtol=1e-6,
                                       atol=1e-6)
    assert tpar.splits(16, 8) and not tpar.splits(16, 16) and not tpar.splits(18, 4)


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_gather_puts_the_blocks_in_rank_order(monkeypatch, backend, kind):
    """``multihost.all_gather_columns`` as rank 1 of 3, its collectives
    replaced by ones that hand it the other ranks' blocks: NCCL's one
    all_gather_into_tensor and gloo's broadcast from each rank (of the
    blocks' bytes) both give the whole output, a conv's in channels_last."""
    import torch.distributed as dist

    from pnpinversion_tpu_torch.parallel import multihost

    gen = torch.Generator().manual_seed(4)
    whole = torch.randn((2, 12, 5, 5) if kind == "conv" else (2, 7, 12), generator=gen)
    axis = 1 if kind == "conv" else -1
    if kind == "conv":
        whole = whole.contiguous(memory_format=torch.channels_last)
    blocks = [b.movedim(axis, -1).contiguous() for b in whole.chunk(3, dim=axis)]

    def all_gather_into_tensor(out, inp, group=None):
        assert torch.equal(inp, blocks[1])
        out.copy_(torch.stack(blocks))

    def broadcast(buf, src, group=None):
        if src != 1:
            buf.copy_(blocks[src].view(torch.uint8))

    for name, fn in (("get_world_size", lambda g=None: 3), ("get_rank", lambda g=None: 1),
                     ("get_backend", lambda g=None: backend),
                     ("get_global_rank", lambda g, r: r),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("broadcast", broadcast)):
        monkeypatch.setattr(dist, name, fn)
    got = multihost.all_gather_columns(whole.narrow(axis, 4, 4), axis, object())
    assert torch.equal(got, whole)
    if kind == "conv":
        assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_grid_is_the_jax_mesh(tp):
    """Rank r at (dp index, tp index) = its device's place in
    ``make_dp_tp_mesh(4, tp)``."""
    from pnpinversion_tpu.parallel.sweep import make_dp_tp_mesh

    devices = make_dp_tp_mesh(W, tp=tp).devices
    for r in range(W):
        place = tuple(int(i) for i in np.argwhere(devices == jax.devices()[r])[0])
        assert tpar.grid_position(r, W, tp) == place
    with pytest.raises(ValueError, match="does not divide"):
        tpar.grid_position(0, W, 3)


@pytest.mark.parametrize("part", ["unet", "unet_w8", "vae", "text"])
def test_split_layers_are_param_shardings_leaves(part):
    """The port splits a layer exactly where ``param_shardings`` splits its
    weight (JAX's tree marked and carried into the port's names by the weight
    converter); the text tower's two embedding tables, which JAX places split,
    stay whole (a decided difference: the same function either way)."""
    from pnpinversion_tpu.ops.quant import quantize_unet_dots
    from pnpinversion_tpu.parallel.sweep import make_dp_tp_mesh, param_shardings

    jcfg, tcfg = tiny_configs()
    params = pipeline_params(jcfg, seed=5)[part.split("_")[0]]
    if part == "unet_w8":
        params = jax.tree.map(np.array, jax.jit(quantize_unet_dots)(params))
    specs = param_shardings(make_dp_tp_mesh(W, tp=TP), params)
    marked = jax.tree.map(lambda v, s: np.full(np.shape(v), "tp" in tuple(s.spec)), params,
                          specs)
    to_port = {"unet": from_jax.unet_state_dict, "vae": from_jax.vae_state_dict,
               "text": from_jax.clip_text_state_dict}[part.split("_")[0]]
    jax_split = {k for k, v in to_port(marked).items()
                 if k.endswith("weight") and np.ndim(v) in (2, 4) and bool(np.all(v))}
    module = from_jax.from_jax_params(params, getattr(tcfg, part.split("_")[0]))
    port_split = {f"{name}.weight" for name in tpar.column_plan(module, TP)}
    tables = {"text_model.embeddings.token_embedding.weight",
              "text_model.embeddings.position_embedding.weight"}
    assert jax_split - port_split == (tables if part == "text" else set())
    assert port_split <= jax_split and len(port_split) > 10


def _dataset(root: str) -> str:
    """A mini PIE-Bench of N seeded PNG images with one prompt pair (so each
    process's word tokenizer numbers the words alike)."""
    rng = np.random.RandomState(0)
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "annotation_images", "0_random"))
    mapping = {}
    for i in range(N):
        rel = f"0_random/{i:06d}.png"
        Image.fromarray((rng.rand(24, 24, 3) * 255).astype(np.uint8)).save(
            os.path.join(data, "annotation_images", rel))
        mask = np.zeros((512, 512), np.uint8)
        mask[128:384, 96:320] = 1
        mapping[f"{i:06d}"] = {"image_path": rel, "original_prompt": SRC,
                               "editing_prompt": TAR, "editing_instruction": "",
                               "editing_type_id": "0", "blended_word": BLEND,
                               "mask": mask_encode(mask)}
    with open(os.path.join(data, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)
    return data


def _argv(data: str, out: str, *extra) -> list:
    return ["--method", METHOD, "--data_path", data, "--output_path", out, "--num_ddim_steps",
            str(STEPS), "--batch_per_device", "2", "--device", "cpu", *extra]


def _strips(out: str) -> dict:
    folder = os.path.join(out, METHOD, "annotation_images", "0_random")
    return {name: np.asarray(Image.open(os.path.join(folder, name)).convert("RGB"))
            for name in sorted(os.listdir(folder))}


def _one_process_sweep(argv: list, params) -> dict:
    from pnpinversion_tpu_torch.runners import run_sweep

    orig = SDPipeline.create
    SDPipeline.create = classmethod(functools.partial(tiny_create, jax_params=params))
    try:
        return run_sweep.main(argv)
    finally:
        SDPipeline.create = orig


def _jax_tp_sweep(data: str, out: str, params) -> None:
    """The JAX runner's sweep on a (dp = 2, tp = 2) mesh of the virtual CPU
    devices, on the same weights."""
    sys.path.insert(0, REPO)
    import runners.run_sweep_sharded as jrunner
    from pnpinversion_tpu.pipeline import SDPipeline as JaxPipeline

    jcfg = tiny_configs()[0]
    orig = JaxPipeline.create
    JaxPipeline.create = classmethod(
        lambda cls, cfg, num_ddim_steps=50, checkpoint_dir=None, dtype=None, quantize=None:
        jax_pipeline(params, num_ddim_steps, jcfg))
    try:
        jrunner.main(_argv(data, out)[:-2] + ["--n_devices", str(W), "--tp", str(TP)])
    finally:
        JaxPipeline.create = orig


def _port_trainer(s) -> tr.EditTrainer:
    pipe = s["pipe"]
    return tr.EditTrainer(s["tcfg"], {"vae": pipe.vae, "text": pipe.text_encoder}, pipe.unet,
                          tr.TrainConfig(dtype=torch.float32, **KW), B, s["null_ids"])


def _snapshot(t: tr.EditTrainer) -> dict:
    """A copy of the trainer's whole state (its tensors, not views of them)."""
    return {k: ({n: v.detach().clone() for n, v in part.items()} if isinstance(part, dict)
                else part) for k, part in t.state_dict().items()}


def _draws(t: tr.EditTrainer, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [t.draw(B, SIZE, gen) for _ in range(A)]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The four ranks' run and its one-process and JAX references."""
    root = str(tmp_path_factory.mktemp("tp"))
    data = _dataset(root)
    sweep_params = pipeline_params(tiny_configs()[0], seed=31)
    jcfg8, tcfg8 = tiny_configs(8)
    params8 = pipeline_params(jcfg8, seed=21)
    s = {"tcfg": tcfg8, "pipe": torch_pipeline(params8, 4, tcfg8), "root": root}
    rng = np.random.RandomState(1)
    img = lambda: torch.from_numpy(rng.uniform(-1, 1, (A, B, SIZE, SIZE, 3)).astype(np.float32))
    s["null_ids"] = s["pipe"].tokenize([""])[0]
    batch = {"edited": img(), "cond_image": img(),
             "ids": s["pipe"].tokenize([SRC, TAR, "make it red", "add a hat"])[None].repeat(
                 A, 1, 1)}
    one = _port_trainer(s)
    one.train_step(batch, draws=_draws(one, 1))  # a mid-training state: moments not zero
    start = one.save(os.path.join(root, "start"))
    s.update(batch=batch, draws=_draws(one, 2), start=start)
    inputs = os.path.join(root, "inputs.pt")
    torch.save({"config": tcfg8, "params": params8, "sweep_params": sweep_params, "kw": KW,
                "null_ids": s["null_ids"], "batch": batch, "draws": s["draws"]}, inputs)
    out = os.path.join(root, "out")

    def beside():
        """The references, while the ranks run."""
        s["one_metrics"] = {k: float(v) for k, v in one.train_step(batch,
                                                                    draws=s["draws"]).items()}
        s["one"] = _snapshot(one)
        s["next_draws"] = _draws(one, 3)
        s["one_next"] = {k: float(v) for k, v in one.train_step(batch,
                                                                draws=s["next_draws"]).items()}
        s["one_after_next"] = _snapshot(one)
        for name, extra in (("one_process", ()), ("one_process_w8", ("--quant", "w8"))):
            ref = os.path.join(root, name)
            assert _one_process_sweep(_argv(data, ref, *extra), sweep_params) == {"images": N,
                                                                                "batch": 2}
            s[name] = _strips(ref)
        _jax_tp_sweep(data, os.path.join(root, "jax"), sweep_params)
        s["jax"] = _strips(os.path.join(root, "jax"))

    s["ranks"] = run_ranks("tp", {
        "inputs": inputs, "start": start, "tp": TP,
        "argv": _argv(data, out, "--tp", str(TP), "--run_log", os.path.join(root, "log.jsonl")),
        "argv_w8": _argv(data, os.path.join(root, "w8"), "--tp", str(TP), "--quant", "w8")},
        os.path.join(root, "ranks"), n=W, beside=beside)
    s["tp_path"] = os.path.join(root, "ranks", "tp", "step_00000002.pt")
    s["strips"] = _strips(out)
    s["w8"] = _strips(os.path.join(root, "w8"))
    return s


def _close(got: dict, want: dict, panels=slice(0, 4 * SIZE)) -> None:
    assert sorted(got) == sorted(want) == [f"{i:06d}.png" for i in range(N)]
    for name in want:
        assert got[name].shape == want[name].shape == (SIZE, 4 * SIZE, 3)
        diff = np.abs(got[name][:, panels].astype(int) - want[name][:, panels].astype(int))
        assert diff.max() <= LEVELS, (name, diff.max())


def test_tp_sweep_writes_each_strip_once_and_counts_each_image_once(grid):
    sweeps = [r["sweep"] for r in grid["ranks"]]
    assert [r["grid"] for r in grid["ranks"]] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert sweeps == [{"images": 2 if r % TP == 0 else 0, "images_total": N, "batch": 2,
                       "rank": r, "world": W} for r in range(W)]
    events = [json.loads(line) for line in open(os.path.join(grid["root"], "log.jsonl"))]
    assert sorted(e["key"] for e in events if e["event"] == "image_done") == [
        f"{i:06d}" for i in range(N)]
    assert sorted((e["process_index"], e["images_total"]) for e in events
                  if e["event"] == "sweep_done") == [(0, N), (2, N)]


def test_tp_sweep_matches_one_process_and_jax(grid):
    """The grid's strips against one process's (every panel) and against the
    JAX runner's (dp = 2, tp = 2) sweep (the image and the two decoded
    panels; the text panel is drawn by each package's own font path)."""
    _close(grid["strips"], grid["one_process"])
    _close(grid["strips"], grid["jax"], slice(SIZE, 4 * SIZE))


def test_tp_w8_sweep_runs(grid):
    """``--tp 2 --quant w8``: the int8 blocks split with their scales; the
    strips within the limit of a one-process w8 sweep's, and not the float
    sweep's."""
    assert [r["w8"]["images"] for r in grid["ranks"]] == [2, 0, 2, 0]
    _close(grid["w8"], grid["one_process_w8"])
    assert any(not np.array_equal(grid["w8"][k], grid["strips"][k]) for k in grid["strips"])


def _state_err(got: dict, want: dict) -> float:
    """Every tensor of a training state against its own max (the moments
    against their part's max: a tensor whose gradient is ~0 keeps only the
    sums' order in its moments' last digits)."""
    worst = 0.0
    for part in ("params", "ema", "mu", "nu"):
        top = max(float(v.abs().max()) for v in want[part].values())
        for name, v in want[part].items():
            scale = float(v.abs().max()) if part in ("params", "ema") else top
            if scale > 0:
                worst = max(worst, float((got[part][name].cpu() - v.cpu()).abs().max()) / scale)
    return worst


def test_tp_training_step_equals_one_rank_step(grid):
    for rank in grid["ranks"]:
        for key in ("loss", "grad_norm"):
            assert rank["metrics"][key] == pytest.approx(grid["one_metrics"][key], rel=TOL)
    state = torch.load(grid["tp_path"], map_location="cpu", weights_only=True)
    assert state["count"] == state["step"] == 2
    assert _state_err(state, grid["one"]) <= TOL


def test_replicated_gradients_are_equal_on_a_tp_group(grid):
    ranks = grid["ranks"]
    assert ranks[0]["split"] == ranks[1]["split"] > 10
    for a, b in ((0, 1), (2, 3)):
        assert ranks[a]["replicated_grads"] == ranks[b]["replicated_grads"]
    assert len(ranks[0]["replicated_grads"]) > 10


def test_tp_checkpoint_resumes_at_one_rank(grid):
    """The grid's checkpoint restores at one rank (whole tensors, bit for
    bit), and the next step from it matches the one-rank run's next step."""
    restored = _port_trainer(grid)
    assert restored.restore(grid["tp_path"])
    state = torch.load(grid["tp_path"], map_location="cpu", weights_only=True)
    got = restored.state_dict()
    for part in ("params", "ema", "mu", "nu"):
        for name, v in state[part].items():
            assert torch.equal(got[part][name].cpu(), v), (part, name)
    m = restored.train_step(grid["batch"], draws=grid["next_draws"])
    for key in ("loss", "grad_norm"):
        assert float(m[key]) == pytest.approx(grid["one_next"][key], rel=TOL)
    assert _state_err(restored.state_dict(), grid["one_after_next"]) <= TOL
