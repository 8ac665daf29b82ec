"""The port's pair generation and CLIP filtering
(``pnpinversion_tpu_torch.training.dataset_creation``) against the JAX
package's, at TINY in f32 on the CPU: both sides get one numpy tree of
weights, and the port the very draws JAX makes from each candidate's
``PRNGKey(seed)``. The JAX sampler (a ``vmap`` over the candidates of a scan
over the steps) is compiled once, for 2 candidates, and serves both tests
that use it."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import jax_torch_pipelines, numpy_params, rel_err
from pnpinversion_tpu.training import dataset_creation as jdc
from pnpinversion_tpu_torch.control.base import AttnSite
from pnpinversion_tpu_torch.training import dataset_creation as dc

torch.set_num_threads(2)

STEPS = 3
N = 2  # candidates per sampler call
PROMPT = {"caption": "a cat on a mat", "edit": "make it a dog", "output": "a dog on a mat"}


def jax_draws(seeds, steps: int = STEPS, h: int = 8):
    """(x0, noise) as ``jdc.sample_shared_pair`` draws them from each seed's key."""
    x0, noise = [], []
    for s in seeds:
        k0, key = jax.random.split(jax.random.PRNGKey(int(s)))
        x0.append(np.asarray(jax.random.normal(k0, (1, h, h, 4), jnp.float32)))
        steps_noise = []
        for _ in range(steps):
            key, kn = jax.random.split(key)
            steps_noise.append(np.asarray(jax.random.normal(kn, (1, h, h, 4), jnp.float32)))
        noise.append(np.stack(steps_noise))
    return torch.as_tensor(np.stack(x0)), torch.as_tensor(np.stack(noise, axis=1))


class JaxDrawsGenerator(dc.PairGenerator):
    """The port's generator fed JAX's draws."""

    def draws(self, seeds):
        return jax_draws(seeds, self.steps, self.pipe.latent_size)


def clip_params(seed: int) -> dict:
    from pnpinversion_tpu.configs import CLIPTextConfig
    from pnpinversion_tpu.models import vit
    from pnpinversion_tpu.models.clip_text import init_clip_text_params
    from pnpinversion_tpu.models.layers import init_linear

    text_cfg = CLIPTextConfig(vocab_size=128, width=32, layers=2, heads=2)
    return {"clip_vision": numpy_params(vit.init_vit_params, vit.TINY_VIT, seed),
            "clip_text": numpy_params(init_clip_text_params, text_cfg, seed + 1),
            "clip_text_proj": numpy_params(lambda k, c: init_linear(k, 32, 16, use_bias=False),
                                           None, seed + 2)}


@pytest.fixture(scope="module")
def sides():
    jpipe, tpipe = jax_torch_pipelines(seed=31, steps=4)
    params = clip_params(41)
    jfilter = jdc.PairClipFilter(tiny=True, tokenizer=jpipe.tokenizer)
    jfilter.params = jax.tree.map(jnp.asarray, params)
    tfilter = dc.PairClipFilter(tiny=True, tokenizer=tpipe.tokenizer, device="cpu",
                                jax_params=params)
    return dict(jpipe=jpipe, tpipe=tpipe, jgen=jdc.PairGenerator(jpipe, STEPS),
                tgen=JaxDrawsGenerator(tpipe, STEPS), jfilter=jfilter, tfilter=tfilter)


def test_share_control_gates_rows_per_sample():
    """Each sample's 4 rows against the JAX control on that sample alone,
    across the gate's boundary (thr 0.5 of 10 steps: on at step 4, off at
    5) and a sample that never shares (thr 0)."""
    from pnpinversion_tpu.control.base import AttnSite as JaxSite

    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(12, 2, 6, 8).astype(np.float32) for _ in range(3))
    thrs = np.array([0.5, 0.0, 1.0], np.float32)
    jctl, ctl = jdc.SelfAttnShareControl(10), dc.SelfAttnShareControl(10)
    site = AttnSite(index=0, place="down", resolution=4, is_cross=False, heads=2)
    jsite = JaxSite(index=0, place="down", resolution=4, is_cross=False, heads=2)
    for step in (0, 4, 5, 9):
        got = ctl.qkv_hook(site, *(torch.as_tensor(x) for x in (q, k, v)), {"p2p_thr": thrs},
                           {}, step)
        for j, thr in enumerate(thrs):
            rows = slice(4 * j, 4 * j + 4)
            want = jctl.qkv_hook(jsite, q[rows], k[rows], v[rows], {"p2p_thr": jnp.float32(thr)},
                                 {}, jnp.int32(step))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[rows].numpy(), np.asarray(w))
    shared = ctl.qkv_hook(site, *(torch.as_tensor(x) for x in (q, k, v)),
                          {"p2p_thr": np.ones(3, np.float32)}, {}, 0)
    assert torch.equal(shared[0][1], torch.as_tensor(q[0]))
    assert torch.equal(shared[1][7], torch.as_tensor(k[6]))
    cross = dataclasses.replace(site, is_cross=True)
    out = ctl.qkv_hook(cross, *(torch.as_tensor(x) for x in (q, k, v)), {"p2p_thr": thrs}, {}, 0)
    assert all(torch.equal(o, torch.as_tensor(x)) for o, x in zip(out, (q, k, v)))


def test_sample_shared_pair_matches_jax_vmap(sides):
    """Two candidates batched in one UNet call of 8 rows against JAX's
    ``vmap`` of one candidate: within 1e-5 of max."""
    jpipe, tpipe = sides["jpipe"], sides["tpipe"]
    seeds, cfgs, thrs = [11, 12], np.array([7.5, 12.0], np.float32), np.array([0.7, 0.2], np.float32)
    ctx_pair = jpipe.encode_prompt([PROMPT["caption"], PROMPT["output"]])
    uncond = jpipe.encode_prompt([""])
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    want = sides["jgen"]._sample(jpipe.params["unet"], ctx_pair, uncond, jnp.asarray(cfgs),
                                 jnp.asarray(thrs), keys)
    x0, noise = jax_draws(seeds)
    with torch.no_grad():
        got = dc.sample_shared_pair(
            tpipe.unet, tpipe.schedule, tpipe.encode_prompt([PROMPT["caption"], PROMPT["output"]]),
            tpipe.encode_prompt([""]), cfgs, thrs, STEPS, dc.SelfAttnShareControl(STEPS), x0,
            noise)
    assert got.shape == (N, 2, 8, 8, 4)
    assert rel_err(got, want) <= 1e-5


def test_clip_filter_scores_match_jax(sides):
    pairs = (np.random.RandomState(5).rand(3, 2, 16, 16, 3) * 255).astype(np.uint8)
    want = sides["jfilter"].scores(pairs, PROMPT["caption"], PROMPT["output"])
    got = sides["tfilter"].scores(pairs, PROMPT["caption"], PROMPT["output"])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == (3,) and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5 * np.abs(want[key]).max())


def test_clip_filter_entry_points():
    with pytest.raises(NotImplementedError, match="A13"):
        dc.PairClipFilter(tiny=True, device="cpu", checkpoint_dir="ckpt")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dc.PairClipFilter(tiny=True)


def test_filter_results_exact():
    rng = np.random.RandomState(3)
    results = {int(s): {"clip_sim_0": float(a), "clip_sim_1": float(b), "clip_sim_dir": float(c),
                        "clip_sim_image": float(d)}
               for s, (a, b, c, d) in zip(rng.permutation(1000)[:40], rng.rand(40, 4))}
    for thr in ((0.2, 0.2, 0.7), (0.0, 0.0, 0.0), (0.5, 0.1, 0.3), (1.1, 0.0, 0.0)):
        for k in (1, 4, 100):
            want = jdc.filter_results(results, jdc.FilterThresholds(*thr), k)
            assert dc.filter_results(results, dc.FilterThresholds(*thr), k) == want


def _written(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(dirpath, f), root)] = os.path.join(dirpath, f)
    return out


def test_generate_for_prompt_writes_what_jax_writes(sides, tmp_path):
    """4 candidates in 2 sampler calls of 2, the best 3 by directional
    similarity kept (thresholds that keep every pair): the same files, the
    same prompt.json, metadata (seeds, thresholds and guidance equal; CLIP
    scores within 1e-3: the decoded pairs they score are uint8, where the
    f32 noise of the sampler and the decode flips a value by one level here
    and there, which moved a TINY score by up to 1.1e-4, the directional one,
    whose unit (f1 - f0) magnifies it; on equal images the scores agree
    within 1e-5, ``test_clip_filter_scores_match_jax``) and seeds.json; each
    image within 2 uint8 levels of JAX's after the JPEG round trip. A second
    call skips the prompt."""
    kw = dict(n_samples=4, max_out_samples=3, batch=N)
    out = {}
    for name, mod, gen, filt in (("jax", jdc, sides["jgen"], sides["jfilter"]),
                                 ("torch", dc, sides["tgen"], sides["tfilter"])):
        root = tmp_path / name
        kept = mod.generate_for_prompt(PROMPT, str(root / "0000000"), gen, filt,
                                       thresholds=mod.FilterThresholds(-1.0, -1.0, -1.0),
                                       rng=np.random.default_rng(9), **kw)
        assert kept == 3
        mod.prepare_dataset(str(root))
        out[name] = _written(str(root))
    jax_files, torch_files = out["jax"], out["torch"]
    assert sorted(torch_files) == sorted(jax_files)
    for rel in jax_files:
        a, b = jax_files[rel], torch_files[rel]
        if rel.endswith(".jpg"):
            diff = np.abs(np.asarray(Image.open(a), int) - np.asarray(Image.open(b), int))
            assert diff.max() <= 2, (rel, diff.max())
        elif rel.endswith("metadata.jsonl"):
            ja = [json.loads(line) for line in open(a)]
            tb = [json.loads(line) for line in open(b)]
            assert [r["seed"] for r in tb] == [r["seed"] for r in ja]
            for r, w in zip(tb, ja):
                assert r["p2p_threshold"] == w["p2p_threshold"]
                assert r["cfg_scale"] == w["cfg_scale"]
                for key in ("clip_sim_0", "clip_sim_1", "clip_sim_dir", "clip_sim_image"):
                    assert r[key] == pytest.approx(w[key], abs=1e-3)
        else:
            assert open(a).read() == open(b).read(), rel
    again = dc.generate_for_prompt(PROMPT, str(tmp_path / "torch" / "0000000"), sides["tgen"],
                                   sides["tfilter"], **kw)
    assert again == 3


def test_prompts_io_matches_jax(tmp_path):
    path = tmp_path / "prompts.jsonl"
    recs = [{"caption": f"a cat {i}", "edit": "make it red", "output": f"a red cat {i}"}
            for i in range(7)]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    assert dc.load_prompts(str(path)) == jdc.load_prompts(str(path)) == recs
    for n, part in ((1, 0), (3, 0), (3, 2), (8, 7)):
        assert dc.partition_prompts(recs, n, part) == jdc.partition_prompts(recs, n, part)
