"""The port's entry points on the CPU at TINY: the P2P runner's strips
against the JAX runner's on a two-image mini PIE-Bench (the same numpy
weights in both packages, ``SDPipeline.create`` patched in both, as the
verify recipe does), the skip-existing contract, every other editing
runner's strips against the port's own editor called with the runner's
arguments, the one-GPU sweep against its ``Batched*`` class (the padded
slot dropped, an unreadable input logged and skipped), and every entry
point refusing to run without CUDA unless ``--device cpu`` is given."""
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import assert_strips_match, jax_pipeline, pipeline_params, tiny_configs
from pnpinversion_tpu_torch.data.pie_bench import mask_encode
from pnpinversion_tpu_torch.pipeline import SDPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
SIZE = 16  # TINY's image size
PROMPTS = [("a cat sitting on a mat", "a dog sitting on a mat", "cat dog"),
           ("a red car on the road", "a blue car on the road", "red blue"),
           ("a cat sitting on a mat", "a cat sitting on a red mat", "")]


def _dataset(root, n: int, unreadable: bool = False) -> str:
    """A PIE-Bench mapping of n seeded PNG images (lossless strips out), and
    optionally one unreadable input."""
    rng = np.random.RandomState(0)
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "annotation_images", "0_random"))
    mapping = {}
    for i in range(n + unreadable):
        rel = f"0_random/{i:06d}.png"
        path = os.path.join(data, "annotation_images", rel)
        if i < n:
            Image.fromarray((rng.rand(24, 24, 3) * 255).astype(np.uint8)).save(path)
        else:
            with open(path, "wb") as f:
                f.write(b"not an image")
        mask = np.zeros((512, 512), np.uint8)
        mask[128:384, 96:320] = 1
        src, tar, blend = PROMPTS[i % len(PROMPTS)]
        mapping[f"{i:06d}"] = {"image_path": rel, "original_prompt": src,
                               "editing_prompt": tar, "editing_instruction": f"make it {i}",
                               "editing_type_id": "0", "blended_word": blend,
                               "mask": mask_encode(mask)}
    with open(os.path.join(data, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)
    return data


PARAMS = {}


def _params(in_channels: int):
    if in_channels not in PARAMS:
        PARAMS[in_channels] = pipeline_params(tiny_configs(in_channels)[0], seed=21)
    return PARAMS[in_channels]


def _tiny_create(cls, config=None, num_ddim_steps=50, checkpoint_dir=None, device=None,
                 dtype=None, **kw):
    """``SDPipeline.create`` at TINY (the config's UNet input channels kept),
    on the CPU in f32, with seeded numpy weights."""
    assert checkpoint_dir is None and device == "cpu", (checkpoint_dir, device)
    cfg = tiny_configs(config.unet.in_channels)[1]
    return _ORIG_CREATE(cls, cfg, num_ddim_steps=num_ddim_steps, device="cpu",
                        dtype=dtype or torch.float32, jax_params=_params(cfg.unet.in_channels))


_ORIG_CREATE = SDPipeline.create.__func__


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(SDPipeline, "create", classmethod(_tiny_create))


def _strip(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def _args(data, out, method, *extra):
    return ["--data_path", data, "--output_path", out, "--edit_method_list", method,
            "--num_ddim_steps", str(STEPS), "--device", "cpu", *extra]


def test_p2p_runner_matches_the_jax_runner(tmp_path, tiny, monkeypatch):
    """The port's and the JAX run_editing_p2p.main write the same strips for
    directinversion+p2p; a rerun skips and leaves the files alone;
    --rerun_exist_images writes them again (--profile_dir traces the first)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    import runners.run_editing_p2p as jrunner
    from pnpinversion_tpu.pipeline import SDPipeline as JaxPipeline
    from pnpinversion_tpu_torch.runners import run_editing_p2p as runner

    jcfg = tiny_configs(4)[0]
    monkeypatch.setattr(JaxPipeline, "create", classmethod(
        lambda cls, cfg, num_ddim_steps=50, checkpoint_dir=None, quantize=None:
        jax_pipeline(_params(4), num_ddim_steps, jcfg)))
    data = _dataset(str(tmp_path), 2)
    method = "directinversion+p2p"
    out, jout = str(tmp_path / "out"), str(tmp_path / "jout")
    runner.main(_args(data, out, method))
    jrunner.main(_args(data, jout, method)[:-2])  # the JAX runner has no --device
    paths = [os.path.join(out, method, "annotation_images", "0_random", f"{i:06d}.png")
             for i in range(2)]
    for p in paths:
        want = _strip(p.replace(out, jout))
        assert_strips_match(_strip(p), want, size=SIZE)

    for p in paths:
        os.utime(p, ns=(10**9, 10**9))
    runner.main(_args(data, out, method))
    assert [os.stat(p).st_mtime_ns for p in paths] == [10**9, 10**9]
    trace_dir = tmp_path / "trace"
    runner.main(_args(data, out, method, "--rerun_exist_images", "--profile_dir",
                      str(trace_dir)))
    assert all(os.stat(p).st_mtime_ns > 10**9 for p in paths)
    # a torch.profiler trace of the first image, and its program spans beside it
    assert sorted(os.listdir(trace_dir)) == [f"spans_{os.getpid()}.json",
                                             f"trace_{os.getpid()}.json"]


TINY_CLIP = dict(image_size=16, patch_size=8, width=32, layers=2, heads=2, projection_dim=16)

# runner module -> (its method, extra flags, the editor call it must match)
RUNNERS = {
    "run_editing_masactrl": ("directinversion+masactrl", (), lambda ed, it: ed(
        "directinversion+masactrl", it.image_path, it.source_prompt, it.target_prompt,
        guidance_scale=7.5, step=4, layper=10)),
    "run_editing_pnp": ("ddim+pnp", (), lambda ed, it: ed(
        "ddim+pnp", it.image_path, it.source_prompt, it.target_prompt, guidance_scale=7.5)),
    "run_editing_edit_friendly_p2p": ("edit-friendly-inversion+p2p", (), lambda ed, it: ed(
        "edit-friendly-inversion+p2p", it.image_path, it.source_prompt, it.target_prompt,
        source_guidance_scale=1, target_guidance_scale=7.5, cross_replace_steps=0.4,
        self_replace_steps=0.6)),
    "run_editing_edict": ("edict+p2p", ("--precision", "f32"), lambda ed, it: ed(
        "edict+p2p", it.image_path, it.source_prompt, it.target_prompt)),
    "run_editing_instructpix2pix": ("instruct-pix2pix", (), lambda ed, it: ed(
        "instruct-pix2pix", it.image_path, it.editing_instruction, steps=STEPS, cfg_text=7.5,
        cfg_image=1.5)),
    "run_editing_instructdiffusion": ("instruct-diffusion", (), lambda ed, it: ed(
        "instruct-diffusion", it.image_path, it.editing_instruction, steps=STEPS, cfg_text=5.0,
        cfg_image=1.25)),
    "run_editing_blended_latent_diffusion": ("blended-latent-diffusion", (), lambda ed, it: ed(
        "blended-latent-diffusion", it.image_path,
        Image.fromarray(np.uint8(it.mask)).convert("L"), it.target_prompt, guidance_scale=7.5,
        blending_percentage=0.25)),
    "run_editing_pix2pix_zero": ("directinversion+pix2pix-zero", ("--caption_file", "CAPTIONS"),
                                 lambda ed, it: ed(
        "directinversion+pix2pix-zero", it.image_path, it.source_prompt, it.target_prompt,
        guidance_scale=7.5, caption=f"a picture {it.key}")),
    "run_editing_stylediffusion": ("stylediffusion+p2p", (), lambda ed, it: ed(
        "stylediffusion+p2p", it.image_path, it.source_prompt, it.target_prompt,
        guidance_scale=7.5, num_inner_steps=100, tau_v=0.5, tau_c=0.6, tau_s=0.6, tau_u=0.0)),
}
FOLDERS = {"stylediffusion+p2p": "styleidffusion+p2p"}
# runner module -> (its editor class, its pipeline's config)
EDITORS = {"run_editing_masactrl": ("MasaCtrlEditor", "SD14"),
           "run_editing_pnp": ("PnPEditor", "SD14"),
           "run_editing_edit_friendly_p2p": ("EditFriendlyEditor", "SD14"),
           "run_editing_edict": ("EDICTEditor", "SD14"),
           "run_editing_instructpix2pix": ("InstructEditor", "IP2P"),
           "run_editing_instructdiffusion": ("InstructEditor", "IP2P"),
           "run_editing_blended_latent_diffusion": ("BlendedLatentDiffusionEditor", "SD21"),
           "run_editing_pix2pix_zero": ("Pix2PixZeroEditor", "SD14"),
           "run_editing_stylediffusion": ("StyleDiffusionEditor", "SD14")}


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_runner_writes_its_editors_strips(tmp_path, tiny, monkeypatch, name):
    import importlib

    from pnpinversion_tpu_torch.data.pie_bench import PieBenchDataset
    from pnpinversion_tpu_torch.models.vit import ViTConfig

    runner = importlib.import_module(f"pnpinversion_tpu_torch.runners.{name}")
    calls = []
    if name == "run_editing_stylediffusion":
        class QuickStyleDiffusion(runner.StyleDiffusionEditor):
            """A CLIP tower as wide as TINY's context, and 3 inner steps
            where the runner asks for 100 (the call's arguments recorded)."""

            def __init__(self, pipe):
                super().__init__(pipe, clip_vision_cfg=ViTConfig(**TINY_CLIP))

            def __call__(self, *a, **kw):
                calls.append(kw)
                return super().__call__(*a, **{**kw, "num_inner_steps": 3})

        monkeypatch.setattr(runner, "StyleDiffusionEditor", QuickStyleDiffusion)
    method, extra, call = RUNNERS[name]
    data = _dataset(str(tmp_path), 1)
    item = next(PieBenchDataset(data).items())
    captions = tmp_path / "captions.json"
    captions.write_text(json.dumps({item.key: f"a picture {item.key}"}))
    extra = [str(captions) if a == "CAPTIONS" else a for a in extra]
    out = str(tmp_path / "out")
    runner.main(_args(data, out, method, *extra))
    got = _strip(os.path.join(out, FOLDERS.get(method, method), "annotation_images",
                              "0_random", "000000.png"))
    assert got.shape == (SIZE, 4 * SIZE, 3) and got.dtype == np.uint8

    class Args:  # the runner's pipeline, made again the same way
        device, num_ddim_steps, checkpoint_dir = "cpu", STEPS, None

    from pnpinversion_tpu_torch import cli, configs

    editor_name, config = EDITORS[name]
    pipe = cli.make_pipeline(Args, getattr(configs, config))
    editor = getattr(runner, editor_name)(pipe)
    if name == "run_editing_edict":
        editor = runner.EDICTEditor(pipe, precision="f32")
    want = call(editor, item)
    np.testing.assert_array_equal(got, want)
    if calls:  # the runner's own arguments reached the editor
        assert calls[0] == calls[-1] == dict(guidance_scale=7.5, num_inner_steps=100, tau_v=0.5,
                                             tau_c=0.6, tau_s=0.6, tau_u=0.0)


def test_one_image_runner_and_edit_cli(tmp_path, tiny):
    from pnpinversion_tpu_torch.runners import edit_cli, run_editing_p2p_one_image

    sys.path.insert(0, REPO)
    from runners.edit_cli import fit_64 as jax_fit_64

    img = tmp_path / "in.png"
    Image.fromarray((np.random.RandomState(1).rand(40, 72, 3) * 255).astype(np.uint8)).save(img)
    out = tmp_path / "edited.png"
    run_editing_p2p_one_image.main(["--image_path", str(img), "--prompt_src", "a cat on a mat",
                                    "--prompt_tar", "a dog on a mat", "--blended_word", "cat",
                                    "dog", "--output_path", str(out), "--num_ddim_steps", "2",
                                    "--tiny", "--device", "cpu"])
    assert _strip(out).shape == (SIZE, 4 * SIZE, 3)
    for w, h, res in ((72, 40, 64), (40, 72, 64), (500, 333, 512), (512, 512, 512)):
        assert edit_cli.fit_64(w, h, res) == jax_fit_64(w, h, res)
    w, h = edit_cli.fit_64(72, 40, 64)
    edited = tmp_path / "e.png"
    edit_cli.main(["--input", str(img), "--output", str(edited), "--edit", "make it blue",
                   "--resolution", "64", "--steps", "2", "--seed", "3", "--device", "cpu"])
    assert _strip(edited).shape == (h, w, 3)
    copied = tmp_path / "c.png"
    edit_cli.main(["--input", str(img), "--output", str(copied), "--edit", "",
                   "--resolution", "64", "--steps", "2", "--device", "cpu"])
    assert _strip(copied).shape == (h, w, 3)


def test_sweep_matches_the_batched_class(tmp_path, tiny):
    """run_sweep at batch 2 over three images (one chunk padded) gives the
    batched class's strips; the unreadable fourth input is logged and
    skipped."""
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.control.p2p import make_p2p_control, stack_tensors
    from pnpinversion_tpu_torch.data.pie_bench import PieBenchDataset, load_image
    from pnpinversion_tpu_torch.parallel.sweep import BatchedDirectInversionP2P
    from pnpinversion_tpu_torch.runners import run_sweep
    from pnpinversion_tpu_torch.utils.image import make_strip, txt_draw

    data = _dataset(str(tmp_path), 3, unreadable=True)
    out, log = str(tmp_path / "out"), str(tmp_path / "log.jsonl")
    method = "directinversion+p2p"
    done = run_sweep.main(["--method", method, "--data_path", data, "--output_path", out,
                           "--num_ddim_steps", str(STEPS), "--batch_per_device", "2",
                           "--run_log", log, "--device", "cpu"])
    assert done == {"images": 3, "batch": 2}
    events = [json.loads(line) for line in open(log)]
    assert [e["key"] for e in events if e["event"] == "image_error"] == ["000003"]
    folder = os.path.join(out, method, "annotation_images", "0_random")
    assert sorted(os.listdir(folder)) == [f"{i:06d}.png" for i in range(3)]

    # the batched class on the same chunks: items 0 and 1 blend (one spec),
    # item 2 does not (another spec, its chunk padded with itself)
    pipe = SDPipeline.create(SD14, num_ddim_steps=STEPS, device="cpu")
    sweep = BatchedDirectInversionP2P(pipe)
    uncond = pipe.encode_prompt(["", ""])
    items = list(PieBenchDataset(data).items())[:3]
    controls = []
    for it in items:
        blended = it.blended_word
        controls.append(make_p2p_control(
            [it.source_prompt, it.target_prompt], pipe.tokenizer, num_steps=STEPS,
            blend_words=(((blended[0],), (blended[1],)) if blended else None),
            eq_params=({"words": (blended[1],), "values": (2,)} if blended else None),
            num_lb_slots=pipe.num_lb_slots, lb_res=pipe.lb_res, latent_size=pipe.latent_size))
    assert controls[0][0].spec == controls[1][0].spec != controls[2][0].spec
    for chunk in ([0, 1], [2, 2]):
        images = np.stack([load_image(items[i].image_path, SIZE) for i in chunk])
        cond = torch.stack([pipe.encode_prompt([items[i].source_prompt, items[i].target_prompt])
                            for i in chunk])
        recon, edit = sweep.edit_batch(controls[chunk[0]][0].spec, images, cond, uncond, 7.5,
                                       stack_tensors([controls[i][1] for i in chunk]))
        for slot, i in enumerate(sorted(set(chunk))):
            text = txt_draw(f"source prompt: {items[i].source_prompt}\n"
                            f"target prompt: {items[i].target_prompt}", target_size=(SIZE, SIZE))
            want = make_strip([text, images[slot], recon[slot], edit[slot]])
            assert_strips_match(_strip(os.path.join(folder, f"{i:06d}.png")), want, size=SIZE)


ENTRY_POINTS = {
    "pnpinversion_tpu_torch.runners.run_sweep": ["--data_path", "D"],
    "pnpinversion_tpu_torch.runners.run_sweep_sharded": ["--data_path", "D"],
    "pnpinversion_tpu_torch.runners.run_editing_p2p_one_image": [
        "--image_path", "I", "--prompt_src", "a", "--prompt_tar", "b"],
    "pnpinversion_tpu_torch.runners.edit_cli": ["--input", "I", "--output", "O", "--edit", "e"],
    "pnpinversion_tpu_torch.convert.__main__": ["--root", "R"],
    **{f"pnpinversion_tpu_torch.runners.{name}": ["--data_path", "D"]
       for name in ["run_editing_p2p"] + sorted(RUNNERS)},
}


@pytest.mark.parametrize("module", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_cuda(module):
    import importlib

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(module).main(ENTRY_POINTS[module])


def test_quant_w8_names_the_roadmap_item(tmp_path, monkeypatch):
    """``--quant w8`` reaches ``SDPipeline.create(quantize="w8")`` from the
    editing runners (``cli.make_pipeline``) and the sweep, whose strips then
    come from a w8 UNet (the JAX runners plumb it the same way); an unknown
    mode is refused by argparse."""
    from pnpinversion_tpu_torch.ops.quant import is_quantized
    from pnpinversion_tpu_torch.runners import run_editing_p2p, run_sweep

    made = []

    def create(cls, config=None, num_ddim_steps=50, checkpoint_dir=None, device=None,
               dtype=None, quantize=None, **kw):
        cfg = tiny_configs(config.unet.in_channels)[1]
        made.append((quantize, _ORIG_CREATE(cls, cfg, num_ddim_steps=num_ddim_steps,
                                            device="cpu", dtype=torch.float32,
                                            jax_params=_params(4), quantize=quantize)))
        return made[-1][1]

    monkeypatch.setattr(SDPipeline, "create", classmethod(create))
    data = _dataset(str(tmp_path), 1)
    method = "directinversion+p2p"
    run_editing_p2p.main(_args(data, str(tmp_path / "out"), method, "--quant", "w8"))
    run_sweep.main(["--method", method, "--data_path", data, "--output_path",
                    str(tmp_path / "sweep"), "--num_ddim_steps", str(STEPS), "--device", "cpu",
                    "--quant", "w8"])
    assert [q for q, _ in made] == ["w8", "w8"] and all(is_quantized(p.unet) for _, p in made)
    for out in ("out", "sweep"):
        path = tmp_path / out / method / "annotation_images" / "0_random" / "000000.png"
        assert _strip(path).shape == (SIZE, 4 * SIZE, 3)
    with pytest.raises(SystemExit):
        run_editing_p2p.main(["--data_path", data, "--quant", "w4", "--device", "cpu"])
