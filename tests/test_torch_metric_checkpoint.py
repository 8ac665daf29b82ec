"""The port's loading of the evaluator's metric models and BLIP from local
files, on the CPU at the tiny towers: a seeded ``clip/`` (transformers
CLIPModel names), ``dino/`` (timm), ``lpips/`` (torchvision + lpips heads) and
``blip/`` (lavis) directory loads to modules that give the outputs of the
port's ``from_jax_params`` of the JAX converters' trees of the same files;
``MetricsCalculator(checkpoint_dir=...)`` gives the JAX calculator's row
(the JAX convert CLI caching the same files); the captioner and the CLIP
pair filter load from the directory."""
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import rel_err, seeded_images
from pnpinversion_tpu.convert import metric_models as jmm
from pnpinversion_tpu.convert.torch_to_jax import convert_clip_text
from pnpinversion_tpu_torch.configs import CLIPTextConfig
from pnpinversion_tpu_torch.convert import checkpoint as ck
from pnpinversion_tpu_torch.convert import from_jax_params
from pnpinversion_tpu_torch.convert.from_jax import _load, lpips_state_dict
from pnpinversion_tpu_torch.convert.safetensors_io import write_safetensors
from pnpinversion_tpu_torch.models import blip as tblip
from pnpinversion_tpu_torch.models import vit
from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
from pnpinversion_tpu_torch.models.lpips import LPIPS

RTOL = 1e-5  # of max: the same weights on both sides, f32
CLIP_TEXT = CLIPTextConfig(vocab_size=128, width=32, layers=2, heads=2)  # the tiny calculator's
DINO = vit.ViTConfig(image_size=32, patch_size=8, width=24, layers=2, heads=2, style="dino",
                     activation="gelu")
BLIP_VIT = vit.ViTConfig(image_size=16, patch_size=8, width=32, layers=1, heads=2, style="dino",
                         activation="gelu")
BLIP_VOCAB = (["[PAD]", "[CLS]", "[SEP]", "[UNK]", "a", "picture", "of", "cat", "dog", "on"]
              + [f"w{i}" for i in range(54)])


def _rand(rng, shape, name):
    if name.endswith(("norm1.weight", "norm2.weight", "norm.weight", "LayerNorm.weight",
                      "layrnorm.weight", "layernorm.weight", "layer_norm1.weight",
                      "layer_norm2.weight", "final_layer_norm.weight")):
        return rng.uniform(0.9, 1.1, shape).astype(np.float32)
    if len(shape) >= 2:
        fan_in = int(np.prod(shape[1:]))
        return (rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32)
    return rng.uniform(-0.1, 0.1, shape).astype(np.float32)


def _timm_vit(rng, cfg: vit.ViTConfig, prefix: str = "") -> dict:
    w, n = cfg.width, (cfg.image_size // cfg.patch_size) ** 2 + 1
    shapes = {"cls_token": (1, 1, w), "pos_embed": (1, n, w),
              "patch_embed.proj.weight": (w, 3, cfg.patch_size, cfg.patch_size),
              "patch_embed.proj.bias": (w,), "norm.weight": (w,), "norm.bias": (w,)}
    for i in range(cfg.layers):
        b = f"blocks.{i}"
        shapes.update({f"{b}.norm1.weight": (w,), f"{b}.norm1.bias": (w,),
                       f"{b}.attn.qkv.weight": (3 * w, w), f"{b}.attn.qkv.bias": (3 * w,),
                       f"{b}.attn.proj.weight": (w, w), f"{b}.attn.proj.bias": (w,),
                       f"{b}.norm2.weight": (w,), f"{b}.norm2.bias": (w,),
                       f"{b}.mlp.fc1.weight": (4 * w, w), f"{b}.mlp.fc1.bias": (4 * w,),
                       f"{b}.mlp.fc2.weight": (w, 4 * w), f"{b}.mlp.fc2.bias": (w,)})
    return {prefix + k: _rand(rng, s, k) for k, s in shapes.items()}


def _clip_model(rng) -> dict:
    """A transformers CLIPModel state dict at the tiny calculator's towers."""
    cfg, w = vit.TINY_VIT, vit.TINY_VIT.width
    n = (cfg.image_size // cfg.patch_size) ** 2 + 1
    v = "vision_model."
    shapes = {f"{v}embeddings.class_embedding": (w,),
              f"{v}embeddings.patch_embedding.weight": (w, 3, cfg.patch_size, cfg.patch_size),
              f"{v}embeddings.position_embedding.weight": (n, w),
              f"{v}pre_layrnorm.weight": (w,), f"{v}pre_layrnorm.bias": (w,),
              f"{v}post_layernorm.weight": (w,), f"{v}post_layernorm.bias": (w,),
              "visual_projection.weight": (cfg.projection_dim, w),
              "text_projection.weight": (16, CLIP_TEXT.width)}
    for i in range(cfg.layers):
        b = f"{v}encoder.layers.{i}"
        for p in ("q", "k", "v", "out"):
            shapes[f"{b}.self_attn.{p}_proj.weight"] = (w, w)
            shapes[f"{b}.self_attn.{p}_proj.bias"] = (w,)
        for ln in ("layer_norm1", "layer_norm2"):
            shapes[f"{b}.{ln}.weight"] = shapes[f"{b}.{ln}.bias"] = (w,)
        shapes.update({f"{b}.mlp.fc1.weight": (4 * w, w), f"{b}.mlp.fc1.bias": (4 * w,),
                       f"{b}.mlp.fc2.weight": (w, 4 * w), f"{b}.mlp.fc2.bias": (w,)})
    with torch.device("meta"):
        text = CLIPTextModel(CLIP_TEXT).state_dict()
    shapes.update({k: tuple(t.shape) for k, t in text.items()})
    sd = {k: _rand(rng, s, k) for k, s in shapes.items()}
    sd["logit_scale"] = np.asarray(2.6592, np.float32)
    sd[f"{v}embeddings.position_ids"] = np.arange(n, dtype=np.int64)[None]
    return sd


_LPIPS_SOURCE = {"conv0": "features.0", "squeeze": "squeeze", "expand1": "expand1x1",
                 "expand3": "expand3x3"}


def _lpips(rng) -> dict:
    with torch.device("meta"):
        port = LPIPS().state_dict()
    fires = (3, 4, 6, 7, 9, 10, 11, 12)
    sd = {}
    for k, t in port.items():
        parts = k.split(".")
        if parts[0] == "conv0":
            name = f"features.0.{parts[1]}"
        elif parts[0] == "fires":
            name = f"features.{fires[int(parts[1])]}.{_LPIPS_SOURCE[parts[2]]}.{parts[3]}"
        else:  # lins.<i>.weight
            name = f"lin{parts[1]}.model.1.weight"
        sd[name] = np.abs(_rand(rng, tuple(t.shape), name))  # LPIPS heads are non-negative
    return sd


_BLIP_LAYER = {"self_q": "attention.self.query", "self_k": "attention.self.key",
               "self_v": "attention.self.value", "self_out": "attention.output.dense",
               "self_norm": "attention.output.LayerNorm",
               "cross_q": "crossattention.self.query", "cross_k": "crossattention.self.key",
               "cross_v": "crossattention.self.value",
               "cross_out": "crossattention.output.dense",
               "cross_norm": "crossattention.output.LayerNorm", "fc1": "intermediate.dense",
               "fc2": "output.dense", "out_norm": "output.LayerNorm"}


def _blip(rng) -> dict:
    """lavis BLIP: a timm ViT under visual_encoder., HF's BERT decoder
    (BlipTextLMHeadModel names) under text_decoder."""
    with torch.device("meta"):
        port = tblip.BlipTextDecoder(tblip.TINY_BLIP_TEXT).state_dict()
    top = {"word_embedding": "bert.embeddings.word_embeddings.weight",
           "position_embedding": "bert.embeddings.position_embeddings.weight",
           "embed_norm": "bert.embeddings.LayerNorm",
           "cls_dense": "cls.predictions.transform.dense",
           "cls_norm": "cls.predictions.transform.LayerNorm",
           "cls_decoder": "cls.predictions.decoder"}
    sd = _timm_vit(rng, BLIP_VIT, "visual_encoder.")
    for k, t in port.items():
        parts = k.split(".")
        if parts[0] == "layers":
            name = f"bert.encoder.layer.{parts[1]}.{_BLIP_LAYER[parts[2]]}.{parts[3]}"
        elif parts[0] in ("word_embedding", "position_embedding"):
            name = top[parts[0]]
        else:
            name = f"{top[parts[0]]}.{parts[1]}"
        sd["text_decoder." + name] = _rand(rng, tuple(t.shape), name)
    sd["text_decoder.cls.predictions.bias"] = _rand(rng, (tblip.TINY_BLIP_TEXT.vocab_size,), "b")
    return sd


def _save(d: str, sd: dict) -> None:
    os.makedirs(d, exist_ok=True)
    write_safetensors(os.path.join(d, "model.safetensors"), sd)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    rng = np.random.RandomState(7)
    root = str(tmp_path_factory.mktemp("metrics"))
    _save(os.path.join(root, "clip"), _clip_model(rng))
    _save(os.path.join(root, "dino"), _timm_vit(rng, DINO))
    _save(os.path.join(root, "lpips"), _lpips(rng))
    _save(os.path.join(root, "blip"), _blip(rng))
    os.makedirs(os.path.join(root, "blip_tokenizer"))
    with open(os.path.join(root, "blip_tokenizer", "vocab.txt"), "w") as f:
        f.write("\n".join(BLIP_VOCAB) + "\n")
    return root


def _numpy(d: str) -> dict:
    from safetensors.numpy import load_file

    return load_file(os.path.join(d, "model.safetensors"))


def _images(n: int, size: int) -> torch.Tensor:
    return torch.from_numpy(seeded_images(3, n, size).astype(np.float32) / 127.5 - 1.0)


def test_clip_towers_match_the_jax_converters(root):
    m = ck.load_clip_modules(os.path.join(root, "clip"), vit.TINY_VIT, CLIP_TEXT)
    sd = _numpy(os.path.join(root, "clip"))
    ref_vis = from_jax_params(jmm.convert_clip_vision(sd, layers=2), vit.TINY_VIT)
    ref_text = from_jax_params(convert_clip_text(
        {k[len("text_model."):]: v for k, v in sd.items() if k.startswith("text_model.")},
        CLIP_TEXT), CLIP_TEXT)
    x = _images(2, 32)
    ids = torch.from_numpy((np.arange(154).reshape(2, 77) * 5) % 128)
    with torch.inference_mode():
        assert rel_err(m["clip_vision"](x)[0], ref_vis(x)[0]) <= RTOL
        got, want = m["clip_text"](ids), ref_text(ids)
        assert rel_err(got, want) <= RTOL
        proj = torch.from_numpy(sd["text_projection.weight"])
        assert rel_err(m["clip_text_proj"](got[:, -1]), want[:, -1] @ proj.T) <= RTOL


def test_dino_and_lpips_match_the_jax_converters(root):
    dino = ck.load_dino_module(os.path.join(root, "dino"), DINO)
    ref = from_jax_params(jmm.convert_dino_vit(_numpy(os.path.join(root, "dino")), layers=2), DINO)
    x = _images(2, 32)
    with torch.inference_mode():
        assert rel_err(dino(x, return_tokens=True)[0], ref(x, return_tokens=True)[0]) <= RTOL
    lp = ck.load_lpips_module(os.path.join(root, "lpips"))
    sd = _numpy(os.path.join(root, "lpips"))
    with torch.device("meta"):
        ref = LPIPS()
    ref = _load(ref, lpips_state_dict(jmm.convert_lpips_squeeze(sd, sd)))
    a, b = _images(2, 64)[:1], _images(2, 64)[1:]
    with torch.inference_mode():
        assert rel_err(lp(a, b), ref(a, b)) <= RTOL


def test_blip_matches_the_jax_converters(root):
    vision, decoder = ck.load_blip_modules(os.path.join(root, "blip"), BLIP_VIT,
                                           tblip.TINY_BLIP_TEXT)
    sd = _numpy(os.path.join(root, "blip"))
    ref_vis = from_jax_params(jmm.convert_dino_vit(
        {k[len("visual_encoder."):]: v for k, v in sd.items() if k.startswith("visual_encoder.")},
        layers=1), BLIP_VIT)
    ref_dec = from_jax_params(jmm.convert_blip_decoder(
        {k: v for k, v in sd.items() if k.startswith("text_decoder.")}, layers=2),
        tblip.TINY_BLIP_TEXT)
    x = _images(1, 16)
    ids = torch.tensor([[1, 4, 5, 6, 7]])
    with torch.inference_mode():
        tokens, ref_tokens = vision(x, return_tokens=True)[0], ref_vis(x, return_tokens=True)[0]
        assert rel_err(tokens, ref_tokens) <= RTOL
        assert rel_err(decoder(ids, tokens), ref_dec(ids, ref_tokens)) <= RTOL


def test_blip_captioner_from_the_directory(root):
    cap = tblip.make_blip_captioner(root, device="cpu", vision_cfg=BLIP_VIT,
                                    text_cfg=tblip.TINY_BLIP_TEXT)
    ref = tblip.BlipCaptioner(*ck.load_blip_modules(os.path.join(root, "blip"), BLIP_VIT,
                                                     tblip.TINY_BLIP_TEXT), cap.tokenizer)
    imgs = seeded_images(5, 2, 16)
    assert cap.tokenizer.vocab["picture"] == 5
    np.testing.assert_array_equal(cap.caption_ids(imgs), ref.caption_ids(imgs))
    with pytest.raises(FileNotFoundError):
        tblip.make_blip_captioner(os.path.join(root, "clip"), device="cpu")


def test_a_stray_metric_key_is_refused_by_name(root, tmp_path):
    sd = _numpy(os.path.join(root, "dino"))
    sd["blocks.0.attn.surprise"] = np.zeros(3, np.float32)
    _save(str(tmp_path / "dino"), sd)
    with pytest.raises(KeyError, match="surprise"):
        ck.load_dino_module(str(tmp_path / "dino"), DINO)


def test_pair_clip_filter_from_the_directory(root):
    from pnpinversion_tpu_torch.training.dataset_creation import PairClipFilter

    got = PairClipFilter(checkpoint_dir=root, tiny=True, device="cpu")
    sd = _numpy(os.path.join(root, "clip"))
    tree = {"clip_vision": jmm.convert_clip_vision(sd, layers=2),
            "clip_text": convert_clip_text({k[len("text_model."):]: v for k, v in sd.items()
                                            if k.startswith("text_model.")}, CLIP_TEXT),
            "clip_text_proj": {"kernel": sd["text_projection.weight"].T}}
    want = PairClipFilter(tiny=True, device="cpu", jax_params=tree, tokenizer=got.tokenizer)
    pairs = seeded_images(9, 4, 24).reshape(2, 2, 24, 24, 3)
    a, b = got.scores(pairs, "a cat", "a dog"), want.scores(pairs, "a cat", "a dog")
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=1e-6)


METRICS = ["structure_distance", "psnr", "lpips", "mse", "ssim", "psnr_unedit_part",
           "lpips_unedit_part", "structure_distance_edit_part", "clip_similarity_source_image",
           "clip_similarity_target_image", "clip_similarity_target_image_edit_part"]
CLIP_ATOL = 1e-4  # 100 x a cosine (tests/test_torch_calculator.py)
METRIC_RTOL = {"structure_distance": 1e-4, "structure_distance_edit_part": 1e-4}


def test_metrics_calculator_row_matches_jax(root):
    """The JAX convert CLI caches the same files (tiny configs) and the JAX
    calculator reads them; both calculators score two strips' panels."""
    import pnpinversion_tpu.convert.__main__ as jcli
    from pnpinversion_tpu.configs import CLIPTextConfig as JCLIPTextConfig
    from pnpinversion_tpu.evaluation import evaluate as jev
    from pnpinversion_tpu.evaluation.calculator import MetricsCalculator as JaxCalculator
    from pnpinversion_tpu.models import blip as jblip
    from pnpinversion_tpu.models import vit as jvit
    from pnpinversion_tpu_torch.evaluation import evaluate as tev
    from pnpinversion_tpu_torch.evaluation.calculator import MetricsCalculator

    jcli.convert_metric_dir(root, clip_cfg=jvit.TINY_VIT,
                            dino_cfg=jvit.ViTConfig(**DINO.__dict__),
                            blip_text_cfg=jblip.TINY_BLIP_TEXT,
                            clip_text_cfg=JCLIPTextConfig(vocab_size=128, width=32, layers=2,
                                                          heads=2))
    jcalc = JaxCalculator(tiny=True, checkpoint_dir=root)
    tcalc = MetricsCalculator(tiny=True, device="cpu", checkpoint_dir=root)
    loaded = jax.tree.map(np.asarray, jcalc.params["dino"])
    np.testing.assert_array_equal(tcalc.dino.cls_token.numpy(), loaded["cls_token"])
    rng = np.random.RandomState(12)
    mask = np.zeros((512, 512, 3))
    mask[128:384, 160:352] = 1
    for i in range(2):
        src = Image.fromarray((rng.rand(512, 512, 3) * 255).astype(np.uint8))
        tgt = Image.fromarray((np.clip(np.asarray(src) / 255.0 + rng.randn(512, 512, 3) * 0.1,
                                       0, 1) * 255).astype(np.uint8))
        for metric in METRICS:
            args = (metric, src, tgt, mask, mask, "a cat on a mat", "a dog on a mat")
            got = float(tev.calculate_metric(tcalc, *args))
            want = float(jev.calculate_metric(jcalc, *args))
            if metric.startswith("clip"):
                assert abs(got - want) <= CLIP_ATOL, (i, metric, got, want)
            else:
                assert abs(got - want) <= METRIC_RTOL.get(metric, 1e-5) * abs(want), (
                    i, metric, got, want)


def test_convert_cli_checks_the_metric_models(root, tmp_path, monkeypatch):
    import pnpinversion_tpu_torch.convert.__main__ as cli

    for name, cfg in (("CLIP_VISION", vit.TINY_VIT), ("CLIP_TEXT", CLIP_TEXT), ("DINO", DINO),
                      ("BLIP_VISION", BLIP_VIT), ("BLIP_TEXT", tblip.TINY_BLIP_TEXT)):
        monkeypatch.setattr(cli, name, cfg)
    manifest = cli.main(["--root", root, "--device", "cpu",
                         "--manifest", str(tmp_path / "m.json")])
    metrics = manifest["models"]["metrics"]
    assert sorted(metrics) == ["blip", "clip", "dino", "lpips"]
    assert metrics["lpips"]["tensors_filled"] == 57 and metrics["dino"]["tensors_filled"] > 0
    assert metrics["blip"]["tokenizer"].endswith("vocab.txt")
    assert all("skipped" in manifest["models"][k] for k in ("sd14", "sd21", "ip2p"))
