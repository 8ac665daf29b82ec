"""InstructPix2Pix training-data generation: P2P pairs + CLIP filtering (port
of ``pnpinversion_tpu/training/dataset_creation.py``).

Counterpart of ``models/instructpix2pix/dataset_creation/
generate_img_dataset.py`` (the modified Euler-ancestral sampler with
self-attention prompt-to-prompt, the per-prompt sample/filter/save loop),
``metrics/clip_similarity.py`` and ``prepare_dataset.py`` (the seeds.json
index). It consumes the prompt records of ``training.prompt_dataset``.

- The reference overwrites the self-attention logits of the second prompt's
  rows with the first's (rows ``(0, 0, 2, 2)`` of each CFG batch of 4);
  ``SelfAttnShareControl`` swaps in those rows' q and k instead, which gives
  the same attention weights and keeps the flash kernel on the path.
- ``sample_shared_pair`` samples n candidate pairs at once: one UNet call of
  4n rows per step, each sample's 4 rows [uncond/caption, uncond/output,
  cond/caption, cond/output] with its own guidance and share threshold
  (the JAX package ``vmap``s the samples). The initial latent and each
  step's ancestral noise are shared across a pair, as in the reference.
- The draws come from one ``torch.Generator`` per candidate, seeded with the
  candidate's seed (``PairGenerator.draws``; the JAX package draws them from
  ``PRNGKey(seed)``); ``sample_shared_pair`` takes them as tensors, so tests
  can hand it the values JAX draws.
- The CLIP filter runs on the device in f32 (ViT-L/14 and its text tower:
  the weights of ``checkpoint_dir``'s ``clip/`` where one is given, random
  ones without); the thresholds, the sort and the files are host work.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from pnpinversion_tpu_torch.configs import CLIPTextConfig
from pnpinversion_tpu_torch.control.base import AttnSite, BaseControl
from pnpinversion_tpu_torch.convert import clip_modules_from_jax_params
from pnpinversion_tpu_torch.evaluation.metrics import clip_normalize, resize
from pnpinversion_tpu_torch.models import vit
from pnpinversion_tpu_torch.models.clip_text import CLIPTextModel
from pnpinversion_tpu_torch.models.layers import init_random_
from pnpinversion_tpu_torch.models.unet import UNet, apply_images
from pnpinversion_tpu_torch.models.vae import latent_to_image
from pnpinversion_tpu_torch.sampling.kdiffusion import get_ancestral_step, get_sigmas, sigma_to_t
from pnpinversion_tpu_torch.schedulers.ddim import DDIMSchedule, _scalar
from pnpinversion_tpu_torch.utils.device import resolve_device, use_full_f32
from pnpinversion_tpu_torch.utils.tokenizer import default_tokenizer

F32 = np.float32
SHARE_ROWS = [0, 0, 2, 2]  # each sample's rows after the share: row 0's q/k on 1, row 2's on 3


class SelfAttnShareControl(BaseControl):
    """Shares each sample's first prompt's self-attention with its second
    for the first ``p2p_thr`` fraction of the steps: at a self-attention site
    and step i, the samples with ``p2p_thr > i / (steps - 1)`` (the
    reference's strict rule) take rows (0, 0, 2, 2)'s q and k on their 4
    rows. ``tensors["p2p_thr"]``: (n,) f32 on the host, one per sample, so
    the gate costs no device sync."""

    def __init__(self, num_steps: int):
        self.num_steps = num_steps

    def qkv_hook(self, site: AttnSite, q, k, v, tensors, state, step):
        if site.is_cross:
            return q, k, v
        frac = F32(step) / F32(max(self.num_steps - 1, 1))
        active = np.asarray(tensors["p2p_thr"], F32) > frac
        if not active.any():
            return q, k, v

        def share(x):
            g = x.view((-1, 4) + x.shape[1:])
            shared = g[:, SHARE_ROWS]
            if not active.all():
                mask = torch.as_tensor(active, device=x.device).view(-1, 1, 1, 1, 1)
                shared = torch.where(mask, shared, g)
            return shared.view(x.shape)

        return share(q), share(k), v


def sample_shared_pair(unet: UNet, schedule: DDIMSchedule, ctx_pair: torch.Tensor,
                       uncond_ctx: torch.Tensor, cfg_scales: np.ndarray, p2p_thrs: np.ndarray,
                       steps: int, control: SelfAttnShareControl, x0: torch.Tensor,
                       noise: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """n candidate pairs: Euler ancestral from shared noise with P2P
    self-attention sharing. ctx_pair (2, 77, W) [caption, output];
    uncond_ctx (1, 77, W); cfg_scales, p2p_thrs (n,) f32 host arrays; x0 (n, 1, h, w, 4)
    the unit initial noise; noise (steps, n, 1, h, w, 4) each step's. The
    latents are carried in ``dtype``, the step's arithmetic in f32. Returns
    (n, 2, h, w, 4) scaled latents in ``dtype``."""
    sigmas = get_sigmas(schedule, steps)
    n = len(cfg_scales)
    x = (x0.to(dtype) * _scalar(sigmas[0], x0.to(dtype))).expand((n, 2) + x0.shape[2:])
    ctx4 = torch.cat([uncond_ctx, uncond_ctx, ctx_pair]).to(dtype)
    ctx4 = ctx4.expand((n,) + ctx4.shape)
    tensors = {"p2p_thr": np.asarray(p2p_thrs, F32)}
    cfg = torch.as_tensor(np.asarray(cfg_scales, F32), device=x0.device).view(n, 1, 1, 1, 1)
    for i in range(steps):
        sigma, sigma_next = F32(sigmas[i]), F32(sigmas[i + 1])
        c_in = F32(1.0) / np.sqrt(F32(1.0) + sigma * sigma, dtype=F32)
        x4 = torch.cat([x, x], dim=1) * _scalar(c_in, x)
        eps4, _ = apply_images(unet, x4, sigma_to_t(schedule, sigma), ctx4, control, tensors, {},
                               i)
        e_unc, e_cond = eps4[:, :2].float(), eps4[:, 2:].float()
        eps = e_unc + cfg * (e_cond - e_unc)
        xf = x.float()
        denoised = xf - float(sigma) * eps
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next)
        d = (xf - denoised) / float(sigma)
        xf = xf + d * float(F32(sigma_down) - sigma)
        xf = xf + noise[i].float() * (sigma_up if sigma_next > 0 else 0.0)
        x = xf.to(dtype)
    return x


class PairGenerator:
    """Samples and decodes candidate pairs for one pipeline."""

    def __init__(self, pipe, steps: int):
        self.pipe = pipe
        self.steps = steps
        self.control = SelfAttnShareControl(steps)

    def draws(self, seeds: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x0 (n, 1, h, w, 4), noise (steps, n, 1, h, w, 4)), f32: each
        candidate's from a generator seeded with its seed, its initial noise
        first."""
        h = self.pipe.latent_size
        c = self.pipe.config.unet.out_channels
        x0, noise = [], []
        for s in seeds:
            g = torch.Generator(device=self.pipe.device).manual_seed(int(s))
            x0.append(torch.randn((1, h, h, c), generator=g, device=g.device))
            noise.append(torch.randn((self.steps, 1, h, h, c), generator=g, device=g.device))
        return torch.stack(x0), torch.stack(noise, dim=1)

    @torch.inference_mode()
    def __call__(self, caption: str, output: str, seeds: Sequence[int], cfgs: np.ndarray,
                 thrs: np.ndarray) -> np.ndarray:
        """len(seeds) candidate pairs; uint8 (n, 2, S, S, 3)."""
        pipe = self.pipe
        ctx_pair = pipe.encode_prompt([caption, output])
        uncond = pipe.encode_prompt([""])
        x0, noise = self.draws(seeds)
        z = sample_shared_pair(pipe.unet, pipe.schedule, ctx_pair, uncond, cfgs, thrs,
                               self.steps, self.control, x0, noise, pipe.dtype)
        n = z.shape[0]
        imgs = latent_to_image(pipe.vae, z.reshape((2 * n,) + z.shape[2:]))
        return imgs.cpu().numpy().reshape((n, 2) + imgs.shape[1:])


class PairClipFilter:
    """CLIP similarity scores of candidate pairs, in f32 on one device.

    Parity: metrics/clip_similarity.py (ViT-L/14; the [0, 1] image resized
    to 224 by the JAX package's antialiased bicubic, CLIP-normalised; cosine
    sims image0-text0, image1-text1, the directional (i1 - i0)-(t1 - t0) and
    image0-image1). The text tower's EOS token (the first, or the largest id
    when the tokenizer has none) through a bias-free projection. Random
    weights from ``seed``, or a JAX ``PairClipFilter``'s tree
    (``jax_params``), or the towers of ``<checkpoint_dir>/clip`` (a
    transformers CLIPModel: ``convert.checkpoint.load_clip_modules``; the
    tokenizer then the directory's CLIP BPE where it has the files). Runs on
    ``cuda`` unless ``device`` says otherwise, in full f32 there."""

    def __init__(self, seed: int = 0, checkpoint_dir: Optional[str] = None, tokenizer=None,
                 tiny: bool = False, device=None, jax_params: Optional[Dict[str, Any]] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_f32()
        self.tokenizer = tokenizer or default_tokenizer(checkpoint_dir)
        if tiny:
            self.vision_cfg = vit.TINY_VIT
            self.text_cfg = CLIPTextConfig(vocab_size=128, width=32, layers=2, heads=2)
            self.proj_dim = 16
        else:
            self.vision_cfg = vit.CLIP_VIT_L14
            self.text_cfg = CLIPTextConfig()
            self.proj_dim = 768
        if jax_params is not None:
            m = clip_modules_from_jax_params(jax_params, self.vision_cfg, self.text_cfg)
        else:
            m = self._random_modules(seed)
        clip_dir = None if checkpoint_dir is None else os.path.join(checkpoint_dir, "clip")
        if clip_dir is not None and os.path.isdir(clip_dir):
            from pnpinversion_tpu_torch.convert.checkpoint import load_clip_modules

            m.update(load_clip_modules(clip_dir, self.vision_cfg, self.text_cfg, self.device))
        for module in m.values():
            module.to(device=self.device, dtype=torch.float32).eval().requires_grad_(False)
        self.clip_vision, self.clip_text, self.clip_text_proj = (
            m["clip_vision"], m["clip_text"], m["clip_text_proj"])

    def _random_modules(self, seed: int) -> Dict[str, torch.nn.Module]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.device("meta"):
            m = {"clip_vision": vit.ViT(self.vision_cfg),
                 "clip_text": CLIPTextModel(self.text_cfg),
                 "clip_text_proj": torch.nn.Linear(self.text_cfg.width, self.proj_dim,
                                                   bias=False)}
        m = {k: v.to_empty(device=self.device) for k, v in m.items()}
        vit.init_vit_(m["clip_vision"], gen)
        init_random_(m["clip_text"], gen)
        init_random_(m["clip_text_proj"], gen)
        return m

    def image_features(self, img01: torch.Tensor) -> torch.Tensor:
        """(n, S, S, 3) in [0, 1] -> (n, proj) unit vectors."""
        size = self.vision_cfg.image_size
        x = clip_normalize(resize(img01, (size, size), "bicubic"))
        emb, _ = self.clip_vision(x)
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    def text_features(self, texts: Sequence[str]) -> torch.Tensor:
        ids = self.tokenizer(list(texts), padding="max_length",
                             max_length=self.text_cfg.max_length, truncation=True)["input_ids"]
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        h = self.clip_text(ids, dtype=torch.float32)
        pos = torch.argmax(ids if eos_id is None else (ids == eos_id).int(), dim=-1)
        e = self.clip_text_proj(h[torch.arange(h.shape[0], device=h.device), pos])
        return e / torch.linalg.norm(e, dim=-1, keepdim=True)

    @torch.inference_mode()
    def scores(self, pairs_u8: np.ndarray, caption: str, output: str) -> Dict[str, np.ndarray]:
        """pairs_u8 (n, 2, S, S, 3) uint8 -> 4 f32 arrays of n scores."""
        t0, t1 = self.text_features([caption, output])
        img01 = torch.as_tensor(pairs_u8.astype(np.float32) / 255.0, device=self.device)
        f0, f1 = self.image_features(img01[:, 0]), self.image_features(img01[:, 1])

        def unit(x):
            return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)

        out = {"clip_sim_0": (f0 * t0[None]).sum(-1), "clip_sim_1": (f1 * t1[None]).sum(-1),
               "clip_sim_dir": (unit(f1 - f0) * unit(t1 - t0)[None]).sum(-1),
               "clip_sim_image": (f0 * f1).sum(-1)}
        return {k: v.cpu().numpy() for k, v in out.items()}


@dataclasses.dataclass(frozen=True)
class FilterThresholds:
    """generate_img_dataset.py defaults."""

    clip_threshold: float = 0.2
    clip_dir_threshold: float = 0.2
    clip_img_threshold: float = 0.7


def filter_results(results: Dict[int, Dict[str, Any]], thresholds: FilterThresholds,
                   max_out_samples: int) -> List[int]:
    """Seeds passing every CLIP threshold, best directional similarity
    first, at most ``max_out_samples``."""
    metadata = [
        (r["clip_sim_dir"], seed) for seed, r in results.items()
        if r["clip_sim_image"] >= thresholds.clip_img_threshold
        and r["clip_sim_dir"] >= thresholds.clip_dir_threshold
        and r["clip_sim_0"] >= thresholds.clip_threshold
        and r["clip_sim_1"] >= thresholds.clip_threshold
    ]
    metadata.sort(reverse=True)
    return [seed for _, seed in metadata[:max_out_samples]]


def generate_for_prompt(
    prompt: Dict[str, str],
    prompt_dir: str,
    generator: PairGenerator,
    clip_filter: PairClipFilter,
    *,
    n_samples: int = 100,
    max_out_samples: int = 4,
    min_p2p: float = 0.1,
    max_p2p: float = 0.9,
    min_cfg: float = 7.5,
    max_cfg: float = 15.0,
    thresholds: FilterThresholds = FilterThresholds(),
    batch: int = 4,
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Samples, filters and saves one prompt's pairs; returns the number
    kept. A prompt_dir that already has metadata.jsonl is skipped (the
    reference would regenerate and append)."""
    os.makedirs(prompt_dir, exist_ok=True)
    meta_path = os.path.join(prompt_dir, "metadata.jsonl")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return sum(1 for _ in f)
    with open(os.path.join(prompt_dir, "prompt.json"), "w") as f:
        json.dump(prompt, f)

    rng = rng if rng is not None else np.random.default_rng(0)
    results: Dict[int, Dict[str, Any]] = {}
    images: Dict[int, np.ndarray] = {}
    while len(results) < n_samples:
        n = min(batch, n_samples - len(results))
        seeds = []
        while len(seeds) < n:
            s = int(rng.integers(0, 2**31 - 1))
            if s not in results and s not in seeds:
                seeds.append(s)
        thrs = rng.uniform(min_p2p, max_p2p, n).astype(np.float32)
        cfgs = rng.uniform(min_cfg, max_cfg, n).astype(np.float32)
        pairs = generator(prompt["caption"], prompt["output"], seeds, cfgs, thrs)
        sc = clip_filter.scores(pairs, prompt["caption"], prompt["output"])
        for j, s in enumerate(seeds):
            results[s] = {
                "p2p_threshold": float(thrs[j]),
                "cfg_scale": float(cfgs[j]),
                **{k: float(v[j]) for k, v in sc.items()},
            }
            images[s] = pairs[j]

    kept = filter_results(results, thresholds, max_out_samples)
    for seed in kept:
        Image.fromarray(images[seed][0]).save(
            os.path.join(prompt_dir, f"{seed}_0.jpg"), quality=100)
        Image.fromarray(images[seed][1]).save(
            os.path.join(prompt_dir, f"{seed}_1.jpg"), quality=100)
        with open(meta_path, "a") as f:
            f.write(json.dumps(dict(seed=seed, **results[seed])) + "\n")
    if not kept:
        # mark it done, so a resumed run does not regenerate a prompt whose
        # samples all failed the filter
        open(meta_path, "a").close()
    return len(kept)


def prepare_dataset(dataset_dir: str) -> str:
    """Prompt dirs -> seeds.json (prepare_dataset.py: the seeds are the name
    prefixes of every *_0.jpg, entries sorted by dir name)."""
    seeds = []
    for name in sorted(os.listdir(dataset_dir)):
        d = os.path.join(dataset_dir, name)
        if not os.path.isdir(d):
            continue
        prompt_seeds = sorted(f.split("_")[0] for f in os.listdir(d) if f.endswith("_0.jpg"))
        if prompt_seeds:
            seeds.append((name, prompt_seeds))
    seeds.sort()
    path = os.path.join(dataset_dir, "seeds.json")
    with open(path, "w") as f:
        json.dump(seeds, f)
    return path


def load_prompts(prompts_file: str) -> List[Dict[str, str]]:
    with open(prompts_file) as f:
        return [json.loads(line) for line in f if line.strip()]


def partition_prompts(prompts: List[Dict[str, str]], n_partitions: int,
                      partition: int) -> List[Tuple[int, Dict[str, str]]]:
    """np.array_split over enumerate(prompts) (generate_img_dataset.py)."""
    idx = np.array_split(np.arange(len(prompts)), n_partitions)[partition]
    return [(int(i), prompts[int(i)]) for i in idx]
