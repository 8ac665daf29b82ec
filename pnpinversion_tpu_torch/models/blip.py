"""BLIP-base image captioner (port of ``pnpinversion_tpu/models/blip.py``):
the ViT-B/16 vision tower at 384^2 (``models/vit.py``, DINO style, exact
GELU, 577 tokens) and the BERT-base language-model decoder with
cross-attention to the image tokens. pix2pix-zero captions each input image
with it: the caption is both its inversion prompt and its negative prompt.

Decoding is the JAX package's, id for id: beam search with HF ``generate``'s
rules (num_beams 3, the decoder's max_len 40, min_length 10, length penalty
1: a top-2K candidate pool per step, EOS candidates ranked below K finish a
hypothesis, a finished one replaces the pool's worst (its argmin) when
better, scores are summed log-probs over the generated length, the search
freezes once the pool is full and no live beam can beat its worst), or
greedy decoding at num_beams 1. The decoder runs on the device in f32; the
beam bookkeeping runs on the host in f32 numpy, in the JAX package's order
of operations. Loading converted BLIP weights (``make_blip_captioner``)
waits for the checkpoint loaders (ROADMAP A13); ``random_init`` draws
weights from a seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pnpinversion_tpu_torch.evaluation.metrics import center_crop_resize_224, imagenet_normalize
from pnpinversion_tpu_torch.models.layers import LayerNorm, Linear, init_random_
from pnpinversion_tpu_torch.models.vit import ViT, ViTConfig, init_vit_
from pnpinversion_tpu_torch.utils.device import resolve_device

BLIP_VIT_B16_384 = ViTConfig(image_size=384, patch_size=16, width=768, layers=12, heads=12,
                             style="dino", activation="gelu")
NEG = np.float32(-1e9)


@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    vocab_size: int = 30524
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_len: int = 40
    bos_token_id: int = 30522  # [DEC]
    sep_token_id: int = 102  # [SEP] ends generation
    pad_token_id: int = 0


TINY_BLIP_TEXT = BlipTextConfig(vocab_size=64, width=32, layers=2, heads=2, max_len=8,
                                bos_token_id=1, sep_token_id=2)


class BlipDecoderLayer(nn.Module):
    """A BERT post-LN block: causal self-attention, cross-attention to the
    image tokens, the MLP (the JAX tree's names)."""

    def __init__(self, w: int):
        super().__init__()
        for name in ("self_q", "self_k", "self_v", "self_out",
                     "cross_q", "cross_k", "cross_v", "cross_out"):
            setattr(self, name, Linear(w, w))
        self.self_norm, self.cross_norm, self.out_norm = LayerNorm(w), LayerNorm(w), LayerNorm(w)
        self.fc1, self.fc2 = Linear(w, 4 * w), Linear(4 * w, w)


class BlipTextDecoder(nn.Module):
    def __init__(self, config: BlipTextConfig = BlipTextConfig()):
        super().__init__()
        self.config = config
        w = config.width
        self.word_embedding = nn.Parameter(torch.empty(config.vocab_size, w))
        self.position_embedding = nn.Parameter(torch.empty(512, w))
        self.embed_norm = LayerNorm(w)
        self.layers = nn.ModuleList([BlipDecoderLayer(w) for _ in range(config.layers)])
        self.cls_dense, self.cls_norm = Linear(w, w), LayerNorm(w)
        self.cls_decoder = Linear(w, config.vocab_size)

    def _mha(self, lp, kind: str, x_q, x_kv, mask: Optional[torch.Tensor]):
        b, sq, w = x_q.shape
        heads = self.config.heads
        hd = w // heads

        def split(t):
            return t.view(b, -1, heads, hd).transpose(1, 2)

        q = split(getattr(lp, f"{kind}_q")(x_q))
        k = split(getattr(lp, f"{kind}_k")(x_kv))
        v = split(getattr(lp, f"{kind}_v")(x_kv))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        if mask is not None:
            s = s + mask
        a = torch.softmax(s, dim=-1).to(x_q.dtype)
        o = torch.matmul(a, v).transpose(1, 2).reshape(b, sq, w)
        return getattr(lp, f"{kind}_out")(o)

    def forward(self, token_ids: torch.Tensor, image_tokens: torch.Tensor) -> torch.Tensor:
        """token_ids (B, S) int64; image_tokens (B, N, w) -> logits
        (B, S, vocab), f32."""
        s = token_ids.shape[1]
        x = self.word_embedding[token_ids].float() + self.position_embedding[:s].float()
        x = self.embed_norm(x)
        causal = torch.full((s, s), float("-inf"), device=x.device).triu(1)
        img = image_tokens.to(x.dtype)
        for lp in self.layers:
            x = lp.self_norm(x + self._mha(lp, "self", x, x, causal))
            x = lp.cross_norm(x + self._mha(lp, "cross", x, img, None))
            x = lp.out_norm(x + lp.fc2(F.gelu(lp.fc1(x))))
        h = self.cls_norm(F.gelu(self.cls_dense(x)))
        return self.cls_decoder(h)


def init_blip_decoder_(model: BlipTextDecoder, generator: torch.Generator) -> BlipTextDecoder:
    """The JAX package's init from ``generator``: Linear weights
    uniform(+-1/sqrt(fan_in)), zero biases, norms 1 and 0, both embedding
    tables N(0, 0.02)."""
    init_random_(model, generator)
    with torch.no_grad():
        for p in (model.word_embedding, model.position_embedding):
            p.normal_(0.0, 0.02, generator=generator)
    return model


def _start_ids(cfg: BlipTextConfig, rows: int, prompt_ids) -> np.ndarray:
    ids = np.full((rows, cfg.max_len), cfg.pad_token_id, np.int64)
    ids[:, 0] = cfg.bos_token_id
    ids[:, 1 : 1 + len(prompt_ids)] = prompt_ids
    return ids


def _next_logp(decoder: BlipTextDecoder, ids: np.ndarray, img: torch.Tensor, pos: int,
               log: bool = True) -> np.ndarray:
    """The decoder on every row's ids; the row's log-softmax (or logits) at
    pos - 1, f32 on the host."""
    logits = decoder(torch.as_tensor(ids, device=img.device), img)[:, pos - 1].float()
    return (torch.log_softmax(logits, dim=-1) if log else logits).cpu().numpy()


@torch.no_grad()
def greedy_caption_ids(decoder: BlipTextDecoder, image_tokens: torch.Tensor,
                       prompt_ids: Optional[List[int]] = None) -> np.ndarray:
    """Greedy decoding of N images at once: image_tokens (N, M, w). Returns
    (N, max_len) int64 ids, pad after [SEP]."""
    cfg = decoder.config
    prompt_ids = prompt_ids or []
    n = image_tokens.shape[0]
    ids = _start_ids(cfg, n, prompt_ids)
    start = 1 + len(prompt_ids)
    done = np.zeros((n,), bool)
    for pos in range(start, cfg.max_len):
        if done.all():
            break
        nxt = np.argmax(_next_logp(decoder, ids, image_tokens, pos, log=False), axis=-1)
        ids[~done, pos] = nxt[~done]
        done |= nxt == cfg.sep_token_id
    return ids


class _BeamState:
    """One image's beam search state (the JAX package's scan carry)."""

    def __init__(self, cfg: BlipTextConfig, k: int, prompt_ids):
        self.ids = _start_ids(cfg, k, prompt_ids)
        self.scores = np.full((k,), NEG, np.float32)
        self.scores[0] = 0.0  # all beams start equal: only beam 0 is live
        self.fin_ids = np.full((k, cfg.max_len), cfg.pad_token_id, np.int64)
        self.fin_scores = np.full((k,), NEG, np.float32)
        self.done = False

    def offer(self, score, ids, take_if=True) -> None:
        """A finished hypothesis replaces the pool's worst when better."""
        worst = int(np.argmin(self.fin_scores))
        if take_if and score > self.fin_scores[worst]:
            self.fin_scores[worst] = score
            self.fin_ids[worst] = ids


@torch.no_grad()
def beam_caption_ids(decoder: BlipTextDecoder, image_tokens: torch.Tensor,
                     prompt_ids: Optional[List[int]] = None, num_beams: int = 3,
                     min_length: int = 10, length_penalty: float = 1.0) -> np.ndarray:
    """Beam-search decoding of N images at once (their N * num_beams rows in
    one decoder call a step): image_tokens (N, M, w). Returns the best
    hypothesis of each image, (N, max_len) int64 ids (pad-filled, no
    trailing [SEP])."""
    cfg = decoder.config
    prompt_ids = prompt_ids or []
    K, L, V, eos = num_beams, cfg.max_len, cfg.vocab_size, cfg.sep_token_id
    n = image_tokens.shape[0]
    start = 1 + len(prompt_ids)
    img = image_tokens.repeat_interleave(K, dim=0)
    beams = [_BeamState(cfg, K, prompt_ids) for _ in range(n)]
    lp = np.float32(length_penalty)
    for pos in range(start, L):
        if all(b.done for b in beams):
            break
        logp = _next_logp(decoder, np.concatenate([b.ids for b in beams]), img, pos)
        if pos < min_length:  # HF's MinLengthLogitsProcessor
            logp[:, eos] = NEG
        hyp_len = np.float32(pos + 1 - start) ** lp
        for b, lpi in zip(beams, logp.reshape(n, K, V)):
            if b.done:
                continue
            cand = (b.scores[:, None] + lpi).reshape(-1)
            top_idx = np.argsort(-cand, kind="stable")[: 2 * K]  # lax.top_k's order
            top_val, top_src, top_tok = cand[top_idx], top_idx // V, top_idx % V
            is_eos = top_tok == eos
            for r in range(K):  # EOS candidates ranked below K finish a hypothesis
                b.offer(top_val[r] / hyp_len, b.ids[top_src[r]], bool(is_eos[r]))
            keep = np.flatnonzero(~is_eos)[:K]  # the first K others go on
            ids = b.ids[top_src[keep]]
            ids[:, pos] = top_tok[keep]
            pool_full = b.fin_scores.min() > NEG / 2
            b.done = bool(pool_full and b.fin_scores.min() >= top_val[0] / hyp_len)
            b.ids, b.scores = ids, top_val[keep].astype(np.float32)
    out = []
    for b in beams:
        if not b.done:  # unfinished beams enter at the full generated length
            final = b.scores / np.float32(L - start) ** lp
            for r in range(K):
                b.offer(final[r], b.ids[r])
        out.append(b.fin_ids[int(np.argmax(b.fin_scores))])
    return np.stack(out)


class BlipCaptioner:
    """Callable captioner, uint8 image -> str, on the prompt "a picture of "
    (its tokens without [CLS]/[SEP] continue the [DEC] start token)."""

    def __init__(self, vision: ViT, decoder: BlipTextDecoder, tokenizer,
                 prompt: str = "a picture of ", num_beams: int = 3, min_length: int = 10):
        self.vision, self.decoder, self.tokenizer = vision, decoder, tokenizer
        self.prompt, self.num_beams, self.min_length = prompt, num_beams, min_length

    @classmethod
    def random_init(cls, seed: int, tokenizer, vision_cfg: ViTConfig = BLIP_VIT_B16_384,
                    text_cfg: BlipTextConfig = BlipTextConfig(), prompt: str = "a picture of ",
                    device=None) -> "BlipCaptioner":
        """Weights drawn from ``seed`` on the device (cuda unless given), f32."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.device("meta"):
            vision, decoder = ViT(vision_cfg), BlipTextDecoder(text_cfg)
        vision = init_vit_(vision.to_empty(device=device), gen)
        decoder = init_blip_decoder_(decoder.to_empty(device=device), gen)
        return cls(vision.eval().requires_grad_(False), decoder.eval().requires_grad_(False),
                   tokenizer, prompt)

    def prompt_ids(self) -> List[int]:
        tok = self.tokenizer
        skip = (getattr(tok, "bos_token_id", -1), getattr(tok, "eos_token_id", -1))
        return [t for t in tok.encode(self.prompt) if t not in skip]

    @torch.inference_mode()
    def image_tokens(self, images_u8) -> torch.Tensor:
        """uint8 (N, H, W, 3) -> the vision tower's tokens (N, 577, 768) at
        BLIP's 384^2: shortest side resized, centre crop, ImageNet
        normalisation."""
        dev = self.decoder.word_embedding.device
        size = self.vision.config.image_size
        x = torch.stack([imagenet_normalize(center_crop_resize_224(
            torch.as_tensor(np.asarray(im), device=dev).float() / 255.0, size))
            for im in images_u8])
        tokens, _ = self.vision(x, return_tokens=True)
        return tokens

    @torch.inference_mode()
    def caption_ids(self, images_u8) -> np.ndarray:
        """(N, max_len) ids of N images' captions, decoded together."""
        tokens = self.image_tokens(images_u8)
        if self.num_beams <= 1:
            return greedy_caption_ids(self.decoder, tokens, self.prompt_ids())
        return beam_caption_ids(self.decoder, tokens, self.prompt_ids(),
                                num_beams=self.num_beams, min_length=self.min_length)

    def _decode_ids(self, ids: np.ndarray) -> str:
        cfg = self.decoder.config
        out: List[int] = []
        for t in ids[1:]:
            if t in (cfg.sep_token_id, cfg.pad_token_id):
                break
            out.append(int(t))
        return self.tokenizer.decode(out).strip()

    def caption_batch(self, images_u8) -> List[str]:
        """Captions of (N, H, W, 3) uint8 images."""
        return [self._decode_ids(row) for row in self.caption_ids(np.asarray(images_u8))]

    def __call__(self, image_u8) -> str:
        return self.caption_batch(np.asarray(image_u8)[None])[0]
