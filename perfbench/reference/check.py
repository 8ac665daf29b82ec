"""The check that decides ``correct``: the reference follows the program's own
trajectory one step at a time, at the timed sizes.

With random weights a diffusion edit is chaotic: a one-ulp change of one
latent moves the final edit by up to the whole range of a pixel, so two runs
that differ only in rounding cannot be compared end to end. The harness
records, for one chunk of the window (one batched call of the entry), every
UNet call (input latents, timestep, output noise, every row) and the VAE's
encoder output, decoder input and decoder output; the reference takes each
stage's input from the program:

- ``eps_rel``: each UNet call's noise against the reference UNet's on the same
  latents, under the reference's own text embeddings and its own attention
  edit (relative L2 over an image's rows; the largest over calls and images);
- ``step_rel``: each step's next latents (DDIM inversion; the edit's guided
  step with DirectInversion's re-snapped source row and LocalBlend; BLD's
  masked blend with freshly noised source latents; the last step's are the
  decoder's input) against the reference's step taken from the same current
  latents on the candidate's own noise, pooled over the steps relative to the
  steps' size: sqrt(sum |c - r|^2) / sqrt(sum |r - cur|^2) (largest over
  images). The UNet's share of a step is ``eps_rel``'s; this is the rest;
- ``encode_rel``: the encoder's posterior mean against the reference's
  encoding of the input image (relative L2; largest over images);
- ``decode_rel``: the decoder's output against the reference decoder's on the
  program's decoder input (relative L2; largest over rows);
- ``panel_mae``: the strip's input, reconstruction and edit panels against the
  reference's (the input as loaded; the reference's decode of the program's
  decoder input) through the strip's own file format, as 8x8 block means
  (mean absolute difference in uint8 levels; largest over panels and
  images): block means, since JPEG's quantisation turns a small difference
  of two panels into a coarser one pixel by pixel;
- ``strip_err`` (the program only): each panel of each strip it wrote
  against the panel its own loaded image or decoder output makes once saved
  (largest difference in levels): the strip writer, exactly.

The call structure of each method (which call computes which rows, how a
step is taken) is ``reference/methods/<family>.py``, named by the mix's
``family``: a new method is a new file there.

Each number is taken for a *candidate*: the program (its captures and the
strips it wrote) or a control (the reference at another precision put in the
program's place, on the same captured inputs). LocalBlend's mask thresholds a
normalised map; where the reference's map lies within ``LB_AMBIGUOUS`` of the
threshold the reference takes either side, whichever is nearer the
candidate's latents.
"""
from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from perfbench.reference import diffusion as D
from perfbench.reference import text as T

LB_AMBIGUOUS = 0.02
# a JPEG decoder's chroma upsampling reads across a panel's left and right
# edges into its neighbours in the strip: those columns are left out
PANEL_MARGIN = 4
IDENTITY_STEP = 1e-3  # a step that moves the latents by less is the identity


# ---------------------------------------------------------------------------
# images and masks
# ---------------------------------------------------------------------------

def load_square(path: str, size: int) -> np.ndarray:
    """Centre crop to a square, resize to size² (PIL's default filter), RGB."""
    img = np.array(Image.open(path))[:, :, :3]
    h, w, _ = img.shape
    if h < w:
        img = img[:, (w - h) // 2: (w - h) // 2 + h]
    elif w < h:
        img = img[(h - w) // 2: (h - w) // 2 + w]
    if img.shape[:2] != (size, size):
        img = np.array(Image.fromarray(img).resize((size, size)))
    return img


def load_bilinear(path: str, size: int) -> np.ndarray:
    """Resized bilinear without a crop (Blended Latent Diffusion's loading)."""
    return np.array(Image.open(path).resize((size, size), Image.BILINEAR))[:, :, :3]


def as_saved(panel: np.ndarray, ext: str) -> np.ndarray:
    """The panel after a round trip through the strip's file format (PIL's
    defaults: JPEG at quality 75; PNG lossless). A panel is 512 wide, a whole
    number of JPEG blocks, so it compresses alone as it does in a strip."""
    if ext.lower() == ".png":
        return panel
    buf = io.BytesIO()
    Image.fromarray(panel).save(buf, format="JPEG")
    return np.array(Image.open(io.BytesIO(buf.getvalue())))


def strip_panels(path: str, size: int) -> List[np.ndarray]:
    strip = np.array(Image.open(path).convert("RGB"))
    return [strip[:, i * size:(i + 1) * size] for i in range(strip.shape[1] // size)]


def rle_mask(rle: Sequence[int], shape=(512, 512)) -> np.ndarray:
    """PIE-Bench's run-length mask, its boundary rows and columns set."""
    flat = np.zeros(shape[0] * shape[1], np.uint8)
    for start, run in np.asarray(rle, np.int64).reshape(-1, 2):
        flat[start: start + run] = 1
    m = flat.reshape(shape)
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = 1
    return m


def latent_mask(rle, latent: int) -> np.ndarray:
    small = Image.fromarray(rle_mask(rle)).resize((latent, latent), Image.NEAREST)
    return (np.array(small) >= 1).astype(np.float32)


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

class Reference:
    """The reference networks, tokenizer and schedule of one configuration."""

    def __init__(self, models: dict, tokenizer: T.Tokenizer, schedule: D.Schedule,
                 image_size: int, device):
        self.unet, self.vae, self.text = models["unet"], models["vae"], models["text"]
        self.tok, self.sched, self.size, self.device = tokenizer, schedule, image_size, device

    def embed(self, prompts: Sequence[str]) -> torch.Tensor:
        return self.text(torch.as_tensor(self.tok.ids(prompts), device=self.device))

    def encode(self, images: np.ndarray) -> torch.Tensor:
        return self.vae.encode(torch.as_tensor(images, device=self.device))


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).float()


def rows_of(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.view((n, x.shape[0] // n) + x.shape[1:])


def saved(images, ext: str) -> np.ndarray:
    return np.stack([as_saved(im, ext) for im in np.asarray(images)])


def vae_side(ref: Reference, vae: dict, images: np.ndarray, ext: str) -> dict:
    """The reference's encoding of the images and its decode of the
    program's decoder input: z, dec (float), the decoded panels (uint8, saved)."""
    from perfbench.reference.models import to_uint8

    dec = ref.vae.decode_float(vae["dec_in"].float() * ref.vae.scaling)
    return {"z": ref.encode(images), "dec": dec,
            "decoded": saved(to_uint8(dec).cpu().numpy(), ext)}


def program_vae(vae: dict, scaling: float) -> dict:
    return {"z": vae["enc"].float()[:, :4] * scaling, "dec": vae["dec_out"].float()}


def decoded_u8(dec_out: torch.Tensor) -> np.ndarray:
    """The program's decoder output as its own conversion makes the panels:
    ``to_uint8`` in the output's dtype, on its device (bit for bit the
    program's ``latent_to_image``)."""
    from perfbench.reference.models import to_uint8

    return to_uint8(dec_out).cpu().numpy()


def program_panels(strips: List[str], size: int, expected: List[np.ndarray], ext: str) -> dict:
    """The panels after the text of the strips the program wrote, and what
    each should hold once saved: ``expected`` (one (N, H, W, 3) uint8 array a
    panel, from the loaded images and the program's own decoder output)."""
    panels = [strip_panels(p, size) for p in strips]
    return {"panels": [np.stack([p[k] for p in panels]) for k in range(1, len(expected) + 1)],
            "strip_expected": [saved(e, ext) for e in expected]}


# ---------------------------------------------------------------------------
# the numbers
# ---------------------------------------------------------------------------

def _sq(a: torch.Tensor) -> np.ndarray:
    """Per leading index: the sum of squares."""
    return a.float().flatten(1).pow(2).sum(1).cpu().numpy().astype(np.float64)


def _rel(a: torch.Tensor, b: torch.Tensor, base: torch.Tensor) -> np.ndarray:
    """Per leading index: ||a - b|| / ||base||."""
    return np.sqrt(_sq(a - b.float()) / np.maximum(_sq(base), 1e-60))


def _resolve(ref_next: tuple, cand: torch.Tensor) -> torch.Tensor:
    """The reference's next latents; for (src, stepped, keep, ambiguous) the
    target row's ambiguous pixels take whichever side lies nearer ``cand``'s
    target row, and the rows come back as (N, 2, C, h, w)."""
    if len(ref_next) == 1:
        return ref_next[0]
    src, stepped, keep, amb = ref_next
    if amb is not None:
        c = cand[:, 1]
        near = ((c - stepped).abs().sum(1, keepdim=True)
                < (c - src).abs().sum(1, keepdim=True)).float()
        keep = torch.where(amb, near, keep)
    return torch.stack([src, src + keep * (stepped - src)], 1)


def _own(r: tuple) -> torch.Tensor:
    """Next latents with the step's own LocalBlend mask: (N, rows, C, h, w)."""
    if len(r) == 1:
        return r[0]
    src, stepped, keep, _ = r
    return torch.stack([src, src + keep * (stepped - src)], 1)


def own_next(outputs: dict) -> list:
    """Each step on the outputs' own noise, kept at the precision's storage."""
    from perfbench.reference.models import store

    return [store(_own(fn(outputs["eps"][ci] if ci is not None else None)))
            for ci, fn, _ in outputs["steps"]]


def _steps(cand: dict, ref: dict):
    """Per step and image: (|c - r|^2, |r - cur|^2), where r is the
    reference's step taken on the candidate's own noise; identity steps
    dropped."""
    out = []
    for (ci, fn, cur), c in zip(ref["steps"], cand["next"]):
        if c is None:
            continue
        c = c.float()
        r = _resolve(fn(cand["eps"][ci] if ci is not None else None), c)
        base = r if cur is None else r - cur
        moved = _rel(base, torch.zeros_like(base), r) > IDENTITY_STEP
        out.append((np.where(moved, _sq(c - r), 0.0), np.where(moved, _sq(base), 0.0)))
    return out


def _blocks(panels: np.ndarray) -> np.ndarray:
    """8x8 block means of (N, H, W, 3) panels, the columns of the margin left out."""
    m = PANEL_MARGIN
    p = panels[:, :, m:-m].astype(np.float64)
    n, h, w, ch = p.shape
    return p[:, : h // 8 * 8, : w // 8 * 8].reshape(n, h // 8, 8, w // 8, 8, ch).mean(axis=(2, 4))


def numbers(cand: dict, ref: dict, real: int) -> Dict[str, float]:
    """The compared numbers of a candidate against the reference: over every
    row the chunk computed (its padding too), the panels over its ``real``
    images; for the program, ``strip_err`` too: the largest difference in
    levels between a panel it wrote and the same panel made from its own
    decoder output and saved alone (the margin's columns left out), which is
    0 unless the strip was written wrong."""
    eps = max(float(_rel(c, r, r).max()) for c, r in zip(cand["eps"], ref["eps"]))
    steps = _steps(cand, ref)
    err, size = sum(e for e, _ in steps), sum(b for _, b in steps)
    out = {"eps_rel": eps, "step_rel": float(np.sqrt(err / size).max()),
           "encode_rel": float(_rel(cand["z"], ref["z"], ref["z"]).max()),
           "decode_rel": float(_rel(cand["dec"], ref["dec"], ref["dec"]).max()),
           "panel_mae": max(float(np.abs(_blocks(c[:real]) - _blocks(r[:real]))
                                  .mean(axis=(1, 2, 3)).max())
                            for c, r in zip(cand["panels"], ref["panels"]))}
    if "strip_expected" in cand:
        m = PANEL_MARGIN
        out["strip_err"] = max(
            int(np.abs(c[:real, :, m:-m].astype(np.int16) - e[:real, :, m:-m]).max())
            for c, e in zip(cand["panels"], cand["strip_expected"]))
    return out
