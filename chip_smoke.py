"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (python3 chip_smoke.py).

Phases, each of which raises on failure (the script then exits non-zero):
1. the card's name and power limit, torch/CUDA versions, TF32 flags;
2. build every CUDA kernel of the port from the sources in this checkout (one
   nvcc per source, all started together: the bf16 forward, the bf16
   backward, the f32 backward, the f32 forward), print ptxas' registers and
   spills per kernel, and fail on a spill or a wgmma that ptxas serialised;
3. hold each kernel against its plain PyTorch version at every shape the
   paths give it (and a few more), and time kernel, plain version and the
   PyTorch library call that computes the same function, with CUDA events
   around calls queued behind a spin kernel, so no host time is counted: the
   bf16 flash forward, then the bf16 backward's three kernels (prep, main,
   dQ convert) and the whole backward, then the f32 forward (its split pass
   bit for bit against its plain version, the forward repeated bit for bit,
   a row independent of the batch and of the rows per CTA) and the f32
   backward's dQ and dK/dV kernels (3xTF32, each after its own split pass:
   both split passes bit for bit against their plain versions, the backward
   repeated bit for bit, a row independent of the batch and of the rows per
   CTA; TF32 off on both sides);
4. drive the first path: ``P2PEditor("directinversion+p2p", ...)`` on an
   SD1.4 pipeline at full width (random weights from a seed, bf16, 512², 50
   DDIM steps), a warm-up edit, a timed edit whose kernel launches are
   counted, and a per-phase timed edit whose latents are checked;
5. drive the batched path: ``BatchedDirectInversionP2P.edit_batch`` on 4
   images (the same workload, the cake prompts), a warm-up batch and a timed
   batch whose launches are counted, then each image through the
   single-image editor and the uint8 difference of the two paths' panels,
   and the checks that tell a fault of the batched path from the numerics
   of another batch size (the reconstructions are the VAE round trip; with
   a prompt pair per image, the images do not interact);
6. drive null-text-inversion+p2p: a warm-up edit at 2 DDIM steps, then one
   edit at 10 whose launches of every kernel are counted and whose phases
   are timed to a synchronize each; the backward kernels run in its inner
   Adam loop, which differentiates through the UNet; then one counted
   ``ddim+p2p`` edit;
7. one counted edit of each other P2P-family method group through
   ``P2PEditor`` at 5 DDIM steps (negative-prompt inversion, ProxEdit,
   the null-text and null-latent ablations, the guidance grid, the
   DirectInversion ablations), the batched class on 2 images at 3 steps for
   one method of each group (a prompt pair per image), and batched
   null-text's per-image early stop (two images, one of which stops early);
   then the MasaCtrl, PnP and edit-friendly DDPM families: one counted edit
   each of ``directinversion+masactrl``, ``directinversion+pnp`` and
   ``edit-friendly-inversion+p2p`` at 20 steps (timed per phase), their
   batched classes on 4 images at 20 steps, each image against the
   single-image editor, images kept in place unmoved when the others
   change, ``ddim+masactrl`` and ``ddim+pnp`` at 5 steps, and one UNet call
   under each other MasaCtrl control (union, masks, auto masks); EF's UNet
   computes in f32 (the bf16 pipeline's layers cast their weights to its
   f32 latents), so its runs launch only the f32 forward; then EDICT, in
   f32 the same way: the cost of that per-call cast against an f32 copy of
   the UNet, one counted ``edict+p2p`` edit at 20 steps with the float64
   carry (timed per pass), the f32 attention's share of an edit from a
   device trace (5 steps), ``edict+direct_forward`` at 5 with the f32
   carry, ``BatchedEDICT`` on 4 images at 3 for both methods (each image
   within 2 uint8 levels of the editor's), and the strength-1.0 round trip
   in both precisions, which fails unless the float64 carry's MSE is below
   the f32 one's by 10x; then pix2pix-zero: the BLIP captioner at full
   width (ViT-B/16 at 384^2, the BERT-base decoder, 3 beams, a generated
   vocab) captions 4 images (timed; one decoder step and the vision tokens
   against a CPU copy), one counted edit of each method at 5 steps with the
   caption injected (the map-loss gradient runs the bf16 backward at all ten
   flash sites) and ``BatchedPix2PixZero`` on the 4 images; StyleDiffusion:
   one counted ``stylediffusion+p2p`` edit at 3 steps and 3 inner steps (its
   training runs the backward at nine sites) and ``BatchedStyleDiffusion``
   on the 4 images; then, the SD1.4 pipeline freed, Blended Latent Diffusion
   on its own SD2.1 pipeline (64-dim heads): one counted 20-step edit and
   ``BatchedBLD`` on 4 images, images kept in place unmoved when the others
   change;
8. the f32 pipeline (``SDPipeline.create(..., dtype=torch.float32)``, full
   f32): one counted directinversion+p2p edit and one counted
   null-text-inversion+p2p edit, which launch only the f32 kernels, a device
   trace of the f32 null-text edit (the f32 backward's share), and
   one UNet call with TF32 on against full f32; then InstructPix2Pix and
   InstructDiffusion on an IP2P pipeline (the 8-channel UNet, bf16, its UNet
   in f32): one counted edit each at 20 steps and ``BatchedInstruct`` on 4
   images at 20 (each edit within 2 uint8 levels of the editor's); then
   the InstructPix2Pix training path on its own SD1.4 pipeline: a prompt
   dataset of 2 template records, 4 candidate pairs each at 512^2 (one
   sampler call of 16 rows, P2P self-attention sharing, the full-width CLIP
   filter), the seeds.json dataset at 256^2 crops, and ``EditTrainer`` on
   the pipeline's UNet widened to 8 channels (bf16 over f32 masters, batch
   8, accumulation 2): 3 counted optimizer steps, which run the bf16
   forward and backward at the 32^2 sites of d = 40, a save, the next step
   against itself with remat and after a restore, a validation step; then
   the port's own entry points on local weights (``entry_points_phase``):
   an f16 SD1.4 HF directory written with the port's safetensors writer
   (the VAE under the older attention names, a generated CLIP BPE
   vocabulary) and a 4-image mini PIE-Bench, the weight-checking CLI on it,
   ``runners.run_editing_p2p`` (f32, 2 images at ``ENTRY_STEPS``: weights
   bit for bit, load seconds and GB/s, strips equal to ``P2PEditor``'s, a
   rerun that skips) and ``runners.run_sweep`` (bf16, x4: strips equal to
   ``BatchedDirectInversionP2P``'s), launches counted, and a TINY 8-channel
   CompVis ``.ckpt`` loaded bit for bit; then, on the same SD1.4 directory,
   several processes (``multi_process_phase``): two ranks on the one card,
   joined by gloo, run ``runners.run_sweep_sharded`` over an 8-image mini
   PIE-Bench (x4 a rank, bf16; every strip written once, each rank's strips
   byte for byte those of a one-process run over its slice, one of which is
   a group of one on NCCL; the totals reduced; a rerun that edits nothing),
   the training runner with ZeRO (2 steps of a global batch of 16 x 2 at
   256^2, 8 rows a rank; against one process on the same 32 rows a step as
   batch 8 x 4, loss, grad norm and state; the ranks' checkpoint resumed at
   one process) and one step without ZeRO, each rank's launches counted and
   its peak memory both ways; then the weight-only int8 UNet
   (``w8_phase``): ``runners.run_sweep --quant w8`` x4 on that directory
   and the x1 edit float then w8 at 50 steps (s, peak memory, weight bytes,
   one UNet call's eps against float); then the tensor-parallel axis
   (``tp_phase``): two more ranks on the card, one tp group over gloo,
   started early, run ``run_sweep_sharded --tp 2`` over 2 images (every
   strip written once, each image counted once), one UNet call in bf16 and
   f32 and a training step of 8 rows split over the group, each against one
   process beside them (the f32 eps within 1e-4; the bf16 eps, the panels
   and the loss within twice one process's own bf16 spread); every shape
   that these paths launched a kernel at, in either dtype, must be one that
   phase 3 held against the plain version;
9. the PIE-Bench evaluator at full width (CLIP ViT-L/14, DINO ViT-B/8,
   SqueezeNet LPIPS, random weights, f32) over the batched path's strips,
   written in the runners' layout with a synthetic mapping file: the CSV's
   checks, and the first row against the same calculator on the host CPU;
   then ``evaluate(sharded=True)`` with the four items in one batch (one
   forward of each metric model over the batch), its CSV within 1e-3 of the
   serial one, seconds per image both ways;
10. print one JSON line of kernel numbers (launches of each kernel on every
   path), each phase's seconds, the script's total seconds, then the result
   line.

It imports nothing of JAX and nothing of the JAX package. Without CUDA it
exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3

# (name, B, H, Sq, Sk, D, strided, timed): edges of the forward's tiling, Sq
# and Sk not multiples of 128 (64- and 128-row tiles), the smallest and
# largest head dims, a long cross shape
EDGE_CASES = [
    ("ragged_1000_d80", 1, 8, 1000, 1000, 80, True, False),
    ("ragged_1000_d80_b4", 4, 8, 1000, 1000, 80, True, False),
    ("d128_s1024", 1, 8, 1024, 1024, 128, False, False),
    ("d16_s1024", 2, 8, 1024, 1024, 16, False, False),
    ("cross_4096x77", 1, 8, 4096, 77, 40, True, False),
]
# (name, B, H, Sq, Sk, D, strided, timed): strided inputs are heads split from
# a (B, S, H*D) tensor, as the UNet's attention sites make them ("q": q
# only). B: 3 rows in the fused DirectInversion scan, 1 in inversion and
# null-text's inner loop, 2 and 4 in the CFG reconstruction and edit of
# null-text+p2p and ddim+p2p
FLASH_CASES = [
    ("scan_64x64", 3, 8, 4096, 4096, 40, True, True),
    ("scan_32x32", 3, 8, 1024, 1024, 80, True, True),
    ("invert_64x64", 1, 8, 4096, 4096, 40, True, True),
    ("invert_32x32", 1, 8, 1024, 1024, 80, True, True),
    ("recon_64x64", 2, 8, 4096, 4096, 40, True, True),
    ("recon_32x32", 2, 8, 1024, 1024, 80, True, True),
    ("edit_64x64", 4, 8, 4096, 4096, 40, True, True),
    ("edit_32x32", 4, 8, 1024, 1024, 80, True, True),
    ("d64_s1024", 1, 8, 1024, 1024, 64, False, False),
    ("ragged_cross", 1, 8, 1000, 77, 40, False, False),
    # the batched editor at 4 images: 3 rows each in the DirectInversion
    # scan (B.H 96), 4 in the CFG loops of ddim+p2p, negative-prompt and
    # null-text (B.H 128)
    ("batch4_scan_64x64", 12, 8, 4096, 4096, 40, True, True),
    ("batch4_scan_32x32", 12, 8, 1024, 1024, 80, True, True),
    ("batch4_cfg_64x64", 16, 8, 4096, 4096, 40, True, True),
    ("batch4_cfg_32x32", 16, 8, 1024, 1024, 80, True, True),
    # the batched class at 2 images (the other method groups): 3 rows each
    # in the DirectInversion scans (B.H 48), 4 in the CFG loops (B.H 64)
    ("batch2_scan_64x64", 6, 8, 4096, 4096, 40, True, True),
    ("batch2_scan_32x32", 6, 8, 1024, 1024, 80, True, True),
    ("batch2_cfg_64x64", 8, 8, 4096, 4096, 40, True, True),
    ("batch2_cfg_32x32", 8, 8, 1024, 1024, 80, True, True),
    # MasaCtrl's union at 4 rows: each row attends to its half's source K/V
    # and its own, concatenated (Sk = 2 Sq); q strided, k/v contiguous ("q")
    ("union_64x64", 4, 8, 4096, 8192, 40, "q", True),
    ("union_32x32", 4, 8, 1024, 2048, 80, "q", True),
    # SD2.1 (Blended Latent Diffusion): 64-dim heads, 5 at 64^2 and 10 at
    # 32^2; 2 rows an image, 8 at 4 images
    ("sd21_64x64", 2, 5, 4096, 4096, 64, True, True),
    ("sd21_32x32", 2, 10, 1024, 1024, 64, True, True),
    ("sd21_batch4_64x64", 8, 5, 4096, 4096, 64, True, True),
    ("sd21_batch4_32x32", 8, 10, 1024, 1024, 64, True, True),
    # InstructPix2Pix training at 256^2 crops: the 32^2 sites of
    # down_blocks[0]/up_blocks[3] (8 heads of d = 40) at batch 8 (the smoke's)
    # and 32 (the runner's default)
    ("train_b8_32x32", 8, 8, 1024, 1024, 40, True, True),
    ("train_b32_32x32", 32, 8, 1024, 1024, 40, True, True),
] + EDGE_CASES
# the f32 paths: the f32 pipeline (SDPipeline.create(..., dtype=torch.float32))
# on one image, 1 row in inversion and null-text's inner loop, 3 in the
# DirectInversion scan, 2 and 4 in null-text+p2p's reconstruction and edit;
# the f32 families of a bf16 pipeline (its f32 UNet): EDICT 2 rows and 3 under
# its takeover, EF 2 and 4, the instruction editors 3; at 4 images through
# the batched classes 8, 12 and 16 rows (B.H 64, 96, 128)
F32_FLASH_CASES = [
    (f"f32_rows{b}_{size}", b, 8, s, s, d, True, True)
    for b in (1, 2, 3, 4, 8, 12, 16) for size, s, d in (("64x64", 4096, 40), ("32x32", 1024, 80))
] + [
    # the weight-checking CLI's forward smoke (python -m
    # pnpinversion_tpu_torch.convert) runs the f32 UNet on a 32^2 latent: its
    # first level's sites are 1024 tokens of d = 40
    ("f32_convert_smoke_32x32_d40", 1, 8, 1024, 1024, 40, True, False),
    # tp_phase's f32 loss of the training step's 8 rows at 256^2 (one
    # process's bf16 spread): the 32^2 sites of d = 40
    ("f32_train_b8_32x32_d40", 8, 8, 1024, 1024, 40, True, False),
] + EDGE_CASES
# (..., dtype): every case names the kernel family it checks
FLASH_CASES = ([c + ("bf16",) for c in FLASH_CASES]
               + [c + ("f32",) for c in F32_FLASH_CASES])
FLASH_O_TOL = 1e-2      # |v| ~ N(0,1): O is a convex mix of v; bf16 rounding of O and P
FLASH_LSE_RTOL = 1e-3   # f32 statistics on both sides
EXPECTED_FLASH_LAUNCHES = 1000  # 10 sites x (50 inversion + 50 scan) UNet calls
FLASH_SITES = 10  # 64^2 and 32^2 self-attention sites per SD1.4 UNet call
# sites whose backward runs in null-text's inner loop: all but the first,
# whose input comes before any cross-attention and so does not depend on the
# uncond embedding
BWD_SITES = FLASH_SITES - 1

# (name, B, H, Sq, Sk, D, strided, timed): the null-text inner loop's shapes
# (one UNet row), d=64, a ragged cross-shaped case and the forward's edge
# cases (d = 16/128, ragged 1000^2 at 1 and 4 rows, 4096x77), whose O and LSE
# the backward kernels read
FLASH_BWD_CASES = [
    ("nulltext_64x64", 1, 8, 4096, 4096, 40, True, True),
    ("nulltext_32x32", 1, 8, 1024, 1024, 80, True, True),
    ("d64_s1024", 1, 8, 1024, 1024, 64, False, False),
    ("ragged_cross", 1, 8, 1000, 77, 40, False, False),
    # batched null-text's inner loop at 2, 4 and 8 images (B.H 16, 32, 64)
    ("nulltext_b2_64x64", 2, 8, 4096, 4096, 40, True, True),
    ("nulltext_b2_32x32", 2, 8, 1024, 1024, 80, True, True),
    ("nulltext_b4_64x64", 4, 8, 4096, 4096, 40, True, True),
    ("nulltext_b4_32x32", 4, 8, 1024, 1024, 80, True, True),
    ("nulltext_b8_64x64", 8, 8, 4096, 4096, 40, True, True),
    # pix2pix-zero's batched class at 4 images differentiates 8 rows
    ("p2z_b4_32x32", 8, 8, 1024, 1024, 80, True, True),
    # InstructPix2Pix training differentiates its 32^2 sites (d = 40) at
    # batch 8 (the smoke's) and 32 (the runner's default)
    ("train_b8_32x32", 8, 8, 1024, 1024, 40, True, True),
    ("train_b32_32x32", 32, 8, 1024, 1024, 40, True, True),
] + EDGE_CASES
# the f32 null-text inner loop (one UNet row) and the edge cases
F32_FLASH_BWD_CASES = [
    ("f32_nulltext_64x64", 1, 8, 4096, 4096, 40, True, True),
    ("f32_nulltext_32x32", 1, 8, 1024, 1024, 80, True, True),
    ("d64_s1024", 1, 8, 1024, 1024, 64, False, False),
    ("ragged_cross", 1, 8, 1000, 77, 40, False, False),
] + EDGE_CASES
FLASH_BWD_CASES = ([c + ("bf16",) for c in FLASH_BWD_CASES]
                   + [c + ("f32",) for c in F32_FLASH_BWD_CASES])
# relative to max |plain|: P and dS are rounded to bf16 before their products
# (as the TPU kernels round them) and dQ/dK/dV are stored in bf16
FLASH_BWD_RTOL = 2e-2
FLASH_DELTA_RTOL = 1e-3  # f32 sums over d on both sides, in another order
# the f32 kernels against their plain versions, TF32 off on both sides: f32
# sums over Sk (or Sq) terms in another order than cuBLAS', so a few f32 ulps
# of the largest value; O and dQ/dK/dV relative to max |plain|, LSE absolute
# (|LSE| ~ 8: one ulp is 1e-6)
F32_O_RTOL = 2e-5
F32_LSE_ATOL = 1e-5
F32_BWD_RTOL = 1e-4
H100_F32_FLOPS = 67e12    # FP32 on the CUDA cores, SXM, 700 W
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak (the f32 kernels' 3xTF32 products)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def _event_pair():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def time_interleaved(fns: dict, reps: int = 20, warmup: int = 3,
                     min_sample_ms: float = 1.0) -> dict:
    """Median CUDA-event milliseconds per call of each callable, run in turns
    (under its own name), with the spread of its samples (``<name>_spread``,
    max - min) and the host's microseconds to issue one call
    (``<name>_host_us``, median, taken while the device was busy).

    Each sample times back-to-back calls (as many as make ``min_sample_ms``
    of device work, at most 50) queued behind a spin kernel that lasts longer
    than the host takes to issue them, so the events time the device's work
    alone, never the host's cost of issuing a call. A sample whose queue ran
    dry (the device reached its start event before the host had issued every
    call) is taken again behind a spin twice as long."""
    e0, e1 = _event_pair()
    e0.record()
    torch.cuda._sleep(1_000_000)
    e1.record()
    e1.synchronize()
    cycles_per_ms = 1_000_000 / e0.elapsed_time(e1)
    inner, host_ms = {}, {}
    for name, fn in fns.items():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        host_ms[name] = (time.perf_counter() - t0) * 1e3
        e1.synchronize()
        inner[name] = max(1, min(50, int(np.ceil(min_sample_ms / e0.elapsed_time(e1)))))
    times = {k: [] for k in fns}
    issue_ms = {k: [] for k in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            spin_ms = 1.0 + 2.0 * inner[name] * host_ms[name]
            for _ in range(8):
                torch.cuda._sleep(int(spin_ms * cycles_per_ms))
                e0.record()
                t0 = time.perf_counter()
                for _ in range(inner[name]):
                    fn()
                issue_ms[name].append((time.perf_counter() - t0) * 1e3 / inner[name])
                e1.record()
                ran_dry = e0.query()
                e1.synchronize()
                if not ran_dry:
                    break
                spin_ms *= 2
            else:
                raise RuntimeError(f"timing {name}: the host could not keep the queue full")
            times[name].append(e0.elapsed_time(e1) / inner[name])
    out = {k: statistics.median(v) for k, v in times.items()}
    out.update({f"{k}_spread": max(v) - min(v) for k, v in times.items()})
    out.update({f"{k}_host_us": 1e3 * statistics.median(v) for k, v in issue_ms.items()})
    return out


def bound_ms(flops: float, nbytes: float) -> tuple:
    """The least time for the work on the card: the larger of operations
    over the bf16 tensor-core peak and bytes over the HBM rate."""
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound_ms(b, h, sq, sk, d) -> tuple:
    return bound_ms(4.0 * b * h * sq * sk * d,
                    2.0 * b * h * (2 * sq * d + 2 * sk * d) + 4.0 * b * h * sq)


def flash_bwd_bounds(b, h, sq, sk, d) -> dict:
    """Bounds of the backward's kernels: prep (reads O, dO, LSE; writes the
    stats and the zeroed f32 dQ accumulator), main (FA2's 5 products; reads
    q, k, v, dO and the stats, writes dK, dV and the f32 dQ accumulator once),
    dQ convert (reads the accumulator, writes dQ) and the whole backward.
    The main kernel also takes Sq*Sk exp2 on the SFUs, which these bounds
    leave out."""
    bh, mn = b * h, b * h * sq * sk * d
    q_bytes, kv_bytes = 2.0 * bh * sq * d, 2.0 * bh * sk * d
    sq_pad = -(-sq // 64) * 64
    stats_bytes, acc_bytes = 8.0 * bh * sq_pad, 4.0 * bh * sq_pad * d
    return {"prep": bound_ms(2.0 * bh * sq * d, 2 * q_bytes + 4.0 * bh * sq + stats_bytes
                             + acc_bytes),
            "main": bound_ms(10.0 * mn, 2 * q_bytes + 2 * kv_bytes + stats_bytes
                             + 2 * kv_bytes + acc_bytes),
            "convert": bound_ms(0.0, 4.0 * bh * sq * d + q_bytes),
            "bwd": bound_ms(10.0 * mn, 3 * q_bytes + 2 * kv_bytes + 4.0 * bh * sq
                            + q_bytes + 2 * kv_bytes)}


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel: name<template args>, registers, stack
    frame, spills, static shared memory; then ptxas' warnings and its notes
    of lost performance (e.g. wgmma serialised)."""
    lines, warnings, name = [], [], None
    for line in log.splitlines():
        # the kernel's own name follows its length in the mangled name, after
        # the anonymous namespace's (which also holds "flash_")
        m = re.search(r"Compiling entry function '\S*?(?<=\d)(flash_[a-z0-9_]+?_kernel)"
                      r"(?:I((?:Li\d+E)+)E)?", line)
        if m:
            args = ",".join(re.findall(r"Li(\d+)E", m.group(2) or ""))
            name, spills = m.group(1) + (f"<{args}>" if args else ""), ""
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spills = (f"stack frame {m.group(1)} B, spill stores {m.group(2)} B, "
                      f"loads {m.group(3)} B")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{name}: {m.group(1)} registers, {spills}, static smem "
                         f"{smem.group(1) if smem else 0} B")
            name = None
        if "warning" in line.lower() or "performance loss" in line.lower():
            warnings.append(line.strip())
    return lines + warnings


def _heads(gen, b, h, s, d, strided, dtype=torch.bfloat16) -> torch.Tensor:
    """Random (B, H, S, D) of ``dtype`` on the card; strided: heads split from
    a (B, S, H*D) tensor, as the UNet's attention sites make them."""
    if strided:
        x = torch.randn((b, s, h * d), generator=gen, device="cuda")
        return x.to(dtype).view(b, s, h, d).transpose(1, 2)
    return torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)


def kernel_phase(timing: bool = True) -> dict:
    """Kernel vs plain version at every case; times at the timed cases (none
    with ``timing=False``). Each row names the forward's tile (query rows per
    CTA) and its dynamic shared memory."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, worst = [], 0.0
    for name, b, h, sq, sk, d, strided, timed, dtype in FLASH_CASES:
        if dtype != "bf16":
            continue
        timed = timed and timing
        def make(s, split):
            return _heads(gen, b, h, s, d, split)

        q, k, v = make(sq, bool(strided)), make(sk, strided is True), make(sk, strided is True)
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = ((lse - lse_ref).abs() / lse_ref.abs().clamp_min(1.0)).max().item()
        ok = err_o <= FLASH_O_TOL and err_lse <= FLASH_LSE_RTOL
        tile = fa.fwd_tile_rows(b * h, sq, sms)
        row = {"case": name, "shape": [b, h, sq, sk, d], "tile_rows": tile,
               "smem_bytes": fa.fwd_smem_bytes(tile, d), "max_abs_err_o": err_o,
               "max_rel_err_lse": err_lse, "ok": ok}
        if timed:
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            ms = time_interleaved({
                "ms": lambda: fa.flash_attention_fwd(q, k, v, scale),
                "plain_ms": lambda: fa.flash_attention_reference(q, k, v, scale),
                "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                    qc, kc, vc, scale=scale),
            })
            bound, bound_by = flash_bound_ms(b, h, sq, sk, d)
            row.update(ms, bound_ms=bound, bound_by=bound_by)
        print("flash", json.dumps(row), flush=True)
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version: {row}")
        worst = max(worst, err_o)
        rows.append(row)
        del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": worst}


def bwd_kernel_phase(timing: bool = True) -> dict:
    """The backward's kernels vs their plain versions at every case: delta
    (from the prep kernel's stats) against its plain rowsum, dQ, dK and dV
    against the plain backward, the largest run-to-run difference of dQ
    (bulk reduce-adds in varying order) over three more runs, and dK/dV bit-identical
    between runs. Times at the timed cases (none with ``timing=False``):
    each kernel and its plain version, the whole backward as the Function
    runs it, the plain backward, and the backward of
    F.scaled_dot_product_attention on a graph built once (a yardstick only)."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, worst = [], {"delta": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0, "dq_run_to_run": 0.0}
    for name, b, h, sq, sk, d, strided, timed, dtype in FLASH_BWD_CASES:
        if dtype != "bf16":
            continue
        timed = timed and timing

        def make(s):
            return _heads(gen, b, h, s, d, strided)

        q, k, v, do = make(sq), make(sk), make(sk), make(sq)
        scale = d ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v, scale)
        stats, dq_acc = fa.flash_attention_bwd_prep(out, lse, do)
        dk, dv = fa.flash_attention_bwd_main(q, k, v, do, stats, dq_acc, scale)
        dq = fa.flash_attention_bwd_dq_convert(dq_acc, q, scale)
        again = [fa.flash_attention_bwd(q, k, v, out, lse, do, scale) for _ in range(3)]
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
        delta = fa.bwd_stats_rows(stats, sq)[1]
        delta_ref = (do.float() * out.float()).sum(-1).reshape(b * h, sq)
        tile = fa.bwd_tile_keys(b * h, sk, sms)
        row = {"case": name, "shape": [b, h, sq, sk, d], "tile_keys": tile,
               "smem_bytes": fa.bwd_smem_bytes(tile, d),
               "max_rel_err_delta": ((delta - delta_ref).abs()
                                     / delta_ref.abs().clamp_min(1.0)).max().item()}
        row["ok"] = row["max_rel_err_delta"] <= FLASH_DELTA_RTOL
        worst["delta"] = max(worst["delta"], row["max_rel_err_delta"])
        for key, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            row[f"max_abs_err_{key}"], row[f"rel_err_{key}"] = err, rel
            row["ok"] &= rel <= FLASH_BWD_RTOL
            worst[key] = max(worst[key], err)
        row["dq_run_to_run_max_abs"] = max(
            (g[0].float() - dq.float()).abs().max().item() for g in again)
        row["dq_run_to_run_rel"] = (row["dq_run_to_run_max_abs"]
                                    / want[0].float().abs().max().item())
        row["dkv_bit_identical"] = all(torch.equal(g[1], dk) and torch.equal(g[2], dv)
                                       for g in again)
        row["ok"] &= row["dkv_bit_identical"] and row["dq_run_to_run_rel"] <= FLASH_BWD_RTOL
        worst["dq_run_to_run"] = max(worst["dq_run_to_run"], row["dq_run_to_run_max_abs"])
        del again
        if timed:
            leaves = [x.detach().contiguous().requires_grad_(True) for x in (q, k, v)]
            lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=scale)
            dout = do.contiguous()
            scratch = dq_acc.clone()
            ms = time_interleaved({
                "prep_ms": lambda: fa.flash_attention_bwd_prep(out, lse, do),
                "main_ms": lambda: fa.flash_attention_bwd_main(q, k, v, do, stats, dq_acc, scale),
                "convert_ms": lambda: fa.flash_attention_bwd_dq_convert(dq_acc, q, scale),
                "bwd_ms": lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, scale),
                "plain_prep_ms": lambda: fa.flash_attention_bwd_prep_reference(out, lse, do),
                "plain_main_ms": lambda: fa.flash_attention_bwd_main_reference(
                    q, k, v, do, stats, scratch, scale),
                "plain_convert_ms": lambda: fa.flash_attention_bwd_dq_convert_reference(
                    dq_acc, q, scale),
                "plain_bwd_ms": lambda: fa.flash_attention_bwd_reference(
                    q, k, v, out, lse, do, scale),
                "library_bwd_ms": lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                              retain_graph=True),
            })
            bounds = flash_bwd_bounds(b, h, sq, sk, d)
            row.update(ms, **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
                       **{f"{k}_bound_by": v[1] for k, v in bounds.items()})
            del leaves, lib_out, scratch
        print("flash_bwd", json.dumps(row), flush=True)
        if not row["ok"]:
            raise AssertionError(f"flash backward kernels disagree with the plain version: {row}")
        rows.append(row)
        del q, k, v, do, out, lse, stats, dq_acc, dq, dk, dv, want
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": worst}


def _bound(flops: float, peak: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def f32_flash_bounds(b, h, sq, sk, d) -> dict:
    """Bounds of the f32 kernels, each run as 3xTF32 on the tensor cores: 3x
    the FLOPs of its products at the TF32 peak, or its bytes with the split
    copies (written by the split pass and read back), whichever is larger;
    beside each (``*_fp32``) its products alone at the CUDA cores' FP32 peak
    with the inputs' and outputs' bytes, the bound of an FMA kernel. The
    forward (``fwd``): QK^T and PV, 4 B*H*Sq*Sk*d; its split pass
    (``split``: K and V read, the hi and lo of K and V^T written). The
    backward: ``dq`` (QK^T, dO V^T, dS K: 6), ``dkv`` (QK^T, dO V^T, P^T dO,
    dS^T Q: 8), each with its own split pass (``bwd_split_dq``: K and V read,
    the hi and lo of K, V and K^T written; ``bwd_split_dkv``: Q, dO, LSE and
    delta read, the hi and lo of Q, dO, Q^T and dO^T and the tiles' LSE and
    delta written), and ``bwd``, the whole backward as one function (the
    plain backward's five products, 10; delta written and read). Bytes: each
    input read once, each output written once, 4 per element."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    bh, mn = b * h, b * h * sq * sk * d
    q_b, kv_b, stat_b = 4.0 * bh * sq * d, 4.0 * bh * sk * d, 4.0 * bh * sq

    def padded(s, t):
        return -(-s // t) * t

    kt, bkt, bqt = fa.fwd_f32_tile_keys(d), fa.bwd_f32_tile_keys(d), fa.bwd_f32_tile_queries(d)
    split_b = 16.0 * bh * padded(sk, kt) * d  # hi and lo of K and V^T
    split_dq_b = 24.0 * bh * padded(sk, bkt) * d  # hi and lo of K, V and K^T
    split_dkv_b = 32.0 * bh * padded(sq, bqt) * d + 8.0 * bh * padded(sq, bqt)
    out = {}
    for name, flops, peak, nbytes in (
            ("fwd", 12.0 * mn, H100_TF32_FLOPS, q_b + 2 * kv_b + 2 * split_b + q_b + stat_b),
            ("fwd_fp32", 4.0 * mn, H100_F32_FLOPS, q_b + 2 * kv_b + q_b + stat_b),
            ("split", 0.0, H100_TF32_FLOPS, 2 * kv_b + split_b),
            ("dq", 18.0 * mn, H100_TF32_FLOPS,
             2 * q_b + 2 * kv_b + 2 * stat_b + 2 * split_dq_b + q_b),
            ("dq_fp32", 6.0 * mn, H100_F32_FLOPS, 2 * q_b + 2 * kv_b + 2 * stat_b + q_b),
            ("dkv", 24.0 * mn, H100_TF32_FLOPS,
             2 * q_b + 2 * kv_b + 2 * stat_b + 2 * split_dkv_b + 2 * kv_b),
            ("dkv_fp32", 8.0 * mn, H100_F32_FLOPS, 2 * q_b + 2 * kv_b + 2 * stat_b + 2 * kv_b),
            ("bwd_split_dq", 0.0, H100_TF32_FLOPS, 2 * kv_b + split_dq_b),
            ("bwd_split_dkv", 0.0, H100_TF32_FLOPS, 2 * q_b + 2 * stat_b + split_dkv_b),
            ("bwd", 30.0 * mn, H100_TF32_FLOPS, 3 * q_b + 2 * kv_b + stat_b + q_b + 2 * kv_b
             + 2 * stat_b + 2 * (split_dq_b + split_dkv_b)),
            ("bwd_fp32", 10.0 * mn, H100_F32_FLOPS,
             3 * q_b + 2 * kv_b + stat_b + q_b + 2 * kv_b)):
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = _bound(flops, peak, nbytes)
    return out


def _rel(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _same(a: tuple, b: tuple) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def f32_batch_independence() -> list:
    """The f32 forward at 64^2 and 32^2: the heads of batch row 3 of a B*H 64
    call (8 rows) against a B*H 8 call on that row alone, O and LSE bit for
    bit (the grid and, at 64^2, nothing else differ), and a B*H 8 call at
    both tiles of query rows where d allows two. Fails on a difference."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for size, s, d in (("64x64", 4096, 40), ("32x32", 1024, 80)):
        q, k, v = (_heads(gen, 8, 8, s, d, True, torch.float32) for _ in range(3))
        scale = d ** -0.5
        big = fa.flash_attention_fwd(q, k, v, scale)
        one = [x[3:4] for x in (q, k, v)]
        small = fa.flash_attention_fwd(*one, scale)
        row = {"size": size, "tile_rows_bh64": fa.fwd_f32_tile_rows(64, s, d, sms),
               "tile_rows_bh8": fa.fwd_f32_tile_rows(8, s, d, sms),
               "row_of_bh64_equals_bh8": _same((big[0][3:4], big[1][3:4]), small)}
        row["ok"] = row["row_of_bh64_equals_bh8"]
        if d <= fa.F32_WIDE_TILE_MAX_D:  # both tiles of query rows exist
            rows64, rows128 = (fa._launch_fwd_f32(*one, scale, r) for r in (64, 128))
            row["rows64_equals_rows128"] = _same(rows64, rows128)
            row["ok"] &= row["rows64_equals_rows128"]
        print("flash_f32_batch_independence", json.dumps(row), flush=True)
        if not row["ok"]:
            raise AssertionError(f"the f32 forward's rows depend on the batch or the tile: {row}")
        out.append(row)
        del q, k, v, big, small, one
    return out


def f32_bwd_batch_independence() -> list:
    """The f32 backward at 64^2 and 32^2: batch row 1 of a B*H 16 call (2
    rows) against a B*H 8 call on that row alone (the same q, k, v, dO, O
    and LSE), dQ, dK and dV bit for bit, and the B*H 8 call's dQ and dK/dV
    at both tiles of rows per CTA where d allows two. Fails on a
    difference."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for size, s, d in (("64x64", 4096, 40), ("32x32", 1024, 80)):
        q, k, v, do = (_heads(gen, 2, 8, s, d, True, torch.float32) for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        big = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
        q1, k1, v1, o1, lse1, do1 = (x[1:2] for x in (q, k, v, o, lse, do))
        small = fa.flash_attention_bwd(q1, k1, v1, o1, lse1, do1, scale)
        row = {"size": size,
               "tile_rows_bh16": {kern: fa.bwd_f32_tile_rows(kern, 16, s, d, sms)
                                  for kern in ("dq", "dkv")},
               "tile_rows_bh8": {kern: fa.bwd_f32_tile_rows(kern, 8, s, d, sms)
                                 for kern in ("dq", "dkv")},
               "row_of_bh16_equals_bh8": _same(tuple(x[1:2] for x in big), small)}
        row["ok"] = row["row_of_bh16_equals_bh8"]
        delta = (do1 * o1).sum(-1).contiguous()
        for kern in ("dq", "dkv"):
            if d <= fa.F32_BWD_WIDE_TILE_MAX_D[kern]:  # both tiles of rows exist
                r64, r128 = (fa._launch_bwd_f32(q1, k1, v1, do1, lse1, delta, scale,
                                                kern == "dq", rows) for rows in (64, 128))
                same = torch.equal(r64, r128) if kern == "dq" else _same(r64, r128)
                row[f"{kern}_rows64_equals_rows128"] = same
                row["ok"] &= same
        print("flash_f32_bwd_batch_independence", json.dumps(row), flush=True)
        if not row["ok"]:
            raise AssertionError(f"the f32 backward's rows depend on the batch or the tile: {row}")
        out.append(row)
        del q, k, v, do, o, lse, big, small
    return out


def f32_kernel_phase(timing: bool = True) -> dict:
    """The f32 kernels (forward, dQ, dK/dV) vs their plain versions at every
    f32 case, TF32 off on both sides: O within ``F32_O_RTOL`` of max |plain|,
    LSE within ``F32_LSE_ATOL``, the forward's split pass bit for bit against
    its plain version, the forward repeated bit for bit, dQ/dK/dV within
    ``F32_BWD_RTOL`` of max |plain|, the backward's two split passes bit for
    bit against their plain versions, and the backward bit-identical run to
    run (no atomics); then ``f32_batch_independence`` and
    ``f32_bwd_batch_independence``. Each row names its tiles and the memory
    one call adds (the outputs and the split scratch). Times at the timed
    cases (none with ``timing=False``): each kernel (the forward whole, dQ
    and dK/dV each with its split pass, and the split passes alone), its
    plain version and f32 SDPA (forward, and backward on a graph built
    once), a yardstick only."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the f32 kernels' oracle runs with TF32 off")
    gen = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fwd_rows, bwd_rows = [], []
    worst = {"o": 0.0, "lse": 0.0, "split": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0,
             "bwd_split": 0.0}
    for name, b, h, sq, sk, d, strided, timed, dtype in FLASH_CASES:
        if dtype != "f32":
            continue
        timed = timed and timing
        q, k, v = (_heads(gen, b, h, s, d, strided, torch.float32) for s in (sq, sk, sk))
        scale = d ** -0.5
        split = fa.flash_attention_fwd_f32_split(k, v)
        split_ref = fa.flash_attention_fwd_f32_split_reference(k, v)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, scale)
        tile = fa.fwd_f32_tile_rows(b * h, sq, d, sms)
        row = {"case": name, "shape": [b, h, sq, sk, d], "tile_rows": tile,
               "tile_keys": fa.fwd_f32_tile_keys(d), "smem_bytes": fa.fwd_f32_smem_bytes(tile, d),
               "call_peak_mib": peak / 2**20, "rel_err_o": _rel(o, o_ref),
               "max_abs_err_o": (o - o_ref).abs().max().item(),
               "max_abs_err_lse": (lse - lse_ref).abs().max().item(),
               "repeat_bit_identical": _same(fa.flash_attention_fwd(q, k, v, scale), (o, lse)),
               "split_max_abs_err": (split - split_ref).abs().max().item(),
               "split_bit_identical": torch.equal(split, split_ref)}
        row["ok"] = (row["rel_err_o"] <= F32_O_RTOL and row["max_abs_err_lse"] <= F32_LSE_ATOL
                     and row["repeat_bit_identical"] and row["split_bit_identical"])
        worst["o"] = max(worst["o"], row["max_abs_err_o"])
        worst["lse"] = max(worst["lse"], row["max_abs_err_lse"])
        worst["split"] = max(worst["split"], row["split_max_abs_err"])
        del split, split_ref
        if timed:
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            row.update(time_interleaved({
                "ms": lambda: fa.flash_attention_fwd(q, k, v, scale),
                "split_ms": lambda: fa.flash_attention_fwd_f32_split(k, v),
                "plain_ms": lambda: fa.flash_attention_reference(q, k, v, scale),
                "split_plain_ms": lambda: fa.flash_attention_fwd_f32_split_reference(k, v),
                "library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(
                    qc, kc, vc, scale=scale)}))
            bounds = f32_flash_bounds(b, h, sq, sk, d)
            row.update(bound_ms=bounds["fwd_bound_ms"], bound_by=bounds["fwd_bound_by"],
                       fp32_bound_ms=bounds["fwd_fp32_bound_ms"],
                       split_bound_ms=bounds["split_bound_ms"],
                       split_share=row["split_ms"] / row["ms"],
                       over_library=row["ms"] / row["library_ms"],
                       share_of_bound=bounds["fwd_bound_ms"] / row["ms"])
        print("flash_f32", json.dumps(row), flush=True)
        if not row["ok"]:
            raise AssertionError(f"f32 flash kernel disagrees with its plain version: {row}")
        fwd_rows.append(row)
        del q, k, v, o, lse, o_ref, lse_ref
    independence = f32_batch_independence()
    for name, b, h, sq, sk, d, strided, timed, dtype in FLASH_BWD_CASES:
        if dtype != "f32":
            continue
        timed = timed and timing
        q, k, v, do = (_heads(gen, b, h, s, d, strided, torch.float32) for s in (sq, sk, sk, sq))
        scale = d ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v, scale)
        delta = (do * out).sum(-1).contiguous()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dq = fa.flash_attention_bwd_dq_f32(q, k, v, do, lse, delta, scale)
        dk, dv = fa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        again = [fa.flash_attention_bwd(q, k, v, out, lse, do, scale) for _ in range(2)]
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
        rows = {kern: fa.bwd_f32_tile_rows(kern, b * h, sq if kern == "dq" else sk, d, sms)
                for kern in ("dq", "dkv")}
        row = {"case": name, "shape": [b, h, sq, sk, d], "tile_rows": rows,
               "tile_keys": fa.bwd_f32_tile_keys(d), "tile_queries": fa.bwd_f32_tile_queries(d),
               "smem_bytes": {kern: fa.bwd_f32_smem_bytes(kern, r, d) for kern, r in rows.items()},
               "call_peak_mib": peak / 2**20, "ok": True}
        for key, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            row[f"max_abs_err_{key}"] = (got - ref).abs().max().item()
            row[f"rel_err_{key}"] = _rel(got, ref)
            row["ok"] &= row[f"rel_err_{key}"] <= F32_BWD_RTOL
            worst[key] = max(worst[key], row[f"max_abs_err_{key}"])
        row["bit_identical_run_to_run"] = all(
            torch.equal(x, y) for g in again for x, y in zip(g, (dq, dk, dv)))
        row["ok"] &= row["bit_identical_run_to_run"]
        del again
        for kern, args in (("dq", (k, v)), ("dkv", (q, do, lse, delta))):
            got = fa.flash_attention_bwd_f32_split(*args)
            ref = fa.flash_attention_bwd_f32_split_reference(*args)
            row[f"split_{kern}_bit_identical"] = torch.equal(got, ref)
            row["ok"] &= row[f"split_{kern}_bit_identical"]
            finite = torch.isfinite(ref)  # the LSE of queries past Sq is +inf on both sides
            err = (got[finite] - ref[finite]).abs().max().item()
            row[f"split_{kern}_max_abs_err"] = err
            worst["bwd_split"] = max(worst["bwd_split"], err)
            del got, ref
        if timed:
            leaves = [x.detach().contiguous().requires_grad_(True) for x in (q, k, v)]
            lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=scale)
            dout = do.contiguous()
            row.update(time_interleaved({
                "dq_ms": lambda: fa.flash_attention_bwd_dq_f32(q, k, v, do, lse, delta, scale),
                "dkv_ms": lambda: fa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta,
                                                                 scale),
                "split_dq_ms": lambda: fa.flash_attention_bwd_f32_split(k, v),
                "split_dkv_ms": lambda: fa.flash_attention_bwd_f32_split(q, do, lse, delta),
                "delta_ms": lambda: (do * out).sum(-1).contiguous(),
                "bwd_ms": lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, scale),
                "plain_dq_ms": lambda: fa.flash_attention_bwd_dq_reference(
                    q, k, v, do, lse, delta, scale),
                "plain_dkv_ms": lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, do, lse, delta, scale),
                "plain_split_dq_ms": lambda: fa.flash_attention_bwd_f32_split_reference(k, v),
                "plain_split_dkv_ms": lambda: fa.flash_attention_bwd_f32_split_reference(
                    q, do, lse, delta),
                "plain_bwd_ms": lambda: fa.flash_attention_bwd_reference(
                    q, k, v, out, lse, do, scale),
                "library_bwd_ms": lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                              retain_graph=True)}))
            bounds = f32_flash_bounds(b, h, sq, sk, d)
            row.update({k_: v_ for k_, v_ in bounds.items() if not k_.startswith(("fwd", "split"))})
            row.update(share_of_bound=bounds["bwd_bound_ms"] / row["bwd_ms"],
                       dq_share_of_bound=bounds["dq_bound_ms"] / row["dq_ms"],
                       dkv_share_of_bound=bounds["dkv_bound_ms"] / row["dkv_ms"],
                       split_share=(row["split_dq_ms"] + row["split_dkv_ms"]) / row["bwd_ms"],
                       over_library=row["bwd_ms"] / row["library_bwd_ms"])
            del leaves, lib_out
        print("flash_f32_bwd", json.dumps(row), flush=True)
        if not row["ok"]:
            raise AssertionError(f"f32 flash backward kernels disagree with the plain "
                                 f"version: {row}")
        bwd_rows.append(row)
        del q, k, v, do, out, lse, delta, dq, dk, dv, want
    bwd_independence = f32_bwd_batch_independence()
    torch.cuda.empty_cache()
    return {"fwd_rows": fwd_rows, "bwd_rows": bwd_rows, "max_abs_err": worst,
            "batch_independence": independence, "bwd_batch_independence": bwd_independence}


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


SRC = "a round cake with orange frosting on a wooden plate"
TAR = "a square cake with orange frosting on a wooden plate"
EDIT_KW = dict(guidance_scale=7.5, blend_word=(("cake",), ("cake",)),
               eq_params={"words": ("square",), "values": (2.0,)})
NULL_TEXT = "null-text-inversion+p2p"
# DDIM steps of the counted null-text edit: 25 since the MasaCtrl, PnP and
# EF families joined the script (its 500 inner steps at 50 took ~95 s), 10
# since the f32 null-text trace did (its 250 inner steps took 62-78 s); the
# shapes, and so the kernels' checks, do not depend on the steps
NULL_TEXT_STEPS = 10
NULL_TEXT_INNER = 10  # the reference's num_inner_steps, the editor's default


def _random_images(seed: int, size: int = 512):
    rng = np.random.RandomState(seed)
    return lambda: (rng.rand(size, size, 3) * 255).astype(np.uint8)


def _reset_counts() -> None:
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    for fn in (fa.flash_attention_fwd,) + fa.BWD_WRAPPERS + fa.F32_WRAPPERS:
        fn.launches = 0


def _counts() -> dict:
    """Launches of the bf16 kernels since ``_reset_counts``; the f32 kernels'
    are in ``_f32_counts``."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.flash_attention_fwd.launches,
            "prep": fa.flash_attention_bwd_prep.launches,
            "main": fa.flash_attention_bwd_main.launches,
            "convert": fa.flash_attention_bwd_dq_convert.launches}


def _f32_counts() -> dict:
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.flash_attention_fwd_f32.launches,
            "split": fa.flash_attention_fwd_f32_split.launches,
            "dq": fa.flash_attention_bwd_dq_f32.launches,
            "dkv": fa.flash_attention_bwd_dkv_f32.launches,
            "bwd_split": fa.flash_attention_bwd_f32_split.launches}


# (dtype, B, H, Sq, Sk, D) of every launch on the paths, by kernel: the
# forward and the backward (bf16: its main kernel, whose shapes prep and dQ
# convert share; f32: the dQ and dK/dV kernels, which share theirs)
PATH_SHAPES = {"fwd": set(), "bwd": set()}


def _record_path_shapes() -> None:
    """From here on, every launch of a forward or backward kernel records its
    dtype and shape in ``PATH_SHAPES``: the wrappers' launch functions,
    wrapped (the launch counts stay the wrappers' own). Called once the
    kernel phases are done, so only the paths' launches count."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    for key, name, dtype in (("fwd", "_launch_fwd", "bf16"), ("bwd", "_launch_bwd_main", "bf16"),
                             ("fwd", "_launch_fwd_f32", "f32"), ("bwd", "_launch_bwd_f32", "f32")):
        def logged(q, k, *args, _launch=getattr(fa, name), _key=key, _dtype=dtype):
            shape = (_dtype, *q.shape[:3], k.shape[2], q.shape[3])
            PATH_SHAPES[_key].add(shape)
            return _launch(q, k, *args)

        setattr(fa, name, logged)


def _check_path_shapes() -> dict:
    """Fails unless every shape a path launched a kernel at is one that the
    kernel phases held against the plain version; returns the shapes."""
    checked = {"fwd": {(c[8], *c[1:6]) for c in FLASH_CASES},
               "bwd": {(c[8], *c[1:6]) for c in FLASH_BWD_CASES}}
    missing = {k: sorted(PATH_SHAPES[k] - checked[k]) for k in PATH_SHAPES}
    if any(missing.values()):
        raise AssertionError(f"the paths launched kernels at shapes no case checked: {missing}")
    return {k: sorted(v) for k, v in PATH_SHAPES.items()}


def _check_strip(strip) -> None:
    if strip.shape != (512, 2048, 3) or strip.dtype != np.uint8:
        raise AssertionError(f"strip {strip.shape} {strip.dtype}, want (512, 2048, 3) uint8")


def main_path_phase(pipe) -> dict:
    """SD1.4 directinversion+p2p at full width on the card, through the
    port's entry points."""
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor

    steps = pipe.schedule.num_steps
    editor = P2PEditor(pipe)
    image = _random_images(1234)
    _, t_warm = _sync_time(lambda: editor("directinversion+p2p", image(), SRC, TAR, **EDIT_KW))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    strip, t_edit = _sync_time(lambda: editor("directinversion+p2p", image(), SRC, TAR,
                                              **EDIT_KW))
    counts = _counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _check_strip(strip)
    want = {"fwd": EXPECTED_FLASH_LAUNCHES * steps // 50, "prep": 0, "main": 0, "convert": 0}
    if counts != want:
        raise AssertionError(f"kernel launches in one edit {counts}, want {want}")

    # the same edit phase by phase, each timed to a synchronize
    with torch.inference_mode():
        img = image()
        latent, t_enc = _sync_time(lambda: editor.encode_image(img))
        (cond, uncond), t_text = _sync_time(lambda: editor.embeds([SRC, TAR]))
        traj, t_inv = _sync_time(lambda: editor.invert(latent, cond[:1]))
        spec, tensors = editor.make_control([SRC, TAR], blend_word=EDIT_KW["blend_word"],
                                            eq_params=EDIT_KW["eq_params"])
        edit, t_scan = _sync_time(lambda: editor.fused_edit(spec, traj, cond, uncond, 7.5,
                                                            tensors))
        both, t_dec = _sync_time(lambda: editor.decode_image(torch.cat([traj[0], edit[-1:]])))
    for name, x in (("trajectory", traj), ("edit latents", edit)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name} are not finite")
    if traj.shape != (steps + 1, 1, 64, 64, 4) or edit.shape != (2, 64, 64, 4):
        raise AssertionError(f"latent shapes {tuple(traj.shape)}, {tuple(edit.shape)}")
    if both.shape != (2, 512, 512, 3):
        raise AssertionError(f"decoded {both.shape}")
    return {"warmup_edit_s": t_warm, "edit_s_per_image": t_edit,
            "flash_launches_per_edit": counts["fwd"], "peak_mem_gib": peak_gib,
            "vae_encode_x1_s": t_enc, "text_encode_s": t_text,
            f"invert_{steps}xb1_s": t_inv, f"fused_offsets_edit_{steps}xb3_s": t_scan,
            "vae_decode_x2_s": t_dec}


def null_text_phase(pipe, steps: int = NULL_TEXT_STEPS) -> dict:
    """SD1.4 null-text-inversion+p2p at full width on the card: a warm-up
    edit at 2 DDIM steps, then one edit at ``steps`` whose kernel launches
    are counted and whose phases (the editor's own methods, wrapped) are each
    timed to a synchronize."""
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

    image = _random_images(4321)
    warm = P2PEditor(dataclasses.replace(pipe, schedule=make_ddim_schedule(2)))
    _, t_warm = _sync_time(lambda: warm(NULL_TEXT, image(), SRC, TAR, **EDIT_KW))

    editor = P2PEditor(dataclasses.replace(pipe, schedule=make_ddim_schedule(steps)))
    seconds, outputs = {}, {}

    def timed(name, fn):
        def run(*args, **kwargs):
            out, dt = _sync_time(lambda: fn(*args, **kwargs))
            seconds.setdefault(name, []).append(dt)
            outputs.setdefault(name, []).append(out)
            return out
        return run

    for name in ("encode_image", "embeds", "invert", "null_text", "guided", "decode_image"):
        setattr(editor, name, timed(name, getattr(editor, name)))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    strip, t_edit = _sync_time(lambda: editor(NULL_TEXT, image(), SRC, TAR, **EDIT_KW))
    counts = _counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _check_strip(strip)

    (traj,), (uncond_steps,) = outputs["invert"], outputs["null_text"]
    recon, edit = outputs["guided"]
    want_shapes = {"trajectory": (traj, (steps + 1, 1, 64, 64, 4)),
                   "uncond embeddings": (uncond_steps, (steps, 1, 77, 768)),
                   "recon latents": (recon, (1, 64, 64, 4)),
                   "edit latents": (edit, (2, 64, 64, 4))}
    for name, (x, shape) in want_shapes.items():
        if tuple(x.shape) != shape or not torch.isfinite(x).all():
            raise AssertionError(f"{name}: shape {tuple(x.shape)} (want {shape}) or not finite")
    # every inner Adam step runs one backward through the UNet: one launch of
    # each backward kernel per differentiated flash site; every UNet call
    # runs one forward per site
    inner = counts["main"] // BWD_SITES
    if (not counts["prep"] == counts["main"] == counts["convert"]
            or counts["main"] % BWD_SITES or not steps <= inner <= NULL_TEXT_INNER * steps):
        raise AssertionError(f"backward launches {counts}: want equal prep/main/convert "
                             f"counts, {BWD_SITES} per inner step, "
                             f"{steps}..{NULL_TEXT_INNER * steps} inner steps")
    # UNet calls: inversion T, cond eps T, inner steps K, advances T, recon T, edit T
    want_fwd = FLASH_SITES * (5 * steps + inner)
    if counts["fwd"] != want_fwd:
        raise AssertionError(f"forward launches {counts['fwd']}, want {want_fwd} "
                             f"= {FLASH_SITES} x (5 x {steps} + {inner})")
    (t_null,), (t_recon, t_edit_scan) = seconds["null_text"], seconds["guided"]
    return {"steps": steps, "num_inner_steps": NULL_TEXT_INNER, "warmup_edit_2_steps_s": t_warm,
            "edit_s_per_image": t_edit, "launches": counts, "inner_steps_total": inner,
            "peak_mem_gib": peak_gib, "vae_encode_x1_s": seconds["encode_image"][0],
            "text_encode_s": seconds["embeds"][0], f"invert_{steps}xb1_s": seconds["invert"][0],
            "null_text_s": t_null, "null_text_s_per_inner_step": t_null / inner,
            f"recon_{steps}xb2_s": t_recon, f"edit_{steps}xb4_s": t_edit_scan,
            "vae_decode_x2_s": seconds["decode_image"][0]}


def ddim_phase(pipe) -> dict:
    """One SD1.4 ddim+p2p edit (it shares the CFG loops of null-text+p2p)
    with its launches counted: inversion, reconstruction and edit, no
    backward."""
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor

    steps = pipe.schedule.num_steps
    _reset_counts()
    strip, t_edit = _sync_time(lambda: P2PEditor(pipe)("ddim+p2p", _random_images(99)(), SRC,
                                                        TAR, **EDIT_KW))
    counts = _counts()
    _check_strip(strip)
    want = {"fwd": FLASH_SITES * 3 * steps, "prep": 0, "main": 0, "convert": 0}
    if counts != want:
        raise AssertionError(f"ddim+p2p kernel launches {counts}, want {want}")
    return {"steps": steps, "edit_s_per_image": t_edit, "launches": counts}


BATCH = 4  # images per batched edit, as bench.py runs them per chip
# DDIM steps of the batched images-do-not-interact check: LocalBlend from
# step 2, cross-attention replace to 4, self-attention replace to 6
INDEPENDENCE_STEPS = 10
VARIANT_STEPS = 5  # DDIM steps of the counted edits of the other methods
# ProxEdit's benchmark settings (the batched class's defaults)
PROX_KW = dict(proximal="l0", quantile=0.75, use_inversion_guidance=True, recon_lr=1.0,
               recon_t=400)
# (method, options, UNet calls per DDIM step): one counted edit per group of
# the P2P family's other methods. The null-text-like methods also make K more
# calls, one per inner Adam step, each with a backward
VARIANT_RUNS = [
    ("negative-prompt-inversion+p2p", dict(npi_interp=0.5), 3),
    ("negative-prompt-inversion+proximal-guidance", PROX_KW, 3),
    ("null-text-inversion+proximal-guidance", PROX_KW, 5),
    ("ablation_null-text-inversion_single_branch+p2p", {}, 5),
    ("ablation_null-latent-inversion+p2p", {}, 5),
    ("directinversion+p2p_guidance_25_75", {}, 2),
    ("ablation_directinversion_04+p2p", {}, 4),
    ("ablation_directinversion_interval_2+p2p", {}, 4),
    ("ablation_directinversion_add-source+p2p", {}, 3),
]
# (method, UNet calls per DDIM step) of the batched class at 2 images: one
# per group, and the step ablation (DirectInversion at the pipeline's steps)
BATCHED_RUNS = [
    (f"ablation_directinversion_step_{VARIANT_STEPS}+p2p", 2), ("ddim+p2p", 2),
    ("negative-prompt-inversion+p2p", 2), ("negative-prompt-inversion+proximal-guidance", 3),
    ("null-text-inversion+proximal-guidance", 5), ("null-text-inversion+p2p", 4),
    ("ablation_null-text-inversion_single_branch+p2p", 4),
    ("ablation_null-latent-inversion+p2p", 4), ("directinversion+p2p_guidance_25_75", 2),
    ("ablation_directinversion_04+p2p", 3), ("ablation_directinversion_add-target+p2p", 3),
]
NULL_LIKE = ("null-text", "ablation_null")


def _check_launches(name: str, counts: dict, calls_per_step: int, steps: int,
                    max_inner: int = NULL_TEXT_INNER) -> int:
    """Check a counted run's launches against the code's own count: one B1
    launch per flash site per UNet call (``calls_per_step`` per DDIM step
    plus one per inner Adam step), and one of each backward kernel per
    differentiated site per inner step. Returns K, the inner steps."""
    inner = counts["main"] // BWD_SITES
    want_fwd = FLASH_SITES * (calls_per_step * steps + inner)
    null_like = name.startswith(NULL_LIKE)
    ok = (counts["prep"] == counts["main"] == counts["convert"]
          and counts["main"] % BWD_SITES == 0 and counts["fwd"] == want_fwd
          and (steps <= inner <= max_inner * steps if null_like else inner == 0))
    if not ok:
        k_range = f"1..{max_inner}" if null_like else "0"
        raise AssertionError(f"{name}: launches {counts}, want {FLASH_SITES} x "
                             f"({calls_per_step} x {steps} + K) forward and {BWD_SITES} x K of "
                             f"each backward kernel, K = {k_range} per step")
    return inner


def _check_f32_launches(name: str, calls: int) -> dict:
    """Check an f32 path's launches since ``_reset_counts`` against the
    code's own count: the f32 forward (its split pass and main kernel) once
    per flash site per UNet call, no backward, and no bf16 kernel. Returns
    the f32 counts."""
    counts, bf16 = _f32_counts(), _counts()
    want = {"fwd": FLASH_SITES * calls, "split": FLASH_SITES * calls, "dq": 0, "dkv": 0,
            "bwd_split": 0}
    if counts != want or any(bf16.values()):
        raise AssertionError(f"{name}: f32 launches {counts} (bf16 kernels {bf16}), want "
                             f"{want} and no bf16 kernel ({calls} UNet calls)")
    return counts


def variants_phase(pipe, steps: int = VARIANT_STEPS) -> dict:
    """One counted edit of each other P2P-family method group through
    ``P2PEditor`` at full SD1.4 width and ``steps`` DDIM steps (null-text's
    and null-latent's 10 inner steps kept)."""
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

    editor = P2PEditor(dataclasses.replace(pipe, schedule=make_ddim_schedule(steps)))
    size = pipe.config.image_size
    image = _random_images(555, size)
    rows = {}
    for method, kw, calls in VARIANT_RUNS:
        img = image()
        _reset_counts()
        strip, t = _sync_time(lambda: editor(method, img, SRC, TAR, **EDIT_KW, **kw))
        counts = _counts()
        _check_strip(strip)
        inner = _check_launches(method, counts, calls, steps)
        rows[method] = {"edit_s": t, "launches": counts, "inner_steps_total": inner,
                        "edit_panel_std": float(strip[:, 3 * size:].std())}
        print("variant", json.dumps({"method": method, "steps": steps, **rows[method]}),
              flush=True)
    return rows


# one (source, target) pair per image where the images' prompts differ: the
# cake edit's words (LocalBlend on "cake", "square" reweighted), each pair
# with "round"/"square" and "cake" at positions of its own, so that each
# image's refinement alphas, equalizer and blend-word selector differ; the
# last pair serves the images that replace others
CAKE_PROMPTS = [(src, src.replace("round", "square")) for src in (
    SRC,
    "a big round cake with pink frosting on a glass plate",
    "a tall white round cake on a metal table",
    "one slice of a small round cake with blue frosting",
    "on a red plate there sits a round chocolate cake",
)]


def _cake_batch(pipe, prompts):
    """(spec, cond (n, 2, 77, D), uncond (2, 77, D), the images' tensors
    stacked) of the cake edit, one (source, target) pair per image."""
    from pnpinversion_tpu_torch.control.p2p import stack_tensors
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor

    editor = P2PEditor(pipe)
    controls = [editor.make_control(list(pair), blend_word=EDIT_KW["blend_word"],
                                    eq_params=EDIT_KW["eq_params"]) for pair in prompts]
    if len({spec for spec, _ in controls}) != 1:
        raise AssertionError("the images' prompts give different P2P specs")
    cond = torch.stack([pipe.encode_prompt(list(pair)) for pair in prompts])
    return (controls[0][0], cond, pipe.encode_prompt(["", ""]),
            stack_tensors([tensors for _, tensors in controls]))


def _diff(got, ref):
    """(max, mean) uint8 difference."""
    d = np.abs(got.astype(int) - ref.astype(int))
    return int(d.max()), float(d.mean())


def batched_phase(pipe, single_s: float) -> dict:
    """The batched editor's headline: ``BatchedDirectInversionP2P`` on
    ``BATCH`` images (SD1.4, 512^2, the pipeline's steps, the cake edit): a
    warm-up batch, then a timed batch whose launches are counted; then each
    image of it through the single-image editor, and the uint8 difference of
    the two paths' panels, image by image. Then the checks that tell a fault
    of the batched path from the numerics of another batch size:

    - the reconstruction panels are the VAE round trip at each path's batch
      sizes, bit for bit, so their difference is the VAE's alone;
    - the images do not interact: with a prompt pair of its own per image,
      images [a, b, c, d] twice (the run-to-run floor), then [e, b, f, d]
      and [a, g, c, h] give the kept images' panels again, up to that
      floor, at ``INDEPENDENCE_STEPS`` DDIM steps. A mix-up of the images'
      tensors, source rows or LocalBlend masks, or a statistic taken over
      the batch, moves them. Each image keeps its place: one of cuDNN's
      convolutions gives an image results that depend on its place in the
      batch (one bf16 ulp, which 50 steps grow to tens of levels:
      ``scripts/probe_torch_batch_independence.py``);
    - the batched class at N = 1 gives the single-image editor's panels;

    and, measured only, how far the single-image edit moves when its latent
    moves by one or two bf16 ulps. Returns (numbers, the timed batch's
    inputs and panels: ``images``, ``recon``, ``edit``)."""
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.models.vae import image_to_latent, latent_to_image
    from pnpinversion_tpu_torch.parallel.sweep import BatchedDirectInversionP2P
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

    steps = pipe.schedule.num_steps
    sweep = BatchedDirectInversionP2P(pipe)
    spec, cond, uncond, tensors = _cake_batch(pipe, [(SRC, TAR)] * BATCH)
    size = pipe.config.image_size
    image = _random_images(2024, size)

    def edit(imgs):
        return sweep.edit_batch(spec, imgs, cond, uncond, 7.5, tensors)

    _, t_warm = _sync_time(lambda: edit(np.stack([image() for _ in range(BATCH)])))
    imgs = np.stack([image() for _ in range(BATCH)])
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    (recon, edits), t_batch = _sync_time(lambda: edit(imgs))
    counts = _counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {"fwd": EXPECTED_FLASH_LAUNCHES * steps // 50, "prep": 0, "main": 0, "convert": 0}
    if counts != want:
        raise AssertionError(f"batched launches {counts}, want {want} (10 sites x "
                             f"({steps} inversion + {steps} scan) UNet calls, whatever N is)")
    for name, x in (("recon", recon), ("edit", edits)):
        if x.shape != (BATCH, size, size, 3) or x.dtype != np.uint8:
            raise AssertionError(f"batched {name} {x.shape} {x.dtype}")
        if min(float(x[i].std()) for i in range(BATCH)) == 0.0:
            raise AssertionError(f"a batched {name} image is constant")
    editor = P2PEditor(pipe)

    def single(i):
        strip = editor("directinversion+p2p", imgs[i], SRC, TAR, **EDIT_KW)
        return strip[:, 2 * size:3 * size], strip[:, 3 * size:]

    singles = [single(i) for i in range(BATCH)]
    diffs = {"recon_max": [], "recon_mean": [], "edit_max": [], "edit_mean": []}
    for i in range(BATCH):
        for name, got, ref in zip(("recon", "edit"), (recon[i], edits[i]), singles[i]):
            d_max, d_mean = _diff(got, ref)
            diffs[f"{name}_max"].append(d_max)
            diffs[f"{name}_mean"].append(d_mean)

    # the reconstructions: encode at N and decode at 2N rows (edit_batch),
    # encode at 1 and decode at 2 (the editor)
    with torch.inference_mode():
        lat = image_to_latent(pipe.vae, torch.as_tensor(imgs, device=pipe.device),
                              dtype=pipe.dtype)
        vae_batched = latent_to_image(pipe.vae, torch.cat([lat, lat])).cpu().numpy()
        vae_single = [editor.decode_image(torch.cat([editor.encode_image(im)] * 2))[0]
                      for im in imgs]
    for i in range(BATCH):
        if not (np.array_equal(recon[i], vae_batched[i])
                and np.array_equal(singles[i][0], vae_single[i])):
            raise AssertionError(f"image {i}: a reconstruction panel is not its path's VAE "
                                 "round trip")
    vae_diff = [_diff(vae_batched[i], vae_single[i]) for i in range(BATCH)]

    # the images do not interact: each image keeps its place in the batch
    # (cuDNN's results for one image may depend on its place), the others
    # change; at INDEPENDENCE_STEPS, where every P2P phase acts
    imgs_p = np.stack([image() for _ in range(2 * BATCH)])
    prompts = [CAKE_PROMPTS[min(i, BATCH)] for i in range(2 * BATCH)]
    short = dataclasses.replace(pipe, schedule=make_ddim_schedule(INDEPENDENCE_STEPS))
    sweep_short = BatchedDirectInversionP2P(short)

    def own_prompts(order):
        spec_p, cond_p, uncond_p, tensors_p = _cake_batch(short, [prompts[i] for i in order])
        return sweep_short.edit_batch(spec_p, imgs_p[order], cond_p, uncond_p, 7.5, tensors_p)

    first = own_prompts(list(range(BATCH)))
    floor = max(_diff(a[i], b[i])[0] for a, b in zip(first, own_prompts(list(range(BATCH))))
                for i in range(BATCH))
    apart = 0
    for kept in (range(1, BATCH, 2), range(0, BATCH, 2)):
        order = [i if i in kept else BATCH + i for i in range(BATCH)]
        apart = max([apart] + [_diff(g[i], f[i])[0] for g, f in zip(own_prompts(order), first)
                               for i in kept])
    if apart > floor:
        raise AssertionError(f"batched images interact: an image's panels moved by {apart} "
                             f"uint8 levels when the other images changed (floor {floor})")

    # the batched class at N = 1, and the editor run twice
    tensors1 = {k: v[:1] for k, v in tensors.items()}
    one = sweep.edit_batch(spec, imgs[:1], cond[:1], uncond, 7.5, tensors1)
    floors = {"single_run_to_run": [_diff(a, b)[0] for a, b in zip(single(0), singles[0])],
              "batched_n1_vs_single": [_diff(a[0], b)[0] for a, b in zip(one, singles[0])]}
    if max(floors["batched_n1_vs_single"]) > max(floors["single_run_to_run"]):
        raise AssertionError(f"the batched class at N = 1 is not the single-image editor: "
                             f"{floors}")

    # the single-image edit's sensitivity to its latent
    with torch.inference_mode():
        cond1, uncond1 = editor.embeds([SRC, TAR])
        spec1, tensors1 = editor.make_control([SRC, TAR], blend_word=EDIT_KW["blend_word"],
                                              eq_params=EDIT_KW["eq_params"])

        def edit_panel(latent):
            traj = editor.invert(latent, cond1[:1])
            out = editor.fused_edit(spec1, traj, cond1, uncond1, 7.5, tensors1)
            return editor.decode_image(torch.cat([traj[0], out[-1:]]))[1]

        lat0 = editor.encode_image(imgs[0])
        nudged = edit_panel((lat0.float() * (1 + 2 ** -7)).to(lat0.dtype))
        sensitivity = _diff(nudged, edit_panel(lat0))
    stats = {"batch": BATCH, "steps": steps, "warmup_batch_s": t_warm, "batch_s": t_batch,
            "s_per_image": t_batch / BATCH, "single_image_s": single_s,
            "single_over_batched_per_image": single_s * BATCH / t_batch,
            "flash_launches_per_batch": counts["fwd"], "peak_mem_gib": peak_gib,
            "uint8_diff_vs_single_editor": diffs,
            "recon_is_vae_round_trip": True, "vae_batch_vs_single_max_mean": vae_diff,
            "own_prompts_run_to_run_max": floor, "own_prompts_kept_images_max": apart,
            "uint8_max_diff_floors_recon_edit": floors,
            "single_edit_max_mean_after_latent_ulp_nudge": sensitivity}
    return stats, {"images": imgs, "recon": recon, "edit": edits}


def batched_variants_phase(pipe, steps: int = 3, n: int = 2, inner: int = 2) -> dict:
    """The batched class on ``n`` images for one method of each group, at
    ``steps`` DDIM steps and ``inner`` Adam steps, launches counted."""
    from pnpinversion_tpu_torch.parallel.sweep import BatchedDirectInversionP2P
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

    p = dataclasses.replace(pipe, schedule=make_ddim_schedule(steps))
    sweep = BatchedDirectInversionP2P(p, num_inner_steps=inner)
    spec, cond, uncond, tensors = _cake_batch(p, CAKE_PROMPTS[:n])
    size = pipe.config.image_size
    image = _random_images(777, size)
    rows = {}
    for method, calls in BATCHED_RUNS:
        if method.startswith("ablation_directinversion_step_"):
            method = f"ablation_directinversion_step_{steps}+p2p"
        unc = cond[:, :1].expand(-1, 2, -1, -1) if method.startswith("negative") else uncond
        imgs = np.stack([image() for _ in range(n)])
        _reset_counts()
        (recon, edit), t = _sync_time(lambda: sweep.edit_batch(spec, imgs, cond, unc, 7.5,
                                                               tensors, method=method))
        counts = _counts()
        k = _check_launches(method, counts, calls, steps, max_inner=inner)
        if (recon.shape != (n, size, size, 3) or edit.shape != recon.shape
                or float(edit.std()) == 0.0):
            raise AssertionError(f"batched {method}: {recon.shape} {edit.shape}")
        rows[method] = {"batch_s": t, "launches": counts, "inner_steps_total": k}
        print("batched_variant", json.dumps({"method": method, "images": n, "steps": steps,
                                             **rows[method]}), flush=True)
    return rows


def early_stop_phase(pipe, steps: int = 3) -> dict:
    """Batched null-text's per-image early stop, in bf16 on the card: two
    images, the second with its targets moved so its losses stay high, and a
    threshold between the two images' first losses. Alone, image 0 stops
    early and image 1 takes every inner step; together, image 1's count is
    the batch's, and each image's embeddings are compared with its own."""
    from pnpinversion_tpu_torch.inversion.ddim_inversion import (
        ddim_invert_loop,
        null_text_optimization,
    )
    from pnpinversion_tpu_torch.models.unet import apply_images
    from pnpinversion_tpu_torch.models.vae import image_to_latent
    from pnpinversion_tpu_torch.schedulers.ddim import (
        classifier_free_guidance,
        ddim_step,
        make_ddim_schedule,
    )

    sched, unet = make_ddim_schedule(steps), pipe.unet
    image = _random_images(31337, pipe.config.image_size)
    imgs = torch.as_tensor(np.stack([image(), image()]), device=pipe.device)
    with torch.no_grad():
        lat = image_to_latent(pipe.vae, imgs, dtype=pipe.dtype)[:, None]
        cond = pipe.encode_prompt([SRC, SRC]).clone()[:, None]
        uncond = pipe.encode_prompt(["", ""]).clone()[:, None]
        traj = ddim_invert_loop(unet, sched, lat, cond)

        def first_losses():
            t, x = sched.timesteps[0], traj[:, -1]
            eps_c, _ = apply_images(unet, x, t, cond)
            eps_u, _ = apply_images(unet, x, t, uncond)
            d = (ddim_step(sched, classifier_free_guidance(eps_u, eps_c, 7.5), t, x)
                 - traj[:, steps - 1]).float()
            return (d * d).reshape(2, -1).mean(1).tolist()

        # image 1's targets move by 10x image 0's first RMS error: its losses
        # are ~100x image 0's, the threshold ~10x
        traj[1, :-1] += 10.0 * float(np.sqrt(first_losses()[0]))
        first = first_losses()
    if not first[1] > 25 * first[0]:
        raise AssertionError(f"early stop: first losses {first}, want image 1's > 25x image 0's")
    epsilon = float(np.sqrt(first[0] * first[1]))

    def run(sl):
        _reset_counts()
        out = null_text_optimization(unet, sched, traj[sl], uncond[sl], cond[sl], 7.5,
                                     num_inner_steps=NULL_TEXT_INNER, epsilon=epsilon)
        torch.cuda.synchronize()
        return out, _counts()["main"] // BWD_SITES

    (both, k_both), (alone0, k0), (alone1, k1) = (run(sl) for sl in (
        slice(None), slice(0, 1), slice(1, 2)))
    if not (k0 < k1 == k_both == NULL_TEXT_INNER * steps):
        raise AssertionError(f"early stop: inner steps alone {k0}, {k1}, together {k_both}")
    rel = [((both[i].float() - a[0].float()).abs().max() / a[0].float().abs().max()).item()
           for i, a in enumerate((alone0, alone1))]
    return {"steps": steps, "first_losses": first, "epsilon": epsilon,
            "inner_steps_alone": [k0, k1], "inner_steps_together": k_both,
            "embedding_rel_diff_together_vs_alone": rel}


FAMILY_RUNS = ("directinversion+masactrl", "directinversion+pnp", "edit-friendly-inversion+p2p")
# families whose UNet computes in f32 on a bf16 pipeline (its layers cast the
# weights to the f32 latents), as the JAX package's layers do
F32_FAMILIES = ("edit-friendly-inversion+p2p",)
# DDIM steps of the families' counted edits and batches: 50 until the tp and
# w8 phases joined the script (the smoke's time; their shapes do not depend
# on the steps, and scripts/time_torch_families.py times them at 50)
FAMILY_STEPS = 20
FAMILY_SHORT_RUNS = ("ddim+masactrl", "ddim+pnp")  # counted at VARIANT_STEPS
EF_SKIP = 12  # the EF editor's default: T forward and T - 12 reverse UNet calls


def family_unet_calls(method: str, steps: int) -> int:
    """UNet calls of one edit of a family, as the code makes them (a batch
    makes as many, each over every image's rows): MasaCtrl 1 inversion + 1
    sampling call per step, directinversion+pnp 1 inversion + 1 injection,
    ddim+pnp also 1 re-denoising, EF T noise-map and T - skip reverse calls."""
    if method == "edit-friendly-inversion+p2p":
        return steps + steps - min(EF_SKIP, steps - 1)
    return (3 if method == "ddim+pnp" else 2) * steps


def _family(pipe, method):
    """(the single-image editor of ``method``'s family on ``pipe``, the
    phases to time as (owner, attribute), batch(images, prompt pairs) ->
    (source-row or recon panels, edit panels) through its batched class)."""
    from pnpinversion_tpu_torch.control.p2p import stack_tensors
    from pnpinversion_tpu_torch.editors import ef_editor, masactrl_editor, pnp_editor
    from pnpinversion_tpu_torch.parallel import sweep

    if method.endswith("masactrl"):
        editor, module = masactrl_editor.MasaCtrlEditor(pipe), masactrl_editor
        phases = ("ddim_invert_loop", "fused_direct_inversion_edit", "guidance_forward")

        def batch(imgs, prompts):
            cond = torch.stack([pipe.encode_prompt(["", tar]) for _, tar in prompts])
            return sweep.BatchedMasaCtrl(pipe).edit_batch(method.startswith("direct"), imgs,
                                                          cond, 7.5)
    elif method.endswith("pnp"):
        editor, module = pnp_editor.PnPEditor(pipe), pnp_editor
        phases = ("ddim_invert_loop", "ddim_sample_trajectory", "pnp_sample_loop")

        def batch(imgs, prompts):
            src, tar = (torch.stack([pipe.encode_prompt([pair[i]]) for pair in prompts])
                        for i in (0, 1))
            return sweep.BatchedPnP(pipe).edit_batch(method, imgs, src, tar, 7.5)
    else:
        editor, module = ef_editor.EditFriendlyEditor(pipe), ef_editor
        phases = ("ef_forward_process", "ef_reverse_process")

        def batch(imgs, prompts):
            controls = [ef_editor.ef_control(pipe, list(pair), pipe.schedule.num_steps)
                        for pair in prompts]
            if len({c.spec for c, _ in controls}) != 1:
                raise AssertionError("the images' prompts give different EF specs")
            cond = torch.stack([pipe.encode_prompt(list(pair)) for pair in prompts])
            return sweep.BatchedEditFriendly(pipe, skip=EF_SKIP).edit_batch(
                controls[0][0].spec, imgs, cond, 1.0, 7.5,
                stack_tensors([t for _, t in controls]))
    targets = [(module, name) for name in phases] + [(editor, "encode_image"),
                                                     (editor, "decode_image")]
    return editor, targets, batch


def _timed_calls(targets, seconds: dict):
    """Replaces each (owner, attribute) by a wrapper that times every call to
    a synchronize into ``seconds[attribute]`` (summed); returns a function
    that puts the originals back."""
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]
    own = [name in vars(owner) for owner, name in targets]
    for owner, name, fn in saved:
        def run(*args, _fn=fn, _name=name, **kwargs):
            out, dt = _sync_time(lambda: _fn(*args, **kwargs))
            seconds[_name] = seconds.get(_name, 0.0) + dt
            return out
        setattr(owner, name, run)

    def restore():
        # a method is deleted from the instance again (keeping its bound
        # method there would tie the instance, and its pipeline, in a cycle)
        for (owner, name, fn), in_dict in zip(saved, own):
            if in_dict:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)
    return restore


def _pipe_at(pipe, steps: int):
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

    return dataclasses.replace(pipe, schedule=make_ddim_schedule(steps))


def families_phase(pipe) -> dict:
    """MasaCtrl, PnP and edit-friendly DDPM at full SD1.4 width, each family
    on the same 4 images with a cake prompt pair each:

    - one counted edit through the single-image editor at ``FAMILY_STEPS``
      (after a warm-up edit at 2 steps), timed per phase to a synchronize,
      peak memory, strip checked, B1's launches against the code's count;
    - its batched class on the 4 images at ``FAMILY_STEPS`` (after a warm-up
      batch at 2 steps): seconds per image, launches, peak memory;
    - each image's panels against the single-image editor's (the counted
      edit is image 0's), as uint8 differences;
    - images kept in place are bit-identical whatever the other images are:
      at ``INDEPENDENCE_STEPS``, slots 1 and 3 kept and slots 0 and 2
      replaced must differ from the first batch by no more than that batch
      from itself (C5: an image's result may depend on its slot, so none
      moves);

    then one counted edit each of ddim+masactrl and ddim+pnp at
    ``VARIANT_STEPS``."""
    size = pipe.config.image_size
    image = _random_images(4242, size)
    imgs = np.stack([image() for _ in range(BATCH)])
    others = np.stack([image() for _ in range(BATCH)])
    prompts = CAKE_PROMPTS[:BATCH]
    kept = (1, 3)
    swapped = np.stack([imgs[i] if i in kept else others[i] for i in range(BATCH)])
    swapped_prompts = [prompts[i] if i in kept else CAKE_PROMPTS[BATCH] for i in range(BATCH)]
    rows = {}
    for method in FAMILY_RUNS:
        warm_editor, _, warm_batch = _family(_pipe_at(pipe, 2), method)
        _, t_warm = _sync_time(lambda: warm_editor(method, imgs[0], *prompts[0]))
        editor, targets, batch = _family(_pipe_at(pipe, FAMILY_STEPS), method)
        seconds = {}
        restore = _timed_calls(targets, seconds)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        try:
            strip, t_edit = _sync_time(lambda: editor(method, imgs[0], *prompts[0]))
        finally:
            restore()
        f32 = method in F32_FAMILIES
        counts, peak = _counts(), torch.cuda.max_memory_allocated() / 2**30
        _check_strip(strip)
        calls = family_unet_calls(method, FAMILY_STEPS)
        if f32:
            counts = _check_f32_launches(method, calls)
        else:
            _check_launches(method, counts, 1, calls)

        _, t_warm_batch = _sync_time(lambda: warm_batch(imgs, prompts))
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        (recon, edits), t_batch = _sync_time(lambda: batch(imgs, prompts))
        batch_counts, batch_peak = _counts(), torch.cuda.max_memory_allocated() / 2**30
        if f32:
            batch_counts = _check_f32_launches(f"batched {method}", calls)
        else:
            _check_launches(f"batched {method}", batch_counts, 1, calls)
        for name, x in (("recon", recon), ("edit", edits)):
            if x.shape != (BATCH, size, size, 3) or x.dtype != np.uint8:
                raise AssertionError(f"batched {method} {name} {x.shape} {x.dtype}")
            if min(float(x[i].std()) for i in range(BATCH)) == 0.0:
                raise AssertionError(f"a batched {method} {name} image is constant")
        singles = [strip] + [editor(method, imgs[i], *prompts[i]) for i in range(1, BATCH)]
        diffs = {"recon_max": [], "recon_mean": [], "edit_max": [], "edit_mean": []}
        for i, single in enumerate(singles):
            _check_strip(single)
            for name, got, col in (("recon", recon[i], 2), ("edit", edits[i], 3)):
                d_max, d_mean = _diff(got, single[:, col * size:(col + 1) * size])
                diffs[f"{name}_max"].append(d_max)
                diffs[f"{name}_mean"].append(d_mean)

        if method == "edit-friendly-inversion+p2p":
            # the source row rebuilds the image only through the cancellation
            # of the noise-map pass's eps and the reverse pass's: how far each
            # path's source-row panel is from the image's VAE round trip
            with torch.inference_mode():
                trip = [editor.decode_image(editor.encode_image(im))[0] for im in imgs]
            diffs["single_recon_vs_vae_round_trip_max_mean"] = [
                _diff(st[:, 2 * size:3 * size], t) for st, t in zip(singles, trip)]
            diffs["batched_recon_vs_vae_round_trip_max_mean"] = [
                _diff(r, t) for r, t in zip(recon, trip)]
            # the same round trip decoded in f32, as EF's own decode is
            with torch.inference_mode():
                trip32 = [editor.decode_image(editor.encode_image(im).float())[0] for im in imgs]
            diffs["single_recon_vs_f32_decoded_round_trip_max_mean"] = [
                _diff(st[:, 2 * size:3 * size], t) for st, t in zip(singles, trip32)]

        _, _, short_batch = _family(_pipe_at(pipe, INDEPENDENCE_STEPS), method)
        first = short_batch(imgs, prompts)
        floor = max(_diff(a[i], b[i])[0] for a, b in zip(first, short_batch(imgs, prompts))
                    for i in range(BATCH))
        apart = max(_diff(a[i], b[i])[0] for a, b in zip(first, short_batch(swapped,
                                                                               swapped_prompts))
                    for i in kept)
        if apart > floor:
            raise AssertionError(f"batched {method}: images kept in place moved by {apart} "
                                 f"uint8 levels when the others changed (floor {floor})")
        rows[method] = {
            "kernel": "f32" if f32 else "bf16",
            "steps": FAMILY_STEPS, "warmup_edit_2_steps_s": t_warm, "edit_s_per_image": t_edit,
            "phase_s": seconds, "launches": counts, "unet_calls": calls, "peak_mem_gib": peak,
            "edit_panel_std": float(strip[:, 3 * size:].std()),
            "batch": BATCH, "warmup_batch_2_steps_s": t_warm_batch, "batch_s": t_batch,
            "batch_s_per_image": t_batch / BATCH,
            "single_over_batched_per_image": t_edit * BATCH / t_batch,
            "batch_launches": batch_counts, "batch_peak_mem_gib": batch_peak,
            "uint8_diff_vs_single_editor": diffs,
            "kept_images_run_to_run_max": floor, "kept_images_others_replaced_max": apart}
        print("family", json.dumps({"method": method, **rows[method]}), flush=True)

    short = _pipe_at(pipe, VARIANT_STEPS)
    for method in FAMILY_SHORT_RUNS:
        editor, _, _ = _family(short, method)
        _reset_counts()
        strip, t = _sync_time(lambda: editor(method, imgs[0], *prompts[0]))
        counts = _counts()
        _check_strip(strip)
        calls = family_unet_calls(method, VARIANT_STEPS)
        _check_launches(method, counts, 1, calls)
        rows[method] = {"kernel": "bf16", "steps": VARIANT_STEPS, "edit_s": t, "launches": counts,
                        "unet_calls": calls, "edit_panel_std": float(strip[:, 3 * size:].std())}
        print("family", json.dumps({"method": method, **rows[method]}), flush=True)
    return rows


def masactrl_controls_phase(pipe) -> dict:
    """One full-width SD1.4 UNet call at 4 rows ([uncond x 2, cond x 2] of
    one image, the cake target) under each other MasaCtrl control at an
    active step (4; sites from block 10): the union, the mask control with
    two synthetic 64^2 disc masks, the auto-mask control (its masks from this
    call's own 16^2 cross maps of one token). eps must be finite; B1 runs at
    every flash site (the union's 6 sites at Sk = 2 Sq, the mask controls'
    source rows at 2 rows); the target rows' eps moves from the uncontrolled
    call's."""
    from pnpinversion_tpu_torch.control.base import NO_CONTROL
    from pnpinversion_tpu_torch.control.masactrl import (
        MasaCtrlControl,
        MasaCtrlMaskAutoControl,
        MasaCtrlMaskControl,
        MasaCtrlSpec,
    )

    dev, n = pipe.device, pipe.latent_size
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((4, n, n, 4), generator=gen, device=dev).to(pipe.dtype)
    ctx = torch.cat([pipe.encode_prompt(["", ""]), pipe.encode_prompt(["", TAR])])
    spec = MasaCtrlSpec()
    yy, xx = np.mgrid[:n, :n] * (64 / n)

    def disc(r, c, w):
        return torch.as_tensor(((yy - r) ** 2 + (xx - c) ** 2 < w * w)[None].astype(np.float32),
                               device=dev)

    selector = torch.zeros((1, 77), device=dev)
    selector[0, 2] = 1.0  # "square", the edited word of TAR (after the start token and "a")
    runs = [("plain", NO_CONTROL, {}),
            ("union", MasaCtrlControl(dataclasses.replace(spec, union=True)), {}),
            ("mask", MasaCtrlMaskControl(spec), {"mask_s": disc(28, 30, 14),
                                                 "mask_t": disc(36, 34, 18)}),
            ("mask_auto", MasaCtrlMaskAutoControl(spec), {"ref_token_mask": selector,
                                                          "cur_token_mask": selector})]
    rows, plain = {}, None
    for name, control, tensors in runs:
        state = control.init_state(2, heads=8, device=dev, images=1)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with torch.inference_mode():
            (eps, _), t = _sync_time(lambda: pipe.unet(x, 500, ctx, control, tensors, state, 4))
        counts = _counts()
        if eps.shape != x.shape or not torch.isfinite(eps).all():
            raise AssertionError(f"MasaCtrl {name}: eps {tuple(eps.shape)} or not finite")
        if counts["fwd"] != FLASH_SITES:
            raise AssertionError(f"MasaCtrl {name}: {counts['fwd']} B1 launches, want "
                                 f"{FLASH_SITES}")
        if plain is None:
            plain = eps.float()
        moved = [((eps[r].float() - plain[r]).abs().max() / plain[r].abs().max()).item()
                 for r in range(4)]
        if name != "plain" and min(moved[1], moved[3]) == 0.0:
            raise AssertionError(f"MasaCtrl {name} left the target rows as they were")
        rows[name] = {"unet_call_s": t, "launches": counts["fwd"],
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "eps_rel_diff_vs_plain_by_row": moved}
    print("masactrl_controls", json.dumps(rows), flush=True)
    return rows


# DDIM steps of the counted edict+p2p edit (float64 carry; 50 before the tp
# and w8 phases joined)
EDICT_STEPS = 20
EDICT_SHORT_STEPS = 5  # of edict+direct_forward (f32 carry)
EDICT_BATCH_STEPS = 3  # of BatchedEDICT x4, both methods (float64 carry)
EDICT_ROUND_TRIP_STEPS = 10  # of the strength-1.0 round trips in both precisions
EDICT_WARMUP_STEPS = 3
EDICT_TRACE_STEPS = 5  # of the edict+p2p edit traced for the f32 attention's share
F32_PANEL_TOL = 2  # uint8 levels: an f32 path's batched panels against the editor's


def edict_unet_calls(steps: int, strength: float = 0.8) -> int:
    """UNet calls of one EDICT edit, as the code makes them (a batch makes as
    many, each over every image's rows): two per step (one per latent of the
    pair) in each of the reconstruction's passes (all steps) and the edit's
    (the last int(steps * strength))."""
    return 2 * (2 * steps + 2 * int(steps * strength))


def _edict_inputs(pipe, seed: int):
    """BATCH random images with a cake prompt pair each: (images, pairs,
    cond_src (N, 1, 77, D), cond_tar, the takeover tensors stacked)."""
    from pnpinversion_tpu_torch.control.edict_p2p import make_edict_p2p_tensors
    from pnpinversion_tpu_torch.control.p2p import stack_tensors

    image = _random_images(seed, pipe.config.image_size)
    imgs = np.stack([image() for _ in range(BATCH)])
    pairs = CAKE_PROMPTS[:BATCH]
    src, tar = (torch.stack([pipe.encode_prompt([p[i]]) for p in pairs]) for i in (0, 1))
    tensors = stack_tensors([make_edict_p2p_tensors(*p, pipe.tokenizer, device=pipe.device)
                             for p in pairs])
    return imgs, pairs, src, tar, tensors


def edict_round_trip(pipe, image: np.ndarray, steps: int = EDICT_ROUND_TRIP_STEPS) -> dict:
    """``coupled_scan`` inverts an image's latent pair at strength 1.0
    (guidance 3, the source prompt) and regenerates it, in both precisions,
    at full width: the float64 carry's MSE against the pair must be below
    the f32 carry's by at least 10x (the JAX package's own criterion). It
    holds only if a UNet call gives the same bits for the same input, so one
    call is also made twice and compared."""
    from pnpinversion_tpu_torch.editors.edict_editor import EDICTEditor, coupled_scan

    editor = EDICTEditor(_pipe_at(pipe, steps))
    unet = pipe.unet
    with torch.inference_mode():
        latent = editor.encode_image(image, dtype=torch.float32)
        pair = torch.stack([latent, latent], dim=1)
        ctx = torch.cat([pipe.encode_prompt([""]), pipe.encode_prompt([SRC])])[None]
        x = latent.expand(2, -1, -1, -1)
        first, _ = unet(x, 500, ctx[0])
        again, _ = unet(x, 500, ctx[0])
        out = {"steps": steps, "unet_call_bit_identical_run_to_run": torch.equal(first, again),
               "unet_call_run_to_run_max_abs": (first - again).abs().max().item()}
        for precision in ("f32", "df64"):
            inv, t_inv = _sync_time(lambda: coupled_scan(unet, editor.schedule, pair, ctx, 3.0, 0,
                                                         True, precision=precision))
            rec, t_rec = _sync_time(lambda: coupled_scan(unet, editor.schedule, inv, ctx, 3.0, 0,
                                                         False, precision=precision))
            out[precision] = {"mse": ((rec.double() - pair.double()) ** 2).mean().item(),
                              "max_abs": (rec.double() - pair.double()).abs().max().item(),
                              "inversion_moved_max_abs": (inv.double() - pair.double()).abs()
                              .max().item(), "invert_s": t_inv, "regenerate_s": t_rec}
    if not out["df64"]["mse"] < out["f32"]["mse"] / 10:
        raise AssertionError(f"EDICT's float64 round trip does not beat the f32 one by 10x: "
                             f"{out}")
    return out


def _device_trace(fn) -> tuple:
    """Runs ``fn`` once under torch.profiler (device activity only) and
    returns (its wall seconds under the profiler, device microseconds by
    kernel name, kernel launches by name)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = _sync_time(fn)
    us, n = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] += e.time_range.elapsed_us()
            n[e.name] += 1
    if not us:
        raise AssertionError("torch.profiler recorded no device kernel")
    return wall, us, n


def edict_trace(pipe, image: np.ndarray, pair) -> dict:
    """One ``edict+p2p`` edit (float64 carry) at ``EDICT_TRACE_STEPS`` under
    torch.profiler: the f32 forward's device seconds (its main kernel
    ``flash_fwd_f32_kernel`` and its split pass ``flash_fwd_f32_split_kernel``)
    and launches in the trace, their share of the same edit's wall
    time run without the profiler, and their share of the sum of every
    kernel's traced time (that sum exceeded the wall time on the H100: it
    is no busy time, and no idle share is derived from it). The edit makes
    its UNet calls in the 50-step edit's proportions (2 per step of each
    pass, the edit's passes over the last 80% of the steps); its VAE and
    text encoder weigh ten times more than at 50 steps."""
    from pnpinversion_tpu_torch.editors.edict_editor import EDICTEditor

    editor = EDICTEditor(_pipe_at(pipe, EDICT_TRACE_STEPS), "df64")
    _, t_plain = _sync_time(lambda: editor("edict+p2p", image, *pair))
    wall, us, n = _device_trace(lambda: editor("edict+p2p", image, *pair))
    kernel_sum = sum(us.values()) / 1e6
    split = sum(v for k, v in us.items() if "flash_fwd_f32_split" in k) / 1e6
    attn = sum(v for k, v in us.items() if "flash_fwd_f32" in k) / 1e6
    launches = sum(v for k, v in n.items() if "flash_fwd_f32_kernel" in k)
    split_launches = sum(v for k, v in n.items() if "flash_fwd_f32_split" in k)
    calls = edict_unet_calls(EDICT_TRACE_STEPS)
    if not launches == split_launches == FLASH_SITES * calls:
        raise AssertionError(f"the traced edict+p2p edit launched the f32 forward {launches} "
                             f"times and its split pass {split_launches}, expected "
                             f"{FLASH_SITES * calls} each")
    return {"steps": EDICT_TRACE_STEPS, "unet_calls": calls, "edit_s": t_plain,
            "traced_edit_s": wall, "kernel_time_sum_s": kernel_sum,
            "f32_attention_device_s": attn, "f32_split_device_s": split,
            "f32_attention_launches": launches,
            "f32_attention_ms_per_launch": attn * 1e3 / launches,
            "f32_attention_share_of_edit": attn / t_plain,
            "f32_attention_share_of_kernel_time_sum": attn / kernel_sum,
            "top": [{"kernel": k[:90], "s": v / 1e6} for k, v in us.most_common(8)]}


def f32_cast_cost(pipe) -> dict:
    """What computing in f32 on the bf16 pipeline's own UNet costs (its
    Linear and Conv2d layers cast their bf16 weights to f32 at every call)
    against an f32 copy of the UNet made here (weights cast once): one UNet
    call at 2 and at 3 rows, timed in turns to a synchronize (host clock,
    median of 7; a UNet call waits for the device when it copies its
    timestep to it, so CUDA events behind a spin cannot time it), and the
    largest difference between the two outputs."""
    import copy

    copy32 = copy.deepcopy(pipe.unet).to(torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(17)
    out = {}
    with torch.inference_mode():
        ctx = torch.cat([pipe.encode_prompt([""]), pipe.encode_prompt([SRC]),
                         pipe.encode_prompt([TAR])])
        for rows in (2, 3):
            x = torch.randn((rows, 64, 64, 4), generator=gen, device="cuda")
            c = ctx[:rows]
            runs = {"cast": lambda: pipe.unet(x, 500, c)[0], "copy": lambda: copy32(x, 500, c)[0]}
            eps = {name: fn() for name, fn in runs.items()}
            ms = collections.defaultdict(list)
            for _ in range(7):
                for name, fn in runs.items():
                    ms[name].append(_sync_time(fn)[1] * 1e3)
            row = {f"{name}_ms": statistics.median(v) for name, v in ms.items()}
            row.update({f"{name}_spread_ms": max(v) - min(v) for name, v in ms.items()})
            out[f"rows_{rows}"] = {**row, "cast_over_copy": row["cast_ms"] / row["copy_ms"],
                                   "max_abs_diff": (eps["cast"] - eps["copy"]).abs().max().item()}
    del copy32
    torch.cuda.empty_cache()
    return out


def edict_phase(pipe) -> dict:
    """EDICT on the bf16 SD1.4 pipeline, its UNet and VAE computing in f32:

    - ``f32_cast_cost``: the per-call cast of the weights against an f32 copy;
    - one counted ``edict+p2p`` edit at ``EDICT_STEPS`` with the float64 carry
      (after a warm-up edit at ``EDICT_WARMUP_STEPS``), each coupled pass and
      the codec timed to a synchronize, peak memory, and the f32 forward's
      launches against the code's count;
    - ``edict_trace``: the f32 attention's share of an edit, from a device
      trace;
    - one counted ``edict+direct_forward`` edit at ``EDICT_SHORT_STEPS`` with
      the f32 carry;
    - ``BatchedEDICT`` on 4 images (a cake prompt pair each), float64, both
      methods at ``EDICT_BATCH_STEPS`` (not warmed at that length), launches
      counted, each image against the single-image editor, and each
      reconstruction panel (a float64 round trip) against the image's f32
      VAE round trip, as uint8 differences, each within ``F32_PANEL_TOL``;
    - ``edict_round_trip``: the float64 round trip against the f32 one."""
    from pnpinversion_tpu_torch.editors import edict_editor
    from pnpinversion_tpu_torch.parallel.sweep import BatchedEDICT

    size = pipe.config.image_size
    out = {"f32_cast_cost": f32_cast_cost(pipe)}
    print("edict_f32_cast_cost", json.dumps(out["f32_cast_cost"]), flush=True)
    imgs, pairs, src, tar, tensors = _edict_inputs(pipe, 31)
    warm = edict_editor.EDICTEditor(_pipe_at(pipe, EDICT_WARMUP_STEPS), "df64")
    _, t_warm = _sync_time(lambda: warm("edict+p2p", imgs[0], *pairs[0]))

    editor = edict_editor.EDICTEditor(_pipe_at(pipe, EDICT_STEPS), "df64")
    passes, seconds = [], {}
    scan = edict_editor.coupled_scan

    def timed_scan(unet, schedule, pair, context, g, t_limit, reverse, *args, **kwargs):
        out, dt = _sync_time(lambda: scan(unet, schedule, pair, context, g, t_limit, reverse,
                                          *args, **kwargs))
        passes.append({"t_limit": t_limit, "reverse": reverse,
                       "rows": 3 if kwargs.get("edit_context") is not None else 2, "s": dt})
        return out

    restore = _timed_calls([(editor, "encode_image"), (editor, "decode_image")], seconds)
    edict_editor.coupled_scan = timed_scan
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    try:
        strip, t_edit = _sync_time(lambda: editor("edict+p2p", imgs[0], *pairs[0]))
    finally:
        edict_editor.coupled_scan = scan
        restore()
    peak = torch.cuda.max_memory_allocated() / 2**30
    calls = edict_unet_calls(EDICT_STEPS)
    counts = _check_f32_launches("edict+p2p", calls)
    _check_strip(strip)
    out["edict+p2p"] = {
        "precision": "df64", "steps": EDICT_STEPS, "warmup_edit_s": t_warm,
        "edit_s_per_image": t_edit, "passes": passes, "codec_s": seconds, "peak_mem_gib": peak,
        "launches": counts, "unet_calls": calls,
        "edit_panel_std": float(strip[:, 3 * size:].std())}
    print("edict", json.dumps(out["edict+p2p"]), flush=True)
    out["trace"] = edict_trace(pipe, imgs[0], pairs[0])
    print("edict_trace", json.dumps(out["trace"]), flush=True)

    short = edict_editor.EDICTEditor(_pipe_at(pipe, EDICT_SHORT_STEPS), "f32")
    _reset_counts()
    strip, t = _sync_time(lambda: short("edict+direct_forward", imgs[0], *pairs[0]))
    calls = edict_unet_calls(EDICT_SHORT_STEPS)
    _check_strip(strip)
    out["edict+direct_forward"] = {
        "precision": "f32", "steps": EDICT_SHORT_STEPS, "edit_s": t, "unet_calls": calls,
        "launches": _check_f32_launches("edict+direct_forward", calls),
        "edit_panel_std": float(strip[:, 3 * size:].std())}
    print("edict", json.dumps({"method": "edict+direct_forward",
                               **out["edict+direct_forward"]}), flush=True)

    bpipe = _pipe_at(pipe, EDICT_BATCH_STEPS)
    single = edict_editor.EDICTEditor(bpipe, "df64")
    with torch.inference_mode():
        trip = [single.decode_image(single.encode_image(im, dtype=torch.float32))[0]
                for im in imgs]
    calls = edict_unet_calls(EDICT_BATCH_STEPS)
    for method in edict_editor.METHODS:
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        (recon, edits), t_batch = _sync_time(lambda: BatchedEDICT(bpipe, "df64").edit_batch(
            method, imgs, src, tar, tensors))
        counts = _check_f32_launches(f"batched {method}", calls)
        row = {"precision": "df64", "steps": EDICT_BATCH_STEPS, "batch": BATCH,
               "batch_s": t_batch, "batch_s_per_image": t_batch / BATCH,
               "batch_launches": counts, "unet_calls": calls,
               "batch_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        diffs = collections.defaultdict(list)
        for i in range(BATCH):
            strip = single(method, imgs[i], *pairs[i])
            _check_strip(strip)
            for name, got, col in (("recon", recon[i], 2), ("edit", edits[i], 3)):
                diffs[f"{name}_vs_single_max_mean"].append(
                    _diff(got, strip[:, col * size:(col + 1) * size]))
            diffs["batched_recon_vs_f32_vae_round_trip_max_mean"].append(_diff(recon[i], trip[i]))
            diffs["single_recon_vs_f32_vae_round_trip_max_mean"].append(
                _diff(strip[:, 2 * size:3 * size], trip[i]))
        row["uint8_diff"] = dict(diffs)
        out[f"batched {method}"] = row
        print("edict", json.dumps({"method": f"batched {method}", **row}), flush=True)
        far = {k: v for k, v in diffs.items() if max(m for m, _ in v) > F32_PANEL_TOL}
        if far:
            raise AssertionError(f"batched {method}: panels more than {F32_PANEL_TOL} uint8 "
                                 f"levels from the editor's or the f32 VAE round trip: {far}")

    out["round_trip"] = edict_round_trip(pipe, imgs[0])
    print("edict_round_trip", json.dumps(out["round_trip"]), flush=True)
    return out


# sampling steps of the counted instruction edits and the batch (50 before
# the tp and w8 phases joined)
INSTRUCT_STEPS = 20
INSTRUCTIONS = ("make the cake square", "turn the plate into glass", "put candles on the cake",
                "make it a chocolate cake")


def instruct_phase() -> dict:
    """InstructPix2Pix and InstructDiffusion on an IP2P pipeline (SD1.4 with
    the 8-channel UNet, random weights from seed 0, bf16; the UNet and the
    decode compute in f32, as the f32 sigmas make the layers compute in
    both packages): one counted edit of each method at
    ``INSTRUCT_STEPS`` after a warm-up at 2, and ``BatchedInstruct`` on 4
    images (an instruction each) at ``INSTRUCT_STEPS`` after a warm-up batch
    at 2: seconds per image, launches, peak memory, each image within
    ``F32_PANEL_TOL`` of the single-image editor's."""
    from pnpinversion_tpu_torch.configs import IP2P
    from pnpinversion_tpu_torch.editors.instruct_editor import VARIANTS, InstructEditor
    from pnpinversion_tpu_torch.parallel.sweep import BatchedInstruct
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    pipe, t_create = _sync_time(lambda: SDPipeline.create(IP2P, seed=0,
                                                          num_ddim_steps=INSTRUCT_STEPS))
    if pipe.dtype != torch.bfloat16 or pipe.unet.conv_in.weight.shape[1] != 8:
        raise AssertionError(f"an IP2P pipeline: bf16, 8 UNet input channels, got {pipe.dtype}, "
                             f"{pipe.unet.conv_in.weight.shape[1]}")
    size = pipe.config.image_size
    image = _random_images(919, size)
    imgs = np.stack([image() for _ in range(BATCH)])
    editor = InstructEditor(pipe)
    out = {"create_s": t_create}
    for method in VARIANTS:
        _, t_warm = _sync_time(lambda: editor(method, imgs[0], INSTRUCTIONS[0], steps=2))
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        strip, t = _sync_time(lambda: editor(method, imgs[0], INSTRUCTIONS[0],
                                             steps=INSTRUCT_STEPS))
        counts = _check_f32_launches(method, INSTRUCT_STEPS)
        _check_strip(strip)
        if strip[:, 3 * size:].std() == 0.0:
            raise AssertionError(f"{method}: the edit panel is constant")
        out[method] = {"steps": INSTRUCT_STEPS, "warmup_edit_2_steps_s": t_warm, "edit_s": t,
                       "launches": counts, "unet_calls": INSTRUCT_STEPS,
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "edit_panel_std": float(strip[:, 3 * size:].std()), "strip": strip}
    method = "instruct-pix2pix"
    text = torch.stack([pipe.encode_prompt([s]) for s in INSTRUCTIONS[:BATCH]])
    _, t_warm = _sync_time(lambda: BatchedInstruct(pipe, steps=2).edit_batch(method, imgs, text))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    edits, t_batch = _sync_time(lambda: BatchedInstruct(pipe).edit_batch(method, imgs, text))
    counts = _check_f32_launches(f"batched {method}", INSTRUCT_STEPS)
    if edits.shape != (BATCH, size, size, 3) or edits.dtype != np.uint8:
        raise AssertionError(f"batched {method}: {edits.shape} {edits.dtype}")
    singles = [out[method]["strip"]] + [editor(method, imgs[i], INSTRUCTIONS[i],
                                               steps=INSTRUCT_STEPS) for i in range(1, BATCH)]
    out[f"batched {method}"] = {
        "steps": INSTRUCT_STEPS, "batch": BATCH, "warmup_batch_2_steps_s": t_warm,
        "batch_s": t_batch, "batch_s_per_image": t_batch / BATCH,
        "single_over_batched_per_image": out[method]["edit_s"] * BATCH / t_batch,
        "batch_launches": counts, "batch_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "edit_vs_single_max_mean": [_diff(e, st[:, 3 * size:]) for e, st in zip(edits, singles)]}
    worst = max(m for m, _ in out[f"batched {method}"]["edit_vs_single_max_mean"])
    if worst > F32_PANEL_TOL:
        raise AssertionError(f"batched {method}: an edit {worst} uint8 levels from the "
                             f"single-image editor's (limit {F32_PANEL_TOL})")
    for name in VARIANTS:
        out[name].pop("strip")
    del pipe
    torch.cuda.empty_cache()
    return out


TRAIN_DIR = "build/smoke_training"  # git-ignored; removed when the phase ends
TRAIN_CAPTIONS = ("a round cake with orange frosting on a wooden plate",
                  "a red bicycle leaning on a brick wall")
PAIR_STEPS = 3  # Euler steps of the candidate pairs: the shapes do not depend on the steps
PAIR_BATCH = 4  # candidates per sampler call (the runner's default): 16 UNet rows
# random weights make CLIP's similarities meaningless, so the default
# thresholds (0.2, 0.2, 0.7) could keep no pair: the smoke keeps every one
KEEP_ALL = (-1.0, -1.0, -1.0)
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_CROP = 8, 2, 256
TRAIN_STEPS = 3  # counted optimizer steps before the save
# the flash sites of a 256^2 crop: the 32^2 self-attention of down_blocks[0]
# (x2) and up_blocks[3] (x3); the 16^2 and 8^2 sites are shorter than the
# kernel's 1024
TRAIN_SITES = 5
# the same step from the same state and draws, run again: the forward is
# deterministic, so the loss must repeat exactly; the gradients do not (the
# bf16 backward reduces dQ with bulk reduce-adds in varying order, and
# cuDNN's weight-gradient convolutions may run in varying order), so the
# grad norm and the updated parameters only within these bounds
TRAIN_GNORM_RTOL = 1e-3
TRAIN_PARAM_ATOL_LR = 0.1  # max |param difference| after the step, in units of the lr


def _train_batches(ds, n: int) -> list:
    """n host batches of TRAIN_ACCUM microbatches of TRAIN_BATCH items."""
    from pnpinversion_tpu_torch.training.data import batches

    stream = batches(ds, TRAIN_BATCH, seed=0)
    out = []
    for _ in range(n):
        parts = [next(stream) for _ in range(TRAIN_ACCUM)]
        out.append({"edited": np.stack([p["edited"] for p in parts]),
                    "cond_image": np.stack([p["cond_image"] for p in parts]),
                    "edits": [p["edit"] for p in parts]})
    return out


def _check_train_launches(name: str, counts: dict, steps: int, remat: bool) -> None:
    micro = steps * TRAIN_ACCUM
    want_fwd = TRAIN_SITES * micro * (2 if remat else 1)
    if not (counts["fwd"] == want_fwd
            and counts["prep"] == counts["main"] == counts["convert"] == TRAIN_SITES * micro):
        raise AssertionError(f"{name}: launches {counts}, want {want_fwd} forward and "
                             f"{TRAIN_SITES * micro} of each backward kernel ({TRAIN_SITES} "
                             f"sites x {micro} microbatches{', remat' if remat else ''})")


def training_phase() -> dict:
    """The InstructPix2Pix training path at full SD1.4 width (random weights
    from seed 0, bf16): ``generate_prompt_dataset`` with the template
    completions on 2 captions; ``generate_for_prompt`` for each (512^2,
    ``PAIR_BATCH`` candidates in one sampler call of 16 rows at
    ``PAIR_STEPS`` Euler steps, the full-width CLIP filter: ViT-L/14 and its
    768-wide text tower), counted; ``prepare_dataset`` and ``EditPairDataset``
    at 256^2 crops; then ``EditTrainer`` on the same pipeline's UNet widened
    to 8 channels by ``extend_conv_in`` (bf16 compute, f32 masters; batch 8,
    accumulation 2): ``TRAIN_STEPS`` counted optimizer steps, a save, the
    next step, that step again with remat after a restore (counted: the
    forward twice) and once more after another restore without remat, each
    against the uninterrupted step (the remat step from a copy of the state
    on the card, the other from the file); a validation step. Seconds per step,
    peak memory of the training, the losses and grad norms."""
    import shutil

    from pnpinversion_tpu_torch.configs import IP2P, SD14
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.training import dataset_creation as dc
    from pnpinversion_tpu_torch.training import prompt_dataset as pd
    from pnpinversion_tpu_torch.training import trainer as tr
    from pnpinversion_tpu_torch.training.data import EditPairDataset

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out = {}
    prompts_path = f"{TRAIN_DIR}/prompts.jsonl"
    calls = iter(range(len(TRAIN_CAPTIONS)))
    n = pd.generate_prompt_dataset(TRAIN_CAPTIONS, lambda p: pd.template_complete(p, next(calls)),
                                   prompts_path, len(TRAIN_CAPTIONS))
    prompts = dc.load_prompts(prompts_path)
    if not n == len(prompts) == len(TRAIN_CAPTIONS):
        raise AssertionError(f"the prompt dataset holds {n} records, want {len(TRAIN_CAPTIONS)}")

    pipe, t_create = _sync_time(lambda: SDPipeline.create(SD14, seed=0))
    generator = dc.PairGenerator(pipe, PAIR_STEPS)
    clip, t_clip = _sync_time(lambda: dc.PairClipFilter(tokenizer=pipe.tokenizer,
                                                        device=pipe.device))
    pairs_dir = f"{TRAIN_DIR}/pairs"
    _reset_counts()
    seconds = []
    for i, prompt in enumerate(prompts):
        kept, t = _sync_time(lambda: dc.generate_for_prompt(
            prompt, f"{pairs_dir}/{i:07d}", generator, clip, n_samples=PAIR_BATCH,
            max_out_samples=PAIR_BATCH, batch=PAIR_BATCH, thresholds=dc.FilterThresholds(*KEEP_ALL),
            rng=np.random.default_rng(np.random.SeedSequence([0, i]))))
        seconds.append(t)
        if kept != PAIR_BATCH:
            raise AssertionError(f"prompt {i}: {kept} pairs kept, want {PAIR_BATCH}")
    counts = _counts()
    want = {"fwd": FLASH_SITES * PAIR_STEPS * len(prompts), "prep": 0, "main": 0, "convert": 0}
    if counts != want:
        raise AssertionError(f"pair generation launched {counts}, want {want}")
    dc.prepare_dataset(pairs_dir)
    ds = EditPairDataset(pairs_dir, splits=(1.0, 0.0, 0.0), min_resize_res=TRAIN_CROP,
                         max_resize_res=TRAIN_CROP, crop_res=TRAIN_CROP, flip_prob=0.5)
    item = ds.get(0, np.random.default_rng(0))
    if len(ds) != len(prompts) or item["edited"].shape != (TRAIN_CROP, TRAIN_CROP, 3):
        raise AssertionError(f"the pair dataset: {len(ds)} items, {item['edited'].shape}")
    out["dataset_creation"] = {
        "prompts": len(prompts), "pairs_per_prompt": PAIR_BATCH, "euler_steps": PAIR_STEPS,
        "unet_rows": 4 * PAIR_BATCH, "clip_thresholds": KEEP_ALL, "create_s": t_create,
        "clip_filter_create_s": t_clip, "generate_for_prompt_s": seconds, "launches": counts}
    print("dataset_creation", json.dumps(out["dataset_creation"]), flush=True)

    # the trainer on the same pipeline's UNet widened to 8 channels (the ip2p
    # init); the pipeline's own UNet then goes, to leave the card to training
    unet8 = tr.extend_conv_in(pipe.unet, IP2P.unet.in_channels)
    pipe.unet = None
    del generator
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = tr.TrainConfig(accum=TRAIN_ACCUM, dtype=torch.bfloat16)
    trainer, t_trainer = _sync_time(lambda: tr.EditTrainer(
        IP2P, {"vae": pipe.vae, "text": pipe.text_encoder}, unet8, cfg, TRAIN_BATCH,
        pipe.tokenize([""])[0]))
    del unet8
    host = _train_batches(ds, TRAIN_STEPS + 2)
    batches_ = [{"edited": b["edited"], "cond_image": b["cond_image"],
                 "ids": torch.stack([pipe.tokenize(e) for e in b["edits"]])} for b in host]

    def step(i: int):
        return trainer.train_step(batches_[i], tr.step_generator(0, i, trainer.device))

    _reset_counts()
    metrics, step_s = [], []
    for i in range(TRAIN_STEPS):
        m, t = _sync_time(lambda: step(i))
        metrics.append({k: float(v) for k, v in m.items()})
        step_s.append(t)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_train_launches("training", counts, TRAIN_STEPS, remat=False)
    if not all(np.isfinite(list(m.values())).all() and m["grad_norm"] > 0 for m in metrics):
        raise AssertionError(f"training metrics {metrics}")
    path, t_save = _sync_time(lambda: trainer.save(TRAIN_DIR))
    # the state on the card too: the remat step starts from it without a
    # second read of the file
    saved = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
             for k, v in trainer.state_dict().items()}
    ref, t_ref = _sync_time(lambda: step(TRAIN_STEPS))
    ref = {k: float(v) for k, v in ref.items()}
    after = [p.detach().clone() for p in trainer.params]
    lr = trainer.learning_rate(TRAIN_STEPS)

    def again(remat: bool) -> dict:
        _, t_restore = _sync_time(lambda: trainer.load_state_dict(saved) if remat
                                  else trainer.restore(path))
        if trainer.step != TRAIN_STEPS:
            raise AssertionError(f"restored at step {trainer.step}, want {TRAIN_STEPS}")
        trainer.cfg = dataclasses.replace(cfg, remat=remat)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        m, t = _sync_time(lambda: step(TRAIN_STEPS))
        counts = _counts()
        _check_train_launches(f"training step{' with remat' if remat else ''} after a restore",
                              counts, 1, remat)
        m = {k: float(v) for k, v in m.items()}
        dp = max((a - p.detach()).abs().max().item() for a, p in zip(after, trainer.params))
        row = {"loss": m["loss"], "grad_norm": m["grad_norm"], "step_s": t,
               "restore_s": t_restore, "launches": counts,
               "grad_norm_rel_diff": abs(m["grad_norm"] / ref["grad_norm"] - 1.0),
               "param_max_abs_diff": dp, "param_max_abs_diff_in_lr": dp / lr,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        if (m["loss"] != ref["loss"] or row["grad_norm_rel_diff"] > TRAIN_GNORM_RTOL
                or row["param_max_abs_diff_in_lr"] > TRAIN_PARAM_ATOL_LR):
            raise AssertionError(f"the step {'with remat ' if remat else ''}after a restore "
                                 f"{row} differs from the uninterrupted one {ref} (limits: the "
                                 f"loss equal, grad norm {TRAIN_GNORM_RTOL} rel, params "
                                 f"{TRAIN_PARAM_ATOL_LR} lr)")
        return row

    remat = again(True)
    del saved
    resumed = again(False)
    trainer.cfg = cfg
    val, t_val = _sync_time(lambda: trainer.val_step(batches_[-1], tr.step_generator(1, 0,
                                                                                    trainer.device)))
    if val.dtype != torch.float32 or not torch.isfinite(val):
        raise AssertionError(f"val_step gave {val}")
    out["training"] = {
        "batch_per_step": TRAIN_BATCH, "accumulate_grad_batches": TRAIN_ACCUM,
        "crop_res": TRAIN_CROP, "dtype": "bf16 compute, f32 masters", "lr": lr,
        "trainer_create_s": t_trainer, "step_s": step_s, "metrics": metrics, "launches": counts,
        "peak_mem_gib": peak, "save_s": t_save, "checkpoint_gib": os.path.getsize(path) / 2**30,
        "uninterrupted_step": {**ref, "step_s": t_ref}, "remat_after_restore": remat,
        "resumed_step": resumed, "val_loss": float(val), "val_s": t_val}
    print("training", json.dumps(out["training"]), flush=True)
    del trainer, after, clip, pipe
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


F32_DI_STEPS = 50        # DDIM steps of the f32 directinversion+p2p edit
F32_NULL_TEXT_STEPS = 3  # and of the f32 null-text edit (10 inner steps each)
F32_BWD_KERNELS = {"dq": "flash_bwd_dq_f32_kernel", "dkv": "flash_bwd_dkv_f32_kernel",
                   "split": "flash_bwd_f32_split_kernel"}


def f32_null_text_trace(pipe, image: np.ndarray) -> dict:
    """One f32 ``null-text-inversion+p2p`` edit at ``F32_NULL_TEXT_STEPS``
    under torch.profiler (at 1 step the random-weight edit stops after one
    inner step, so its trace would hold one backward UNet call among six
    forward ones): the device seconds of the f32 backward's kernels (dQ,
    dK/dV and their split pass) summed and per launch, by head dim (d = 40
    at the 64^2 sites, 80 at 32^2: the kernels' template arguments), their
    launches in the trace against the same edit's count without the
    profiler (one dQ and one dK/dV per differentiated site per inner step,
    a split pass before each), and their share of the sum of every kernel's
    traced time and of that edit's wall time."""
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

    editor = P2PEditor(dataclasses.replace(pipe,
                                           schedule=make_ddim_schedule(F32_NULL_TEXT_STEPS)))
    _reset_counts()
    _, t_plain = _sync_time(lambda: editor(NULL_TEXT, image, SRC, TAR, **EDIT_KW))
    counts = _f32_counts()
    wall, us, n = _device_trace(lambda: editor(NULL_TEXT, image, SRC, TAR, **EDIT_KW))
    kernel_sum = sum(us.values()) / 1e6
    by_kernel = {}
    for key, pattern in F32_BWD_KERNELS.items():
        for name in us:
            if pattern not in name:
                continue
            args = re.search(r"<(\d+), (\d+)>", name)
            d = f"d{8 * int(args.group(2))}" if args else "all"
            row = by_kernel.setdefault(key, {}).setdefault(d, {"device_s": 0.0, "launches": 0})
            row["device_s"] += us[name] / 1e6
            row["launches"] += n[name]
    launches = {k: sum(r["launches"] for r in rows.values()) for k, rows in by_kernel.items()}
    if not (launches.get("dq") == launches.get("dkv") == counts["dq"] == counts["dkv"] > 0
            and launches.get("split") == counts["bwd_split"] == 2 * counts["dq"]):
        raise AssertionError(f"the traced f32 null-text edit launched the backward's kernels "
                             f"{launches} times, its untraced run {counts}")
    for rows in by_kernel.values():
        for row in rows.values():
            row["ms_per_launch"] = row["device_s"] * 1e3 / row["launches"]
    bwd = sum(r["device_s"] for rows in by_kernel.values() for r in rows.values())
    return {"steps": F32_NULL_TEXT_STEPS, "inner_steps": counts["dq"] // BWD_SITES,
            "edit_s": t_plain, "traced_edit_s": wall, "kernel_time_sum_s": kernel_sum,
            "bwd_device_s": bwd, "bwd_ms_per_backward": bwd * 1e3 / counts["dq"],
            "bwd_share_of_kernel_time_sum": bwd / kernel_sum, "bwd_share_of_edit": bwd / t_plain,
            "by_kernel": by_kernel, "launches": launches,
            "top": [{"kernel": k[:90], "s": v / 1e6} for k, v in us.most_common(8)]}


def f32_path_phase() -> dict:
    """The f32 pipeline on the card at full SD1.4 width (random weights from
    seed 0, 512^2): ``SDPipeline.create(..., dtype=torch.float32)``, one
    directinversion+p2p edit at ``F32_DI_STEPS`` and one
    null-text-inversion+p2p edit at ``F32_NULL_TEXT_STEPS`` (its inner Adam
    loop runs the f32 backward kernels), each timed, its peak memory read and
    its launches of every kernel counted against the code's own count: only
    the f32 kernels run. Then ``f32_null_text_trace``, and one UNet call with
    TF32 on against full f32, the number beside the f32 policy
    (``utils.device.use_full_f32``)."""
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: create must turn it off
    pipe, t_create = _sync_time(lambda: SDPipeline.create(
        SD14, seed=0, num_ddim_steps=F32_DI_STEPS, device="cuda", dtype=torch.float32))
    if (pipe.dtype != torch.float32 or torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("an f32 pipeline on the card must run with TF32 off")
    size = pipe.config.image_size
    image = _random_images(4242, size)
    out = {"create_s": t_create}
    no_bf16 = {"fwd": 0, "prep": 0, "main": 0, "convert": 0}
    for method, steps in (("directinversion+p2p", F32_DI_STEPS),
                          (NULL_TEXT, F32_NULL_TEXT_STEPS)):
        editor = P2PEditor(dataclasses.replace(pipe, schedule=make_ddim_schedule(steps)))
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        strip, t = _sync_time(lambda: editor(method, image(), SRC, TAR, **EDIT_KW))
        counts, bf16 = _f32_counts(), _counts()
        _check_strip(strip)
        inner = counts["dq"] // BWD_SITES
        calls = 2 * steps if method == "directinversion+p2p" else 5 * steps + inner
        ok = (bf16 == no_bf16 and counts["dq"] == counts["dkv"] == BWD_SITES * inner
              and counts["bwd_split"] == counts["dq"] + counts["dkv"]
              and counts["fwd"] == counts["split"] == FLASH_SITES * calls
              and (steps <= inner <= NULL_TEXT_INNER * steps if method == NULL_TEXT
                   else inner == 0))
        if not ok:
            raise AssertionError(f"f32 {method}: launches {counts} (bf16 kernels {bf16}), want "
                                 f"{FLASH_SITES} forward per UNet call and {BWD_SITES} of each "
                                 f"backward kernel per inner step (and one split pass each), "
                                 f"no bf16 kernel")
        out[method] = {"steps": steps, "edit_s": t, "launches": counts,
                       "inner_steps_total": inner,
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "edit_panel_std": float(strip[:, 3 * size:].std())}
        print("f32_path", json.dumps({"method": method, **out[method]}), flush=True)
    out["f32_null_text_trace"] = f32_null_text_trace(pipe, image())
    print("f32_null_text_trace", json.dumps(out["f32_null_text_trace"]), flush=True)

    # one UNet call, full f32 against TF32 (cuDNN's convolutions only, PyTorch's
    # default, and the matrix products too)
    gen = torch.Generator(device=pipe.device).manual_seed(5)
    lat = pipe.latent_size
    x = torch.randn((1, lat, lat, 4), generator=gen, device=pipe.device)
    ctx = pipe.encode_prompt([SRC])
    with torch.inference_mode():
        full, _ = pipe.unet(x, 500, ctx)
        diffs = {}
        for name, matmul in (("cudnn_tf32", False), ("cudnn_and_matmul_tf32", True)):
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = matmul
            try:
                eps, _ = pipe.unet(x, 500, ctx)
            finally:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            diffs[name] = {"max_abs": (eps - full).abs().max().item(),
                           "rel_to_max": _rel(eps, full)}
    out["unet_eps_tf32_vs_full_f32"] = diffs
    del pipe
    torch.cuda.empty_cache()
    return out


EVAL_METHOD = "1_directinversion+p2p"
# each metric on the card against the same calculator on the host CPU: f32
# on both sides, sums in other orders (cuDNN and cuBLAS against the CPU's)
# through towers of up to 24 layers
EVAL_CPU_RTOL = 1e-3


def _eval_data(root: str, out: dict) -> str:
    """The batched path's images and strips in the runners' layout under
    ``root``: ``data/annotation_images/<rel>`` (the inputs),
    ``output/directinversion+p2p/annotation_images/<rel>`` (4-panel strips),
    and ``data/mapping_file.json``, whose masks are ``mask_encode`` of seeded
    rectangles but for the last item, which has none. Returns the mapping
    file's path."""
    import os

    from PIL import Image

    from pnpinversion_tpu_torch.data.pie_bench import mask_encode
    from pnpinversion_tpu_torch.utils.image import make_strip, txt_draw

    rng = np.random.RandomState(6)
    images, size = out["images"], out["images"].shape[1]
    mapping = {}
    for i, img in enumerate(images):
        rel = f"{i}_random/{i:03d}.jpg"
        for folder, panel in (("data/annotation_images", img),
                              ("output/directinversion+p2p/annotation_images", make_strip([
                                  txt_draw(f"source prompt: {SRC}\ntarget prompt: {TAR}"),
                                  img, out["recon"][i], out["edit"][i]]))):
            path = os.path.join(root, folder, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(panel).save(path)
        item = {"image_path": rel, "original_prompt": SRC.replace("round", "[round]"),
                "editing_prompt": TAR.replace("square", "[square]"),
                "editing_instruction": "make the cake square", "editing_type_id": str(i),
                "blended_word": "cake cake"}
        if i < len(images) - 1:
            top, left = rng.randint(0, size // 2, 2)
            mask = np.zeros((size, size), np.uint8)
            mask[top : top + size // 3, left : left + size // 4] = 1
            item["mask"] = mask_encode(mask)
        mapping[f"{i:09d}"] = item
    path = os.path.join(root, "data", "mapping_file.json")
    with open(path, "w") as f:
        json.dump(mapping, f)
    return path


def eval_phase(batch_out: dict, calc=None) -> dict:
    """The PIE-Bench evaluator on the card at full width (CLIP ViT-L/14 vision
    and text towers, DINO ViT-B/8, SqueezeNet LPIPS; random weights from seed
    0, f32): ``evaluate()`` over the batched path's strips with
    ``DEFAULT_METRICS``. Checks the CSV's header, one row per item, every
    number finite and "nan" exactly where ``_nan_sentinel`` says; then the
    first image's row, and its raw CLIP cosines, against the same calculator
    with the same weights on the host CPU (``EVAL_CPU_RTOL``). Seconds per
    evaluated image and per metric family, peak memory. ``calc`` replaces the
    full-width calculator on the card (a CPU rehearsal at TINY)."""
    import copy
    import csv
    import os
    import tempfile

    from PIL import Image

    from pnpinversion_tpu_torch.data.pie_bench import mask_decode
    from pnpinversion_tpu_torch.evaluation import evaluate as ev
    from pnpinversion_tpu_torch.evaluation.calculator import MetricsCalculator

    t_init = None
    if calc is None:
        calc, t_init = _sync_time(lambda: MetricsCalculator(seed=0))
        if calc.device.type != "cuda" or calc.clip_vision.config.width != 1024:
            raise AssertionError("the evaluator must run on the card at full width")
    family_s: dict = {}
    for name in ("psnr", "mse", "ssim", "lpips", "clip_similarity", "structure_distance"):
        fn = getattr(calc, f"calculate_{name}")

        def timed(*args, _fn=fn, _name=name):
            value, dt = _sync_time(lambda: _fn(*args))
            family_s.setdefault(_name, []).append(dt)
            return value

        setattr(calc, f"calculate_{name}", timed)
    with tempfile.TemporaryDirectory() as root:
        mapping_path = _eval_data(root, batch_out)
        folders = {EVAL_METHOD: ev.all_tgt_image_folders(os.path.join(root, "output"))[EVAL_METHOD]}
        result = os.path.join(root, "result.csv")
        src_folder = os.path.join(root, "data", "annotation_images")
        torch.cuda.reset_peak_memory_stats()
        _, t_eval = _sync_time(lambda: ev.evaluate(mapping_path, ev.DEFAULT_METRICS, src_folder,
                                                   folders, result, [str(i) for i in range(10)],
                                                   calc))
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name in family_s:
            delattr(calc, f"calculate_{name}")  # the class's own methods again
        with open(result) as f:
            rows = list(csv.reader(f))
        sharded = _sharded_eval(calc, mapping_path, src_folder, folders, rows, t_eval,
                                os.path.join(root, "sharded.csv"))
        with open(mapping_path) as f:
            mapping = json.load(f)
        head = ["file_id"] + [f"{EVAL_METHOD}|{m}" for m in ev.DEFAULT_METRICS]
        if rows[0] != head or [r[0] for r in rows[1:]] != list(mapping):
            raise AssertionError(f"evaluation CSV: header {rows[0]}, ids {[r[0] for r in rows]}")
        for row, item in zip(rows[1:], mapping.values()):
            has_mask = "mask" in item
            mask = (mask_decode(item["mask"]) if has_mask else np.zeros((512, 512)))[..., None]
            for m, cell in zip(ev.DEFAULT_METRICS, row[1:]):
                nan = ev._nan_sentinel(m, mask.repeat(3, axis=2), has_mask,
                                       item["original_prompt"])
                if nan != (cell == "nan") or (not nan and not np.isfinite(float(cell))):
                    raise AssertionError(f"evaluation CSV: {row[0]} {m} = {cell!r}")

        # the first image's row on the host CPU, with the card's weights
        host = copy.copy(calc)
        host.device = torch.device("cpu")
        for name in ("clip_vision", "clip_text", "clip_text_proj", "lpips", "dino"):
            setattr(host, name, copy.deepcopy(getattr(calc, name)).cpu())
        item = next(iter(mapping.values()))
        mask = mask_decode(item["mask"])[..., None].repeat(3, axis=2)
        src = Image.open(os.path.join(src_folder, item["image_path"]))
        tgt = ev.crop_edit_panel(Image.open(os.path.join(folders[EVAL_METHOD],
                                                         item["image_path"])))
        src_p, tgt_p = (x.replace("[", "").replace("]", "") for x in
                        (item["original_prompt"], item["editing_prompt"]))
        worst, values, t0 = {}, {}, time.perf_counter()
        for m, cell in zip(ev.DEFAULT_METRICS, rows[1][1:]):
            want = ev.calculate_metric(host, m, src, tgt, mask, mask, src_p, tgt_p)
            values[m] = [float(cell), want]
        for name, img, txt in (("raw_clip_cos_source", src, src_p),
                               ("raw_clip_cos_target", tgt, tgt_p)):
            values[name] = [calc.clip_cosine(img, txt), host.clip_cosine(img, txt)]
        t_host = time.perf_counter() - t0
        for name, (got, want) in values.items():
            worst[name] = abs(got - want) / max(abs(want), 1e-6)
    if max(worst.values()) > EVAL_CPU_RTOL:
        raise AssertionError(f"the card's metrics differ from the CPU's: {worst}")
    n = len(mapping)
    return {"items": n, "metrics": ev.DEFAULT_METRICS, "calculator_init_s": t_init,
            "evaluate_s": t_eval, "s_per_image": t_eval / n,
            "s_per_family": {k: sum(v) for k, v in family_s.items()},
            "calls_per_family": {k: len(v) for k, v in family_s.items()},
            "peak_mem_gib": peak, "rel_diff_card_vs_cpu_first_row": worst,
            "first_row_card_cpu": values, "cpu_row_s": t_host, "sharded": sharded}


def _sharded_eval(calc, mapping_path: str, src_folder: str, folders: dict, rows: list,
                  t_serial: float, result: str) -> dict:
    """``evaluate(sharded=True)`` over the same strips, all the items in one
    batch (``ShardedEvaluator``: one forward of each metric model over the
    batch): its CSV against the serial one (``rows``), every cell within
    EVAL_CPU_RTOL and "nan" in the same places; seconds per evaluated image
    both ways (the batched one after a first call, which builds nothing but
    warms the allocator)."""
    import csv

    from pnpinversion_tpu_torch.evaluation import evaluate as ev

    n = len(rows) - 1
    cats = [str(i) for i in range(10)]
    run = lambda: ev.evaluate(mapping_path, ev.DEFAULT_METRICS, src_folder, folders, result,
                              cats, calc, sharded=True, batch_size=n)
    _, t_first = _sync_time(run)
    torch.cuda.reset_peak_memory_stats()
    _, t = _sync_time(run)
    with open(result) as f:
        got = list(csv.reader(f))
    worst = 0.0
    if got[0] != rows[0] or [r[0] for r in got] != [r[0] for r in rows]:
        raise AssertionError(f"the batched CSV's header or ids differ: {got[0]}")
    for g_row, s_row in zip(got[1:], rows[1:]):
        for g, w in zip(g_row[1:], s_row[1:]):
            if (g == "nan") != (w == "nan"):
                raise AssertionError(f"batched {g_row} against serial {s_row}")
            if w != "nan":
                worst = max(worst, abs(float(g) - float(w)) / max(abs(float(w)), 1e-6))
    if worst > EVAL_CPU_RTOL:
        raise AssertionError(f"the batched evaluator is {worst} from the serial one (limit "
                             f"{EVAL_CPU_RTOL})")
    return {"batch": n, "s_per_image": t / n, "first_call_s_per_image": t_first / n,
            "serial_s_per_image": t_serial / n, "max_rel_diff_vs_serial": worst,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


# ---------------------------------------------------------------------------
# the last three editing families: Blended Latent Diffusion (SD2.1),
# pix2pix-zero (with its BLIP captioner) and StyleDiffusion
# ---------------------------------------------------------------------------

BLD_STEPS = 20  # DDIM steps of the counted BLD edit and batch (50 before the tp and w8 phases)
P2Z_STEPS = 5  # of the counted pix2pix-zero edits and batch
SD_STEPS = 3  # of the counted StyleDiffusion edit and batch
SD_INNER = 3  # StyleDiffusion's inner Adam steps (the editor's default is 100)
# the flash sites whose backward runs: all ten in pix2pix-zero's map-loss
# gradient with respect to the latent; nine in StyleDiffusion's training,
# whose networks enter at the cross-attention (after the first self site)
P2Z_BWD_SITES = FLASH_SITES
SD_BWD_SITES = BWD_SITES


def _discs(n: int, size: int, seed: int) -> np.ndarray:
    """n {0, 1} disc masks (size, size), each of its own centre and radius."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    return np.stack([((yy - rng.uniform(0.3, 0.7) * size) ** 2 + (xx - rng.uniform(0.3, 0.7)
                                                                  * size) ** 2
                      < (rng.uniform(0.15, 0.3) * size) ** 2).astype(np.float32)
                     for _ in range(n)])


def _check_grad_launches(name: str, counts: dict, fwd_calls: int, bwd_sites: int,
                         inner: tuple) -> int:
    """A counted run's launches against the code's own count: one B1 launch
    per flash site per UNet call (``fwd_calls``, plus one per backward pass),
    one of each backward kernel per differentiated site per backward pass,
    K backward passes with inner[0] <= K <= inner[1]. Returns K."""
    k = counts["main"] // bwd_sites
    ok = (counts["prep"] == counts["main"] == counts["convert"] == bwd_sites * k
          and inner[0] <= k <= inner[1] and counts["fwd"] == FLASH_SITES * (fwd_calls + k))
    if not ok:
        raise AssertionError(f"{name}: launches {counts}, want {FLASH_SITES} x ({fwd_calls} + K) "
                             f"forward and {bwd_sites} x K of each backward kernel, "
                             f"K in {inner}")
    return k


def _panel_diffs(batched: dict, singles: list, size: int) -> dict:
    """uint8 (max, mean) difference of each batched image's panels from the
    single-image editor's strip (recon panel 2, edit panel 3)."""
    cols = {"recon": 2, "edit": 3}
    return {f"{name}_vs_single_max_mean": [
        _diff(got, st[:, cols[name] * size:(cols[name] + 1) * size])
        for got, st in zip(images, singles)] for name, images in batched.items()}


def bld_phase() -> dict:
    """Blended Latent Diffusion on its own SD2.1-base pipeline (full width:
    64-dim heads, the 1024-wide OpenCLIP text tower; random weights from seed
    0, bf16, 512^2), made once the SD1.4 pipeline is freed: one counted edit
    at ``BLD_STEPS`` (after a warm-up at 2) with a disc mask, timed; then
    ``BatchedBLD`` on 4 images (a mask and a target prompt each) at
    ``BLD_STEPS``: seconds per image, launches, peak memory, each image's
    edit against the single-image editor's, and images kept in place
    unmoved when the others change (at ``INDEPENDENCE_STEPS``)."""
    from pnpinversion_tpu_torch.configs import SD21
    from pnpinversion_tpu_torch.editors.bld_editor import (
        METHOD,
        BlendedLatentDiffusionEditor,
        bld_unet_calls,
        latent_mask,
    )
    from pnpinversion_tpu_torch.parallel.sweep import BatchedBLD
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    pipe, t_create = _sync_time(lambda: SDPipeline.create(SD21, seed=0,
                                                          num_ddim_steps=BLD_STEPS))
    if pipe.dtype != torch.bfloat16 or pipe.unet.sites[0][0].heads != 5:
        raise AssertionError(f"an SD2.1 pipeline: bf16, 5 heads at 64^2, got {pipe.dtype}, "
                             f"{pipe.unet.sites[0][0].heads}")
    size = pipe.config.image_size
    image = _random_images(3131, size)
    imgs = np.stack([image() for _ in range(BATCH)])
    others = np.stack([image() for _ in range(BATCH)])
    masks = _discs(BATCH, size, 3132)
    targets = [tar for _, tar in CAKE_PROMPTS[:BATCH]]
    calls = bld_unet_calls(BLD_STEPS)
    editor = BlendedLatentDiffusionEditor(pipe)
    _, t_warm = _sync_time(lambda: BlendedLatentDiffusionEditor(_pipe_at(pipe, 2))(
        METHOD, imgs[0], masks[0], targets[0]))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    strip, t_edit = _sync_time(lambda: editor(METHOD, imgs[0], masks[0], targets[0]))
    counts, peak = _counts(), torch.cuda.max_memory_allocated() / 2**30
    _check_strip(strip)
    _check_launches(METHOD, counts, 1, calls)
    if strip[:, 2 * size:3 * size].any() or strip[:, 3 * size:].std() == 0.0:
        raise AssertionError("BLD: the reconstruction panel is not zeros or the edit is constant")

    lat_masks = np.stack([latent_mask(m, pipe.latent_size) for m in masks])
    cond = torch.stack([pipe.encode_prompt([t]) for t in targets])

    def batch(p, images, c=cond):
        return BatchedBLD(p).edit_batch(images, lat_masks, c, 7.5)

    _, t_warm_batch = _sync_time(lambda: batch(_pipe_at(pipe, 2), imgs))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    edits, t_batch = _sync_time(lambda: batch(pipe, imgs))
    batch_counts, batch_peak = _counts(), torch.cuda.max_memory_allocated() / 2**30
    _check_launches(f"batched {METHOD}", batch_counts, 1, calls)
    if edits.shape != (BATCH, size, size, 3) or min(float(e.std()) for e in edits) == 0.0:
        raise AssertionError(f"batched BLD: {edits.shape}, or an edit is constant")
    singles = [strip] + [editor(METHOD, imgs[i], masks[i], targets[i]) for i in range(1, BATCH)]
    diffs = _panel_diffs({"edit": edits}, singles, size)

    kept = (1, 3)
    swapped = np.stack([imgs[i] if i in kept else others[i] for i in range(BATCH)])
    short = _pipe_at(pipe, INDEPENDENCE_STEPS)
    first = batch(short, imgs)
    floor = max(_diff(a, b)[0] for a, b in zip(first, batch(short, imgs)))
    apart = max(_diff(first[i], b)[0] for i, b in zip(kept, batch(short, swapped)[list(kept)]))
    if apart > floor:
        raise AssertionError(f"batched BLD: images kept in place moved by {apart} uint8 levels "
                             f"when the others changed (floor {floor})")
    out = {"create_s": t_create, "steps": BLD_STEPS, "unet_calls": calls,
           "warmup_edit_2_steps_s": t_warm, "edit_s_per_image": t_edit, "launches": counts,
           "peak_mem_gib": peak, "edit_panel_std": float(strip[:, 3 * size:].std()),
           "batch": BATCH, "warmup_batch_2_steps_s": t_warm_batch, "batch_s": t_batch,
           "batch_s_per_image": t_batch / BATCH,
           "single_over_batched_per_image": t_edit * BATCH / t_batch,
           "batch_launches": batch_counts, "batch_peak_mem_gib": batch_peak,
           "uint8_diff_vs_single_editor": diffs, "kept_images_run_to_run_max": floor,
           "kept_images_others_replaced_max": apart}
    print("bld", json.dumps(out), flush=True)
    del pipe, editor
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _blip_vocab(path: str, vocab_size: int) -> str:
    """A BERT-layout vocab.txt of generated tokens: [PAD] 0, [unused*],
    [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, the prompt's words, words
    and "##" pieces, then [DEC] and [ENC] at the end (BLIP's two added
    tokens, [DEC] its decoder's start id)."""
    import os

    words = (["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                  "[MASK]", "a", "picture", "of"])
    n = vocab_size - 2 - len(words)
    words += [f"w{i}" if i % 2 == 0 else f"##p{i}" for i in range(n)] + ["[DEC]", "[ENC]"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(words) + "\n")
    return path


def blip_phase(imgs: np.ndarray) -> tuple:
    """The BLIP captioner at full width (ViT-B/16 at 384^2, 577 tokens; the
    BERT-base decoder with cross-attention; random weights from seed 0, f32;
    a generated 30,524-token vocab): ``caption_batch`` of the images with 3
    beams, timed twice (the same captions both times), and one decoder step's
    logits and the vision tokens of image 0 against a CPU copy (TF32 off on
    the card). Returns (numbers, captions)."""
    import copy
    import os

    from pnpinversion_tpu_torch.models.blip import BLIP_VIT_B16_384, BlipCaptioner, BlipTextConfig
    from pnpinversion_tpu_torch.utils.tokenizer import BertWordPieceTokenizer

    cfg = BlipTextConfig()
    here = os.path.dirname(os.path.abspath(__file__))
    tok = BertWordPieceTokenizer(_blip_vocab(os.path.join(here, "build", "blip_vocab.txt"),
                                             cfg.vocab_size))
    if tok.sep_token_id != cfg.sep_token_id or tok.vocab["[DEC]"] != cfg.bos_token_id:
        raise AssertionError("the generated vocab does not match BLIP's special ids")
    cap, t_create = _sync_time(lambda: BlipCaptioner.random_init(0, tok, BLIP_VIT_B16_384, cfg))
    _, t_warm = _sync_time(lambda: cap.caption_batch(imgs[:1]))
    torch.cuda.reset_peak_memory_stats()
    captions, t_cap = _sync_time(lambda: cap.caption_batch(imgs))
    again, t_again = _sync_time(lambda: cap.caption_batch(imgs))
    if again != captions or len(captions) != len(imgs) or not all(captions):
        raise AssertionError(f"BLIP captions: {captions} then {again}")
    with torch.inference_mode():
        tokens = cap.image_tokens(imgs[:1])
        ids = torch.as_tensor([[cfg.bos_token_id] + cap.prompt_ids()], device=tokens.device)
        logits = cap.decoder(ids, tokens)
        cpu_vision = copy.deepcopy(cap.vision).cpu()
        cpu_decoder = copy.deepcopy(cap.decoder).cpu()
        cpu_tokens = BlipCaptioner(cpu_vision, cpu_decoder, tok).image_tokens(imgs[:1])
        cpu_logits = cpu_decoder(ids.cpu(), tokens.cpu())
    errs = {"vision_tokens": _rel(tokens.cpu(), cpu_tokens),
            "decoder_logits": _rel(logits.cpu(), cpu_logits)}
    if tokens.shape != (1, 577, 768) or max(errs.values()) > EVAL_CPU_RTOL:
        raise AssertionError(f"BLIP on the card vs the CPU: {tuple(tokens.shape)}, {errs}")
    out = {"create_s": t_create, "warmup_caption_x1_s": t_warm,
           f"caption_batch_x{len(imgs)}_s": t_cap, "again_s": t_again,
           "s_per_image": t_cap / len(imgs), "num_beams": cap.num_beams,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "card_vs_cpu_rel_err": errs, "caption_words": [len(c.split()) for c in captions]}
    del cap, cpu_vision, cpu_decoder
    torch.cuda.empty_cache()
    return out, captions


def pix2pix_zero_phase(pipe) -> dict:
    """pix2pix-zero at full SD1.4 width on 4 images: BLIP captions them
    (``blip_phase``); one counted edit of each method at ``P2Z_STEPS``
    through the editor with the image's caption injected (after a warm-up at
    2), timed per phase (the regularised inversion, of which the noise
    regularisation, and the edit), peak memory; ``BatchedPix2PixZero`` on the
    4 images (their captions and a prompt pair each) at ``P2Z_STEPS``:
    seconds per image, launches, peak memory, each image's panels against
    the single-image editor's. The map-loss gradient runs the bf16 backward
    at all ten flash sites."""
    from pnpinversion_tpu_torch.editors import pix2pix_zero_editor as ped
    from pnpinversion_tpu_torch.inversion import pix2pix_zero as p2z
    from pnpinversion_tpu_torch.parallel.sweep import BatchedPix2PixZero

    size = pipe.config.image_size
    image = _random_images(2727, size)
    imgs = np.stack([image() for _ in range(BATCH)])
    prompts = CAKE_PROMPTS[:BATCH]
    blip, captions = blip_phase(imgs)
    out = {"blip": blip, "steps": P2Z_STEPS}
    short = _pipe_at(pipe, P2Z_STEPS)
    editor = ped.Pix2PixZeroEditor(short)
    # per step: 1 inversion call, then 3 of 2 rows (the reconstruction, the
    # map loss's forward, the edit) and one backward: 3 calls and K = T
    # backward passes, each after its own forward
    calls, k = 3 * P2Z_STEPS, (P2Z_STEPS, P2Z_STEPS)
    batched = ped.METHODS[1]
    for method in ped.METHODS:
        _, t_warm = _sync_time(lambda: ped.Pix2PixZeroEditor(_pipe_at(pipe, 2))(
            method, imgs[0], *prompts[0], caption=captions[0]))
        seconds = {}
        restore = _timed_calls([(ped, "p2z_invert"), (ped, "p2z_edit"),
                                (p2z, "regularize_noise")], seconds)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        try:
            strip, t_edit = _sync_time(lambda: editor(method, imgs[0], *prompts[0],
                                                      caption=captions[0]))
        finally:
            restore()
        counts, peak = _counts(), torch.cuda.max_memory_allocated() / 2**30
        _check_strip(strip)
        _check_grad_launches(method, counts, calls, P2Z_BWD_SITES, k)
        if method == batched:
            singles = [strip] + [editor(method, imgs[i], *prompts[i], caption=captions[i])
                                 for i in range(1, BATCH)]
        out[method] = {"warmup_edit_2_steps_s": t_warm, "edit_s_per_image": t_edit,
                       "phase_s": seconds, "launches": counts, "unet_calls": calls + k[0],
                       "backward_passes": P2Z_STEPS, "peak_mem_gib": peak,
                       "edit_panel_std": float(strip[:, 3 * size:].std())}
    cond = torch.stack([pipe.encode_prompt([c]) for c in captions])
    dirs = torch.stack([ped.construct_direction(pipe, [s], [t]) for s, t in prompts])
    method = batched
    _, t_warm_batch = _sync_time(lambda: BatchedPix2PixZero(_pipe_at(pipe, 2)).edit_batch(
        method, imgs, cond, dirs))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    (recon, edits), t_batch = _sync_time(lambda: BatchedPix2PixZero(short).edit_batch(
        method, imgs, cond, dirs))
    batch_counts, batch_peak = _counts(), torch.cuda.max_memory_allocated() / 2**30
    _check_grad_launches(f"batched {method}", batch_counts, calls, P2Z_BWD_SITES, k)
    for name, x in (("recon", recon), ("edit", edits)):
        if x.shape != (BATCH, size, size, 3) or min(float(i.std()) for i in x) == 0.0:
            raise AssertionError(f"batched {method} {name}: {x.shape}, or an image is constant")
    out[f"batched {method}"] = {
        "batch": BATCH, "warmup_batch_2_steps_s": t_warm_batch, "batch_s": t_batch,
        "batch_s_per_image": t_batch / BATCH,
        "single_over_batched_per_image": out[method]["edit_s_per_image"] * BATCH / t_batch,
        "batch_launches": batch_counts, "batch_peak_mem_gib": batch_peak,
        "uint8_diff_vs_single_editor": _panel_diffs({"recon": recon, "edit": edits},
                                                    singles, size)}
    print("pix2pix_zero", json.dumps(out), flush=True)
    return out


def stylediffusion_phase(pipe) -> dict:
    """StyleDiffusion at full SD1.4 width (the CLIP ViT-B/16 image tokens,
    random weights from seed 42, f32) on 4 images with a cake prompt pair
    each: one counted ``stylediffusion+p2p`` edit at ``SD_STEPS`` with
    ``SD_INNER`` inner steps (after a warm-up at 2 and 1), timed per phase
    (the inversion with its maps, the training and its seconds per inner
    step, the two passes), peak memory; then ``BatchedStyleDiffusion`` on the
    4 images at the same settings: seconds per image, launches, peak memory,
    each image's panels against the single-image editor's. The training runs
    the bf16 backward at the nine sites after the first cross-attention."""
    from pnpinversion_tpu_torch.control.p2p import stack_tensors
    from pnpinversion_tpu_torch.editors import stylediffusion_editor as sde
    from pnpinversion_tpu_torch.inversion.stylediffusion import inner_steps_schedule
    from pnpinversion_tpu_torch.parallel.sweep import BatchedStyleDiffusion

    size = pipe.config.image_size
    image = _random_images(5151, size)
    imgs = np.stack([image() for _ in range(BATCH)])
    prompts = CAKE_PROMPTS[:BATCH]
    short = _pipe_at(pipe, SD_STEPS)
    clip, t_clip = _sync_time(lambda: sde.make_clip_vision(pipe.device))
    editor = sde.StyleDiffusionEditor(short, clip)
    method = sde.METHOD
    _, t_warm = _sync_time(lambda: sde.StyleDiffusionEditor(_pipe_at(pipe, 2), clip)(
        method, imgs[0], *prompts[0], num_inner_steps=1))
    most = int(inner_steps_schedule(SD_STEPS, SD_INNER).sum())
    # UNet calls per step besides the inner ones: inversion, the uncond eps,
    # the advance, the reconstruction and the edit
    calls = 5 * SD_STEPS
    seconds = {}
    restore = _timed_calls([(sde, "ddim_invert_with_maps"), (sde, "train_mappers"),
                            (sde, "guidance_forward"), (sde, "image_tokens")], seconds)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    try:
        strip, t_edit = _sync_time(lambda: editor(method, imgs[0], *prompts[0],
                                                  num_inner_steps=SD_INNER))
    finally:
        restore()
    counts, peak = _counts(), torch.cuda.max_memory_allocated() / 2**30
    _check_strip(strip)
    inner = _check_grad_launches(method, counts, calls, SD_BWD_SITES, (SD_STEPS, most))
    singles = [strip] + [editor(method, imgs[i], *prompts[i], num_inner_steps=SD_INNER)
                         for i in range(1, BATCH)]
    out = {"steps": SD_STEPS, "num_inner_steps": SD_INNER, "clip_create_s": t_clip,
           method: {"warmup_edit_2_steps_1_inner_s": t_warm, "edit_s_per_image": t_edit,
                    "phase_s": seconds, "launches": counts, "unet_calls": calls + inner,
                    "inner_steps_total": inner,
                    "training_s_per_inner_step": seconds["train_mappers"] / inner,
                    "peak_mem_gib": peak, "edit_panel_std": float(strip[:, 3 * size:].std())}}

    controls = [sde.stylediffusion_p2p(short, list(p)) for p in prompts]
    if len({c.spec for c, _ in controls}) != 1:
        raise AssertionError("the images' prompts give different StyleDiffusion P2P specs")
    cond_src = torch.stack([pipe.encode_prompt([s]) for s, _ in prompts])
    cond2 = torch.stack([pipe.encode_prompt(list(p)) for p in prompts])
    tensors = stack_tensors([t for _, t in controls])

    def batch(p, k):
        return BatchedStyleDiffusion(p, clip, num_inner_steps=k).edit_batch(
            controls[0][0].spec, imgs, cond_src, cond2, tensors)

    _, t_warm_batch = _sync_time(lambda: batch(_pipe_at(pipe, 2), 1))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    (recon, edits), t_batch = _sync_time(lambda: batch(short, SD_INNER))
    batch_counts, batch_peak = _counts(), torch.cuda.max_memory_allocated() / 2**30
    batch_inner = _check_grad_launches(f"batched {method}", batch_counts, calls, SD_BWD_SITES,
                                       (SD_STEPS, most))
    for name, x in (("recon", recon), ("edit", edits)):
        if x.shape != (BATCH, size, size, 3) or min(float(i.std()) for i in x) == 0.0:
            raise AssertionError(f"batched {method} {name}: {x.shape}, or an image is constant")
    out[f"batched {method}"] = {
        "batch": BATCH, "warmup_batch_2_steps_1_inner_s": t_warm_batch, "batch_s": t_batch,
        "batch_s_per_image": t_batch / BATCH,
        "single_over_batched_per_image": t_edit * BATCH / t_batch,
        "batch_launches": batch_counts, "inner_steps_total": batch_inner,
        "batch_peak_mem_gib": batch_peak,
        "uint8_diff_vs_single_editor": _panel_diffs({"recon": recon, "edit": edits}, singles,
                                                    size)}
    print("stylediffusion", json.dumps(out), flush=True)
    del clip, editor
    torch.cuda.empty_cache()
    return out


ENTRY_DIR = "build/smoke_entry"  # git-ignored; removed when the phase ends
# DDIM steps of the runner's and the sweep's edits: 10 keeps the phase near
# 25 s (the shapes do not depend on the steps; the smoke reached 826.7 s with
# 50 on a slow host); scripts/time_torch_entry_points.py times them at 50
ENTRY_STEPS = 10
ENTRY_RUNNER_IMAGES = 2  # category "0" of the mini PIE-Bench; the sweep takes all BATCH


def _bpe_vocab(root: str, prompts) -> str:
    """A tiny CLIP BPE vocabulary in the HF layout (``vocab.json`` +
    ``merges.txt``): every byte and its word-final form, merges that build
    the prompts' words left to right, the two specials. Returns its dir."""
    from pnpinversion_tpu_torch.utils.tokenizer import _bytes_to_unicode

    alphabet = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(alphabet + [c + "</w>" for c in alphabet])}
    merges = []
    for word in sorted({w for p in prompts for w in p.lower().split()}):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            merge = f"{parts[0]} {parts[1]}"
            if merge not in merges:
                merges.append(merge)
            parts = [parts[0] + parts[1]] + parts[2:]
            vocab.setdefault(parts[0], len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(root, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return root


_OLD_VAE_ATTN = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def _write_hf_checkpoint(root: str, modules: dict) -> int:
    """The modules as an HF SD directory of f16 safetensors (the VAE under
    the older diffusers attention names), written with the port's own
    writer. Returns the bytes written."""
    from pnpinversion_tpu_torch.convert.safetensors_io import write_safetensors

    total = 0
    for part, sub in (("unet", "unet"), ("vae", "vae"), ("text", "text_encoder")):
        sd = {}
        for k, v in modules[part].state_dict().items():
            for new, old in _OLD_VAE_ATTN.items():
                if part == "vae" and f".attentions.0.{new}." in k:
                    k = k.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
            sd[k] = v.detach().to("cpu", torch.float16)
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        path = os.path.join(root, sub, "diffusion_pytorch_model.safetensors")
        write_safetensors(path, sd)
        total += os.path.getsize(path)
    return total


def _mini_pie_bench(root: str, n: int, size: int) -> str:
    """A PIE-Bench ``data/`` of n seeded JPEG images with the cake prompts
    (one pair each, in turn), LocalBlend on "cake", the first
    ENTRY_RUNNER_IMAGES in category 0 and the rest in 1. Returns the data
    dir."""
    from PIL import Image

    from pnpinversion_tpu_torch.data.pie_bench import mask_encode

    image = _random_images(8080, size)
    data = os.path.join(root, "data")
    mapping = {}
    for i in range(n):
        rel = f"{int(i >= ENTRY_RUNNER_IMAGES)}_random/{i:03d}.jpg"
        path = os.path.join(data, "annotation_images", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(image()).save(path)
        src, tar = CAKE_PROMPTS[i % len(CAKE_PROMPTS)]
        mask = np.zeros((512, 512), np.uint8)
        mask[128:384, 96:352] = 1
        mapping[f"{i:09d}"] = {
            "image_path": rel, "original_prompt": src.replace("round", "[round]"),
            "editing_prompt": tar.replace("square", "[square]"),
            "editing_instruction": "make the cake square",
            "editing_type_id": str(int(i >= ENTRY_RUNNER_IMAGES)), "blended_word": "cake cake",
            "mask": mask_encode(mask)}
    with open(os.path.join(data, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)
    return data


class _CreateSpy:
    """Records every pipeline ``SDPipeline.create`` makes, and its seconds to
    a synchronize (the real create runs); a context manager."""

    def __enter__(self):
        from pnpinversion_tpu_torch.pipeline import SDPipeline

        self.pipes, self.seconds, self._orig = [], [], SDPipeline.__dict__["create"]
        orig = self._orig.__func__

        def create(cls, *args, **kwargs):
            pipe, dt = _sync_time(lambda: orig(cls, *args, **kwargs))
            self.pipes.append(pipe)
            self.seconds.append(dt)
            return pipe

        SDPipeline.create = classmethod(create)
        return self

    def __exit__(self, *exc):
        from pnpinversion_tpu_torch.pipeline import SDPipeline

        SDPipeline.create = self._orig


def _jpeg_bytes(strip: np.ndarray) -> bytes:
    """The bytes PIL writes for a strip saved as .jpg (the runners' save)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(strip).save(buf, format="JPEG")
    return buf.getvalue()


def _same_modules(pipe, seeded: dict) -> int:
    """Fails unless every tensor of the pipeline's modules equals the seeded
    one cast to f16 and then to the pipeline's dtype, bit for bit; returns
    the tensors checked."""
    n = 0
    for part, module in (("unet", pipe.unet), ("vae", pipe.vae), ("text", pipe.text_encoder)):
        want = seeded[part].state_dict()
        for k, v in module.state_dict().items():
            ref = want[k].to(torch.float16).to(v.dtype)
            if not torch.equal(v, ref):
                raise AssertionError(f"loaded {part}.{k} differs from the seeded weight")
            n += 1
    return n


def entry_points_phase(config=None, steps: int = ENTRY_STEPS, device: str = "cuda",
                       keep: bool = False) -> dict:
    """The port's own entry points on local weights, at full SD1.4 width:

    - an HF SD1.4 directory written with the port's safetensors writer (seeded
      f32 modules saved as f16, the VAE under the older attention names, a
      tiny CLIP BPE vocabulary in ``tokenizer/``) and a BATCH-image 512^2
      mini PIE-Bench;
    - ``runners.run_editing_p2p.main`` for directinversion+p2p on
      ENTRY_RUNNER_IMAGES images at ``steps`` (the f32 pipeline, as the JAX
      runner's): its pipeline's every tensor bit for bit against the seeded
      one cast to f16, the load's seconds and GB/s, its launches against the
      code's own count (the f32 forward only), each strip (512x2048x3 uint8)
      equal to ``P2PEditor``'s on the same modules with the runner's
      arguments (as JPEG bytes), and a rerun that skips and leaves the files'
      mtimes alone;
    - ``runners.run_sweep.main`` at batch BATCH (auto) over the BATCH images
      in bf16: its pipeline bit for bit, its launches (one batch: the bf16
      forward only), each strip equal to ``BatchedDirectInversionP2P``'s on
      the same inputs, images in their slots;
    - a CompVis ``.ckpt`` of InstructPix2Pix's 8-channel UNet at TINY (the
      port's writer; TINY keeps the phase's budget), loaded bit for bit.

    ``config`` (SD14 by default) and ``device`` let a CPU rehearsal run it
    at TINY. ``keep`` leaves ``ENTRY_DIR`` for ``multi_process_phase`` (the
    caller removes it)."""
    import shutil

    from pnpinversion_tpu_torch import configs
    from pnpinversion_tpu_torch.control.p2p import make_p2p_control, stack_tensors
    from pnpinversion_tpu_torch.convert.ldm import ldm_state_dict
    from pnpinversion_tpu_torch.data.pie_bench import PieBenchDataset, load_image
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.parallel.sweep import BatchedDirectInversionP2P
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.runners import run_editing_p2p, run_sweep
    from pnpinversion_tpu_torch.utils.image import make_strip, txt_draw

    config = config or configs.SD14
    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    ckpt = os.path.join(ENTRY_DIR, "sd14")
    out: dict = {"steps": steps}
    try:
        seeded_pipe = SDPipeline.create(config, seed=13, device=device, dtype=torch.float32)
        seeded = {"unet": seeded_pipe.unet, "vae": seeded_pipe.vae,
                  "text": seeded_pipe.text_encoder}
        nbytes, t_write = _sync_time(lambda: _write_hf_checkpoint(ckpt, seeded))
        _bpe_vocab(os.path.join(ckpt, "tokenizer"), [t for p in CAKE_PROMPTS for t in p])
        size = config.image_size
        data = _mini_pie_bench(ENTRY_DIR, BATCH, size)
        out.update(checkpoint_gb=nbytes / 1e9, write_s=t_write)
        # the weight-checking CLI on the directory (SD1.4's key sets, forward smokes)
        from pnpinversion_tpu_torch.convert import __main__ as convert_cli

        manifest, t_cli = _sync_time(lambda: convert_cli.main(
            ["--sd14", ckpt, "--root", ENTRY_DIR, "--device", device,
             "--manifest", os.path.join(ENTRY_DIR, "manifest.json")]))
        out["convert_cli"] = {"s": t_cli, **{part: {k: manifest["models"]["sd14"][part][k] for k in
                                                    ("keys_total", "keys_consumed",
                                                     "tensors_filled")}
                                             for part in ("unet", "vae", "text")}}
        common = ["--data_path", data, "--checkpoint_dir", ckpt, "--num_ddim_steps", str(steps),
                  "--device", device]

        # the per-image runner, f32
        runner_out = os.path.join(ENTRY_DIR, "output")
        log = os.path.join(ENTRY_DIR, "runner_log.jsonl")
        _reset_counts()
        with _CreateSpy() as spy:
            _, t_run = _sync_time(lambda: run_editing_p2p.main(
                common + ["--output_path", runner_out, "--edit_category_list", "0",
                          "--run_log", log]))
        pipe = spy.pipes[0]
        counts = _check_f32_launches("runner directinversion+p2p",
                                     ENTRY_RUNNER_IMAGES * 2 * steps)
        if pipe.dtype != torch.float32 or type(pipe.tokenizer).__name__ != "CLIPBPETokenizer":
            raise AssertionError(f"runner pipeline {pipe.dtype} {type(pipe.tokenizer)}")
        checked = _same_modules(pipe, seeded)
        events = [json.loads(line) for line in open(log)]
        edit_s = [e["seconds"] for e in events if e["event"] == "image_done"]
        items = list(PieBenchDataset(data).items())
        editor = P2PEditor(pipe)
        paths = []
        for item in items[:ENTRY_RUNNER_IMAGES]:
            path = os.path.join(runner_out, "directinversion+p2p", "annotation_images",
                                os.path.relpath(item.image_path,
                                                os.path.join(data, "annotation_images")))
            want = editor("directinversion+p2p", image_path=item.image_path,
                          **run_editing_p2p.edit_kwargs(item))
            _check_strip_size(want, size)
            with open(path, "rb") as f:
                if f.read() != _jpeg_bytes(want):
                    raise AssertionError(f"{path}: the runner's strip is not P2PEditor's")
            paths.append(path)
        mtimes = [os.stat(p).st_mtime_ns for p in paths]
        run_editing_p2p.main(common + ["--output_path", runner_out, "--edit_category_list", "0"])
        if [os.stat(p).st_mtime_ns for p in paths] != mtimes:
            raise AssertionError("a rerun of the runner rewrote existing strips")
        load_s = spy.seconds[0]
        out["runner"] = {"images": len(paths), "run_s": t_run, "edit_s": edit_s,
                         "s_per_image": sum(edit_s) / len(edit_s),
                         "load_s": load_s, "load_gb_per_s": nbytes / 1e9 / load_s,
                         "tensors_bit_for_bit": checked, "launches": counts,
                         "strips_equal_editor": True, "rerun_skipped": True}
        del editor, pipe, spy
        gc.collect()
        torch.cuda.empty_cache()

        # the one-GPU sweep, bf16 (auto batch: BATCH on the card)
        sweep_out = os.path.join(ENTRY_DIR, "sweep")
        _reset_counts()
        with _CreateSpy() as spy:
            done, t_sweep = _sync_time(lambda: run_sweep.main(
                common + ["--output_path", sweep_out, "--edit_category_list", "0", "1"]))
        pipe = spy.pipes[0]
        counts = _counts()
        want_counts = {"fwd": FLASH_SITES * 2 * steps, "prep": 0, "main": 0, "convert": 0}
        if device == "cuda" and (counts != want_counts or done["batch"] != BATCH):
            raise AssertionError(f"sweep: launches {counts} at batch {done['batch']}, want "
                                 f"{want_counts} (one batch of {BATCH})")
        sweep_checked = _same_modules(pipe, seeded)
        sweep = BatchedDirectInversionP2P(pipe)
        controls = []
        for item in items:
            ctrl, tensors = make_p2p_control(
                [item.source_prompt, item.target_prompt], pipe.tokenizer, num_steps=steps,
                blend_words=(("cake",), ("cake",)), eq_params={"words": ("cake",),
                                                              "values": (2,)},
                num_lb_slots=pipe.num_lb_slots, lb_res=pipe.lb_res, latent_size=pipe.latent_size,
                device=pipe.device)
            controls.append((ctrl.spec, tensors))
        images = np.stack([load_image(it.image_path, size) for it in items])
        embs = pipe.encode_prompt([t for it in items for t in (it.source_prompt,
                                                                it.target_prompt)])
        recon, edits = sweep.edit_batch(controls[0][0], images, embs.reshape(
            (len(items), 2) + embs.shape[1:]), pipe.encode_prompt(["", ""]), 7.5,
            stack_tensors([t for _, t in controls]))
        for i, item in enumerate(items):
            text = txt_draw(f"source prompt: {item.source_prompt}\n"
                            f"target prompt: {item.target_prompt}", target_size=(size, size))
            path = os.path.join(sweep_out, "directinversion+p2p", "annotation_images",
                                os.path.relpath(item.image_path,
                                                os.path.join(data, "annotation_images")))
            with open(path, "rb") as f:
                if f.read() != _jpeg_bytes(make_strip([text, images[i], recon[i], edits[i]])):
                    raise AssertionError(f"{path}: the sweep's strip is not the batched class's")
        out["sweep"] = {"images": done["images"], "batch": done["batch"], "run_s": t_sweep,
                        "load_s": spy.seconds[0],
                        "load_gb_per_s": nbytes / 1e9 / spy.seconds[0],
                        "s_per_image": (t_sweep - spy.seconds[0]) / done["images"],
                        "tensors_bit_for_bit": sweep_checked, "launches": counts,
                        "strips_equal_batched_class": True}
        del sweep, pipe, spy
        gc.collect()

        # a CompVis .ckpt of the 8-channel UNet, at TINY
        ip2p = dataclasses.replace(configs.TINY, unet=dataclasses.replace(configs.TINY.unet,
                                                                          in_channels=8))
        small = SDPipeline.create(ip2p, seed=14, device=device, dtype=torch.float32)
        mods = {"unet": small.unet, "vae": small.vae, "text": small.text_encoder}
        sd = ldm_state_dict(*(mods[k].state_dict() for k in ("unet", "vae", "text")), ip2p)
        ldm_path = os.path.join(ENTRY_DIR, "ip2p", "tiny-ip2p.ckpt")
        os.makedirs(os.path.dirname(ldm_path))
        torch.save({"state_dict": {k: v.to("cpu", torch.float16) for k, v in sd.items()},
                    "betas": torch.zeros(8)}, ldm_path)
        loaded = SDPipeline.create(ip2p, checkpoint_dir=os.path.dirname(ldm_path),
                                   device=device, dtype=torch.float32)
        out["ldm_tiny_ip2p"] = {"tensors_bit_for_bit": _same_modules(loaded, mods),
                                "conv_in": list(loaded.unet.conv_in.weight.shape)}
    finally:
        if not keep:
            shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    print("entry_points", json.dumps(out), flush=True)
    return out


def _check_strip_size(strip, size: int) -> None:
    if strip.shape != (size, 4 * size, 3) or strip.dtype != np.uint8:
        raise AssertionError(f"strip {strip.shape} {strip.dtype}, want ({size}, {4 * size}, 3) "
                             "uint8")


# ---------------------------------------------------------------------------
# several processes: the sharded sweep, data-parallel training with ZeRO
# ---------------------------------------------------------------------------

MP_DIR = "build/smoke_multi"  # git-ignored; removed when the phase ends
MP_RANKS = 2  # processes on the one card (gloo: NCCL refuses two ranks on one GPU)
MP_IMAGES = 8  # a x4 batch a rank, the shape run_sweep launches at (B.H 96)
# the global batch and accumulation of the two ranks: 8 rows a rank, the
# shape of train_b8_32x32 (B.H 64 at 1,024 tokens); the one-process
# reference runs the same 32 rows of a step as batch 8 x accumulation 4
MP_BATCH, MP_ACCUM, MP_REF_ACCUM, MP_STEPS = 16, 2, 4, 2
MP_SEED, MP_LR = 5, 1e-4  # the runner's --seed, and --base_lr without the scaling
MP_PAIRS = 20  # seeds.json items of the training data (18 in the train split)
MP_LOSS_RTOL = 1e-5  # the first step's loss: the same 8-row forwards, summed in another order
# two runs' updates of the parameters, in units of the lr: from a fresh
# state Adam moves each coordinate by about +-lr whatever its gradient's
# size, so a coordinate whose gradient is rounding noise (a norm cancels it,
# or the bf16 backward's reduce-adds and cuDNN's algorithms vary its sum
# from run to run) moves either way in either run, up to ~2 lr a step
# apart. So the ranks' update is held to the one process's run-to-run
# difference (the same steps again), each statistic within this factor of
# it plus a floor; a fault in a block of a tensor moves most of that block
# and its median with it
MP_NOISE_FACTOR = 2.0
MP_NOISE_FLOOR = {"median_max_in_lr": 1e-3, "share_over_0.1_lr": 1e-4, "l2_rel": 1e-3}
MP_TIMEOUT_S = 600.0  # the ranks' deadline: past it they are ended and the phase fails


def _pair_dataset(root: str, n: int, res: int) -> str:
    """An ip2p seeds.json dataset of n seeded random JPEG pairs at res^2."""
    from PIL import Image

    rng = np.random.default_rng(MP_SEED)
    seeds = []
    for i in range(n):
        name = f"{i:07d}"
        os.makedirs(os.path.join(root, name))
        with open(os.path.join(root, name, "prompt.json"), "w") as f:
            json.dump({"input": SRC, "edit": f"make the cake {i}", "output": TAR}, f)
        for suffix in ("0", "1"):
            Image.fromarray(rng.integers(0, 255, (res, res, 3), dtype=np.uint8)).save(
                os.path.join(root, name, f"0_{suffix}.jpg"))
        seeds.append([name, [0]])
    with open(os.path.join(root, "seeds.json"), "w") as f:
        json.dump(seeds, f)
    return root


def _mp_sweep_argv(spec: dict, out: str, log: str) -> list:
    return ["--method", "directinversion+p2p", "--data_path", spec["data"], "--output_path", out,
            "--checkpoint_dir", spec["ckpt"], "--num_ddim_steps", str(spec["steps"]),
            "--edit_category_list", "0", "1", "--run_log", log, "--device", spec["device"]]


def _mp_train_argv(spec: dict) -> list:
    return ["--data_path", spec["pairs"], "--output_dir", spec["train_out"],
            "--checkpoint_dir", spec["ckpt"], "--batch_per_step", str(MP_BATCH),
            "--accumulate_grad_batches", str(MP_ACCUM), "--max_steps", str(MP_STEPS),
            "--save_every", "0", "--log_every", "1", "--no_scale_lr", "--base_lr", str(MP_LR),
            "--crop_res", str(TRAIN_CROP), "--min_resize_res", str(TRAIN_CROP),
            "--max_resize_res", str(TRAIN_CROP), "--seed", str(MP_SEED), "--device",
            spec["device"]]


def _mp_trainer(spec: dict, zero: bool, accum: int, group, pipe=None):
    """The training runner's trainer on the smoke's SD1.4 directory (its
    4-channel UNet widened to 8), with the runner's settings, on ``pipe``
    (a bf16 pipeline of that directory; loaded when not given, as the
    runner loads it); returns (trainer, pipeline)."""
    from pnpinversion_tpu_torch.configs import IP2P
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.training import trainer as tr

    if pipe is None:
        cfg4 = dataclasses.replace(IP2P, unet=dataclasses.replace(IP2P.unet, in_channels=4))
        pipe = SDPipeline.create(cfg4, seed=MP_SEED, checkpoint_dir=spec["ckpt"],
                                 device=spec["device"])
    unet8 = tr.extend_conv_in(pipe.unet, IP2P.unet.in_channels)
    pipe.unet = None
    model_cfg = dataclasses.replace(pipe.config, unet=dataclasses.replace(
        pipe.config.unet, in_channels=IP2P.unet.in_channels))
    cfg = tr.TrainConfig(base_lr=MP_LR, scale_lr=False, accum=accum, zero=zero)
    trainer = tr.EditTrainer(model_cfg, {"vae": pipe.vae, "text": pipe.text_encoder}, unet8, cfg,
                             MP_BATCH if group is not None else MP_BATCH // MP_RANKS,
                             pipe.tokenize([""])[0], group=group)
    return trainer, pipe


def _mp_streams(spec: dict, pipe) -> list:
    """The ranks' data streams as the training runner reads them: each rank
    its own, MP_BATCH / MP_RANKS items a microbatch; a function of (rank,
    microbatches) -> {edited, cond_image, ids}."""
    from pnpinversion_tpu_torch.training.data import EditPairDataset, WeightedConcat, batches

    src = WeightedConcat([EditPairDataset(spec["pairs"], split="train",
                                          min_resize_res=TRAIN_CROP, max_resize_res=TRAIN_CROP,
                                          crop_res=TRAIN_CROP, flip_prob=0.5)], None)
    streams = [batches(src, MP_BATCH // MP_RANKS, seed=MP_SEED, process_index=r)
               for r in range(MP_RANKS)]

    def take(rank: int, n: int) -> dict:
        parts = [next(streams[rank]) for _ in range(n)]
        return {"edited": np.stack([p["edited"] for p in parts]),
                "cond_image": np.stack([p["cond_image"] for p in parts]),
                "ids": torch.stack([pipe.tokenize(p["edit"]) for p in parts])}

    return take


def _mp_rank(rank: int, address: str, spec: dict) -> None:
    """One of the MP_RANKS processes on the card (spawned): joins the gloo
    group, then runs ``run_sweep_sharded`` (counted), the same again (every
    strip exists: nothing edited, no pipeline built), one step of the trainer
    without ZeRO on the sweep's pipeline (the same SD1.4 weights the
    training runner loads) and the training runner with ZeRO (counted), each
    through the group it made, each with its peak memory; writes its numbers
    to MP_DIR/rank<r>.json."""
    import torch.distributed as dist

    from pnpinversion_tpu_torch.parallel import multihost
    from pnpinversion_tpu_torch.runners import run_sweep_sharded
    from pnpinversion_tpu_torch.runners import run_training_instructpix2pix as train_runner
    from pnpinversion_tpu_torch.training import trainer as tr

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // MP_RANKS))  # the host's cores, shared
    _record_path_shapes()
    multihost.initialize(address, MP_RANKS, rank, "gloo", spec["device"])
    if spec["device"] == "cuda":  # the context, cuDNN and cuBLAS, while the parent works
        x = torch.randn(1, 8, 16, 16, device="cuda", dtype=torch.bfloat16)
        torch.nn.functional.conv2d(x, torch.randn(8, 8, 3, 3, device=x.device, dtype=x.dtype))
        (x.flatten(1) @ x.flatten(1).T).sum().item()
    deadline = time.perf_counter() + MP_TIMEOUT_S
    while not os.path.exists(spec["ready"]):  # the parent writes the data, then this file
        if time.perf_counter() > deadline:
            raise AssertionError(f"rank {rank}: no {spec['ready']} within {MP_TIMEOUT_S} s")
        time.sleep(0.2)
    flags = ["--num_processes", str(MP_RANKS), "--process_id", str(rank),
             "--coordinator_address", address, "--dist_backend", "gloo"]
    out = {}
    try:
        sweep_argv = _mp_sweep_argv(spec, spec["sweep_out"], spec["sweep_log"]) + flags
        _reset_counts()
        with _CreateSpy() as spy:
            done, t = _sync_time(lambda: run_sweep_sharded.main(sweep_argv))
        out["sweep"] = {"done": done, "run_s": t, "load_s": spy.seconds, "launches": _counts()}
        pipe = spy.pipes[0]
        del spy
        _reset_counts()
        with _CreateSpy() as spy:
            again, t = _sync_time(lambda: run_sweep_sharded.main(sweep_argv))
        out["rerun"] = {"done": again, "run_s": t, "pipelines": len(spy.pipes),
                        "launches": _counts()}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer, pipe = _mp_trainer(spec, False, MP_ACCUM, dist.group.WORLD, pipe)
        batch = _mp_streams(spec, pipe)(rank, MP_ACCUM)
        m, t = _sync_time(lambda: trainer.train_step(batch, tr.step_generator(
            MP_SEED, 0, trainer.device)))
        out["no_zero_step"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                               "step_s": t, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del trainer, pipe, batch
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        _, t = _sync_time(lambda: train_runner.main(_mp_train_argv(spec) + flags))
        out["train"] = {"run_s": t, "launches": _counts(),
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    finally:
        multihost.shutdown()
    out["path_shapes"] = {k: sorted(v) for k, v in PATH_SHAPES.items()}
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mp_start(steps: int = ENTRY_STEPS, device: str = "cuda"):
    """Starts the MP_RANKS ranks of ``multi_process_phase`` (spawned
    ``_mp_rank``s): each joins the gloo group and warms its CUDA context,
    then waits for the phase to write its data. Returns the phase's spec and
    the processes; ``mp_stop`` ends them."""
    import shutil

    import torch.multiprocessing as mp

    from pnpinversion_tpu_torch.parallel import multihost

    shutil.rmtree(MP_DIR, ignore_errors=True)
    os.makedirs(MP_DIR)
    spec = {"dir": MP_DIR, "ckpt": os.path.join(ENTRY_DIR, "sd14"), "steps": steps,
            "device": device, "data": os.path.join(MP_DIR, "data"),
            "pairs": os.path.join(MP_DIR, "pairs"), "ready": os.path.join(MP_DIR, "ready"),
            "sweep_out": os.path.join(MP_DIR, "sweep"),
            "sweep_log": os.path.join(MP_DIR, "sweep_log.jsonl"),
            "train_out": os.path.join(MP_DIR, "train")}
    ctx = mp.start_processes(_mp_rank, args=(f"127.0.0.1:{multihost.free_port()}", spec),
                             nprocs=MP_RANKS, join=False, start_method="spawn")
    return spec, ctx


def mp_stop(started) -> None:
    """Ends the ranks that are still running and removes MP_DIR."""
    import shutil

    for p in started[1].processes:
        if p.is_alive():
            p.terminate()
        p.join()
    shutil.rmtree(MP_DIR, ignore_errors=True)


def _mp_run(started, beside):
    """Lets the ranks go (the ready file) and runs the parent's ``beside()``
    meanwhile; returns (the ranks' results, beside's). A rank that fails, or
    the MP_TIMEOUT_S deadline, raises."""
    spec, ctx = started
    with open(spec["ready"], "w"):
        pass
    deadline = time.perf_counter() + MP_TIMEOUT_S
    result = beside()
    while not ctx.join(timeout=5):
        if time.perf_counter() > deadline:
            raise AssertionError(f"the {len(ctx.processes)} ranks outlasted {MP_TIMEOUT_S} s")
    results = []
    for r in range(len(ctx.processes)):
        with open(os.path.join(spec["dir"], f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, result


def _mp_slices(spec: dict, steps: int) -> dict:
    """One-process runs over each rank's slice of the mini PIE-Bench (in
    the parent, while the ranks run): rank 0's through ``run_sweep``, rank
    1's through ``run_sweep_sharded`` as a group of one on NCCL (NCCL's
    initialisation and the count's collective on the card), each one x4
    batch of the bf16 forward's launches."""
    import torch.distributed as dist

    from pnpinversion_tpu_torch.data.pie_bench import PieBenchDataset
    from pnpinversion_tpu_torch.runners import run_sweep, run_sweep_sharded

    items = list(PieBenchDataset(spec["data"]).items())
    mapping = json.load(open(os.path.join(spec["data"], "mapping_file.json")))
    want_counts = {"fwd": FLASH_SITES * 2 * steps, "prep": 0, "main": 0, "convert": 0}
    out = {}
    for r in range(MP_RANKS):
        path = os.path.join(spec["dir"], f"slice{r}.json")
        with open(path, "w") as f:
            json.dump({it.key: mapping[it.key] for it in items[r::MP_RANKS]}, f)
        ref = os.path.join(spec["dir"], f"slice{r}")
        argv = _mp_sweep_argv(spec, ref, os.path.join(spec["dir"], f"slice{r}.jsonl")) + [
            "--mapping_file", path]
        _reset_counts()
        if r == 0:
            done, t = _sync_time(lambda: run_sweep.main(argv))
        else:
            done, t = _sync_time(lambda: run_sweep_sharded.main(
                argv + ["--num_processes", "1", "--dist_backend",
                        "nccl" if spec["device"] == "cuda" else "gloo"]))
        if (done["images"] != len(items[r::MP_RANKS]) or done["batch"] != BATCH
                or _counts() != want_counts):
            raise AssertionError(f"slice {r}: {done}, launches {_counts()}")
        out[r] = {"entry": "run_sweep" if r == 0 else "run_sweep_sharded, nccl, 1 rank",
                  "run_s": t, "images": done["images"], "dir": ref}
    if dist.is_initialized():
        raise AssertionError("the NCCL group of one outlived its run")
    return out


def _mp_check_sweep(spec: dict, ranks: list, steps: int, slices: dict) -> dict:
    """The sharded sweep's checks: every strip written once, each rank's
    4-image batch (one batch of the bf16 forward's launches), the totals
    reduced to MP_IMAGES on both ranks, the rerun editing nothing and
    building no pipeline, and each rank's strips byte for byte those of the
    one-process run over its slice (``_mp_slices``)."""
    from pnpinversion_tpu_torch.data.pie_bench import PieBenchDataset

    per_rank = MP_IMAGES // MP_RANKS
    want_counts = {"fwd": FLASH_SITES * 2 * steps, "prep": 0, "main": 0, "convert": 0}
    for r, res in enumerate(ranks):
        done, again = res["sweep"]["done"], res["rerun"]["done"]
        if (done != {"images": per_rank, "images_total": MP_IMAGES, "batch": BATCH, "rank": r,
                     "world": MP_RANKS} or res["sweep"]["launches"] != want_counts):
            raise AssertionError(f"rank {r}'s sweep: {res['sweep']}, want {per_rank} images at "
                                 f"batch {BATCH}, {MP_IMAGES} in all, launches {want_counts}")
        if (again["images"], again["images_total"], res["rerun"]["pipelines"]) != (0, 0, 0) or any(
                res["rerun"]["launches"].values()):
            raise AssertionError(f"rank {r}'s rerun edited: {res['rerun']}")
    events = [json.loads(line) for line in open(spec["sweep_log"])]
    written = sorted(e["key"] for e in events if e["event"] == "image_done")
    if written != sorted(f"{i:09d}" for i in range(MP_IMAGES)):
        raise AssertionError(f"strips written: {written}, want each of {MP_IMAGES} once")
    totals = sorted((e["process_index"], e["images_total"]) for e in events
                    if e["event"] == "sweep_done")
    if totals != [(0, 0), (0, MP_IMAGES), (1, 0), (1, MP_IMAGES)]:
        raise AssertionError(f"sweep_done events {totals}")
    folder = os.path.join("directinversion+p2p", "annotation_images")
    items = list(PieBenchDataset(spec["data"]).items())
    for r in range(MP_RANKS):
        for it in items[r::MP_RANKS]:
            rel = os.path.relpath(it.image_path, os.path.join(spec["data"], "annotation_images"))
            with open(os.path.join(spec["sweep_out"], folder, rel), "rb") as f:
                got = f.read()
            with open(os.path.join(slices[r]["dir"], folder, rel), "rb") as f:
                if f.read() != got:
                    raise AssertionError(f"rank {r}'s strip {rel} is not the one-process run's")
    return {"slices": {r: {k: v for k, v in row.items() if k != "dir"}
                       for r, row in slices.items()}, "strips_equal_one_process": True}


def _update_diff(before: list, after: list, other_before: list, other_after: list,
                 names: list, lr: float, device) -> dict:
    """Two runs' updates of every parameter tensor, (after - before), compared
    in units of the lr: per tensor the median and the max of |difference|;
    over all of them the worst median, the worst max (and its tensor), the
    share of elements apart by more than 0.1 lr, and the difference's L2
    norm over the update's."""
    medians, maxes, over, n, d2, u2 = {}, {}, 0, 0, 0.0, 0.0
    for name, b, a, ob, oa in zip(names, before, after, other_before, other_after):
        u = (a.to(device) - b.to(device)).float()
        d = ((oa.to(device) - ob.to(device)).float() - u).abs() / lr
        medians[name], maxes[name] = d.median().item(), d.max().item()
        over += int((d > 0.1).sum())
        n += d.numel()
        d2 += float((d * lr).double().pow(2).sum())
        u2 += float(u.double().pow(2).sum())
    worst = max(maxes, key=maxes.get)
    return {"median_max_in_lr": max(medians.values()), "max_in_lr": maxes[worst],
            "max_tensor": worst, "share_over_0.1_lr": over / n,
            "l2_rel": (d2 / max(u2, 1e-30)) ** 0.5,
            "top_tensors_max_in_lr": {k: maxes[k] for k in sorted(maxes, key=maxes.get)[-5:]}}


def _mp_reference(spec: dict) -> dict:
    """The one-process reference of the ranks' training (in the parent,
    while the ranks run): the runner's trainer at batch 8 x accumulation 4
    on the ranks' rows of MP_STEPS steps (microbatch by microbatch, rank by
    rank, with their rows of the global draws), counted; then the same steps
    again from the same start (its run-to-run noise). Returns the trainer,
    its pipeline and data streams, the start and the first run's parameters
    (on the host), the first run's metrics and launches."""
    from pnpinversion_tpu_torch.training import trainer as tr

    gc.collect()
    torch.cuda.empty_cache()  # the card is shared with the ranks: hold only what is used
    ref, pipe = _mp_trainer(spec, True, MP_REF_ACCUM, None)
    take = _mp_streams(spec, pipe)
    start = [p.detach().to("cpu", copy=True) for p in ref.params]
    steps, b = [], MP_BATCH // MP_RANKS
    for step in range(MP_STEPS):
        per_rank = [take(r, MP_ACCUM) for r in range(MP_RANKS)]
        gen = tr.step_generator(MP_SEED, step, ref.device)
        batch, draws = {k: [] for k in per_rank[0]}, []
        for i in range(MP_ACCUM):  # microbatch i of every rank, in rank order
            d = ref.draw(MP_BATCH, TRAIN_CROP, gen)
            for r in range(MP_RANKS):
                for k in batch:
                    batch[k].append(per_rank[r][k][i])
                draws.append({k: v[r * b: (r + 1) * b] for k, v in d.items()})
        steps.append(({k: (torch.stack(v) if k == "ids" else np.stack(v))
                       for k, v in batch.items()}, draws))
    out = {"ref": ref, "pipe": pipe, "take": take, "start": start, "metrics": []}
    for run in range(2):  # the steps, then the same steps again from the same start
        with torch.no_grad():
            for p, e, p0 in zip(ref.params, ref.ema_params, start):
                p.copy_(p0)
                e.copy_(p0)
            for m_ in ref.mu + ref.nu:
                m_.zero_()
        ref.count = ref.step = 0
        _reset_counts()
        for batch, draws in steps:
            m, t = _sync_time(lambda: ref.train_step(batch, draws=draws))
            if run == 0:
                out["metrics"].append(({k: float(v) for k, v in m.items()}, t))
        _check_train_launches("the one-process reference", _counts(),
                              MP_STEPS * MP_REF_ACCUM // TRAIN_ACCUM, remat=False)
        if run == 0:
            out["launches"] = _counts()
            out["run0"] = [p.detach().to("cpu", copy=True) for p in ref.params]
    return out


def _mp_check_training(spec: dict, ranks: list, reference: dict) -> dict:
    """The two ranks' training against the one-process reference
    (``_mp_reference``) on the same 32 rows a step: the losses (the first
    step's within MP_LOSS_RTOL, the second's within TRAIN_GNORM_RTOL) and the
    grad norms within TRAIN_GNORM_RTOL; then the steps' update of every
    parameter tensor (``_update_diff``) in the ranks' checkpoint against the
    one process's, held to the one process against itself (the bf16
    backward's reduce-adds and cuDNN vary run to run): each statistic within
    MP_NOISE_FACTOR of that noise plus its MP_NOISE_FLOOR. Then the
    checkpoint restored at one process takes the next step (counted) beside
    the one process's own next step: the loss within TRAIN_GNORM_RTOL, that
    step's update held to the same bound."""
    from pnpinversion_tpu_torch.training import trainer as tr

    log = [json.loads(line) for line in open(os.path.join(spec["train_out"], "train_log.jsonl"))]
    train = [e for e in log if e["event"] == "train"]
    if [e["event"] for e in log] != ["train"] * MP_STEPS + ["done"]:
        raise AssertionError(f"the runner's log (rank 0 alone): {[e['event'] for e in log]}")
    for r, res in enumerate(ranks):
        _check_train_launches(f"rank {r}'s training", res["train"]["launches"], MP_STEPS,
                              remat=False)
        if res["no_zero_step"]["loss"] != ranks[0]["no_zero_step"]["loss"]:
            raise AssertionError("the ranks report different losses")
    if abs(ranks[0]["no_zero_step"]["loss"] / train[0]["loss"] - 1) > MP_LOSS_RTOL:
        raise AssertionError(f"the first step without ZeRO: loss {ranks[0]['no_zero_step']}, "
                             f"with ZeRO {train[0]}")
    ref, take, start = reference["ref"], reference["take"], reference["start"]
    out = {"steps": [], "launches": reference["launches"]}
    for step, (m, t) in enumerate(reference["metrics"]):
        rel = {k: abs(train[step][k] / m[k] - 1) for k in ("loss", "grad_norm")}
        out["steps"].append({"ranks": {k: train[step][k] for k in m}, "one_process": m,
                             "rel_diff": rel, "one_process_step_s": t})
        if (rel["loss"] > (MP_LOSS_RTOL if step == 0 else TRAIN_GNORM_RTOL)
                or rel["grad_norm"] > TRAIN_GNORM_RTOL):
            raise AssertionError(f"step {step + 1}: the ranks' {train[step]} against one "
                                 f"process's {m}")
    lr = ref.learning_rate(MP_STEPS - 1)
    path = os.path.join(spec["train_out"], f"step_{MP_STEPS:08d}.pt")
    state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    ranks_params = [state["params"][n] for n in ref.names]
    noise = _update_diff(start, reference["run0"], start, ref.params, ref.names, lr, ref.device)
    out["update_one_process_rerun"] = noise
    out["update_vs_one_process"] = _update_diff(start, reference["run0"], start, ranks_params,
                                                ref.names, lr, ref.device)
    # the next step from the one process's own state, and from the ranks' checkpoint
    nxt = take(0, MP_REF_ACCUM)
    before = [p.detach().clone() for p in ref.params]
    m_ref = ref.train_step(nxt, tr.step_generator(MP_SEED, MP_STEPS, ref.device))
    after = [p.detach().clone() for p in ref.params]
    _, t_restore = _sync_time(lambda: ref.load_state_dict(state))
    _reset_counts()
    m = ref.train_step(nxt, tr.step_generator(MP_SEED, MP_STEPS, ref.device))
    _check_train_launches("the step after the restore", _counts(),
                          MP_REF_ACCUM // TRAIN_ACCUM, remat=False)
    out["resumed_at_one_process"] = {
        "step": ref.step, "loss": float(m["loss"]), "uninterrupted_loss": float(m_ref["loss"]),
        "restore_s": t_restore,
        "update_vs_uninterrupted": _update_diff(before, after, ranks_params, ref.params,
                                                ref.names, lr, ref.device)}
    out["checkpoint_gib"] = os.path.getsize(path) / 2**30
    res = out["resumed_at_one_process"]
    bad = [(name, key) for name, row in (("the two steps", out["update_vs_one_process"]),
                                         ("the step after the restore",
                                          res["update_vs_uninterrupted"]))
           for key, floor in MP_NOISE_FLOOR.items()
           if row[key] > MP_NOISE_FACTOR * noise[key] + floor]
    if (bad or ref.step != MP_STEPS + 1
            or abs(res["loss"] / res["uninterrupted_loss"] - 1) > TRAIN_GNORM_RTOL):
        raise AssertionError(f"the ranks' updates beyond the one process's own noise ({bad}) or "
                             f"the step after the restore: {json.dumps(out)[:3000]}")
    reference.clear()
    del ref, before, after, state, ranks_params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def multi_process_phase(started) -> dict:
    """The multi-process paths on the smoke's f16 SD1.4 directory (written by
    ``entry_points_phase``, which leaves it), with the ranks ``mp_start``
    started before it: MP_RANKS processes on the one card, joined by gloo,
    run ``runners.run_sweep_sharded`` over an MP_IMAGES-image mini PIE-Bench
    (x4 a rank, bf16, at the spec's steps), the same again, one step without
    ZeRO and the training runner with ZeRO (MP_STEPS steps of a global batch
    of MP_BATCH x MP_ACCUM at 256^2: 8 rows a rank); the checks of
    ``_mp_check_sweep`` and ``_mp_check_training``; each rank's peak memory
    with ZeRO and without. The kernels are built before the ranks start,
    which load them. ``mp_start(device="cpu")`` lets a CPU rehearsal run it
    (after ``entry_points_phase(config=TINY, device="cpu", keep=True)``)."""
    t0 = time.perf_counter()
    spec, steps = started[0], started[0]["steps"]
    _mini_pie_bench(MP_DIR, MP_IMAGES, 512)
    _pair_dataset(spec["pairs"], MP_PAIRS, TRAIN_CROP)
    ranks, (slices, reference) = _mp_run(started, lambda: (_mp_slices(spec, steps),
                                                           _mp_reference(spec)))
    t_ranks = time.perf_counter() - t0
    for res in ranks:
        for key in PATH_SHAPES:
            PATH_SHAPES[key].update(tuple(s) for s in res["path_shapes"][key])
    out = {"ranks": MP_RANKS, "backend": "gloo", "ranks_s": t_ranks}
    out["sweep"] = {
        "images": MP_IMAGES, "steps": steps, "batch": BATCH,
        "per_rank": [{k: res["sweep"][k] for k in ("run_s", "load_s", "launches")}
                     for res in ranks],
        # both ranks edit at once, beside the parent's one-process runs: the
        # slower rank's edits over all the images (scripts/
        # time_torch_multi_process.py times them alone)
        "s_per_image_aggregate": max(res["sweep"]["run_s"] - sum(res["sweep"]["load_s"])
                                     for res in ranks) / MP_IMAGES,
        "rerun_s": [res["rerun"]["run_s"] for res in ranks],
        **_mp_check_sweep(spec, ranks, steps, slices)}
    print("multi_process_sweep", json.dumps(out["sweep"]), flush=True)
    out["training"] = {
        "global_batch": MP_BATCH, "accumulate_grad_batches": MP_ACCUM, "steps": MP_STEPS,
        "per_rank": [{"run_s": res["train"]["run_s"], "launches": res["train"]["launches"],
                      "peak_gib_zero": res["train"]["peak_gib"],
                      "peak_gib_no_zero": res["no_zero_step"]["peak_gib"],
                      "no_zero_step_s": res["no_zero_step"]["step_s"]} for res in ranks],
        **_mp_check_training(spec, ranks, reference)}
    print("multi_process_training", json.dumps(out["training"]), flush=True)
    out["phase_s"] = time.perf_counter() - t0
    print("multi_process", json.dumps({k: out[k] for k in ("ranks", "backend", "ranks_s",
                                                          "phase_s")}), flush=True)
    return out


# ---------------------------------------------------------------------------
# the weight-only int8 UNet (--quant w8) and the tensor-parallel axis (--tp)
# ---------------------------------------------------------------------------

W8_TIMED_STEPS = 50  # the x1 edits, float then w8: the main path's steps
# one bf16 UNet call of the w8 UNet against the float one, relative L2 of
# eps: the JAX package holds TINY's f32 call to 0.02; SD1.4's depth and the
# bf16 activations add their own rounding
W8_EPS_REL_L2 = 0.05
TP_DIR = "build/smoke_tp"  # git-ignored; removed when the phase ends
TP_RANKS = 2  # one tp group on the one card (gloo)
TP_IMAGES = 2  # the sweep's images: one batch of the group
TP_STEPS = 2  # DDIM steps of the tp sweep: its UNet shapes do not depend on them
TP_PAIRS = 12  # seeds.json items of the training step's data (TRAIN_BATCH in the train split)
TP_UNET_ROWS = 2  # rows of the UNet call held against one process's
TP_F32_EPS_RTOL = 1e-4  # the f32 call split against whole: sums in another order, of max |eps|
# the tp results in bf16 against one process's, held to this factor of one
# process's own bf16 spread: the UNet call's and the loss's distance from
# their f32 forms, the panels' distance between batch 1 and batch 2 (C5),
# plus the floors
TP_SPREAD_FACTOR = 2.0
TP_LOSS_FLOOR_RTOL = 1e-3
TP_PANEL_FLOOR = 2.0  # uint8 levels of mean |difference|


def _module_bytes(module) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def _seeded_unet_inputs(config, device, rows: int, seed: int):
    """Latents (rows, h, w, C) and contexts (rows, 77, D), f32, from a CPU
    generator (the same in every process)."""
    g = torch.Generator().manual_seed(seed)
    s = config.unet.sample_size
    x = torch.randn((rows, s, s, config.unet.in_channels), generator=g)
    ctx = torch.randn((rows, config.text.max_length, config.unet.context_dim), generator=g)
    return x.to(device), ctx.to(device)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def w8_phase(entry: dict, config=None, steps: int = ENTRY_STEPS,
             timed_steps: int = W8_TIMED_STEPS, device: str = "cuda") -> dict:
    """The weight-only int8 UNet (``--quant w8``, ``ops/quant.py``) at full
    SD1.4 width in bf16 on the smoke's SD1.4 directory (left by
    ``entry_points_phase(keep=True)``):

    - ``runners.run_sweep --quant w8`` over the BATCH-image mini PIE-Bench at
      ``steps`` (x BATCH): its UNet quantized, its launches (one batch of the
      bf16 forward), every strip written at 512x2048x3, seconds per image
      against the float sweep's in ``entry``;
    - on one bf16 pipeline of the directory: one UNet call's eps float and
      then w8 (relative L2 within W8_EPS_REL_L2), the UNet's weight bytes
      both ways, and a counted x1 directinversion+p2p edit at
      ``timed_steps`` float and then w8 (each after a 2-step warm-up):
      seconds and peak memory.

    ``config`` and ``device`` let a CPU rehearsal run it at TINY."""
    from PIL import Image

    from pnpinversion_tpu_torch import configs
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.ops.quant import is_quantized, quantize_unet_dots
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.runners import run_sweep

    t0 = time.perf_counter()
    config = config or configs.SD14
    ckpt, data = os.path.join(ENTRY_DIR, "sd14"), os.path.join(ENTRY_DIR, "data")
    sweep_out = os.path.join(ENTRY_DIR, "sweep_w8")
    _reset_counts()
    with _CreateSpy() as spy:
        done, t_sweep = _sync_time(lambda: run_sweep.main(
            ["--data_path", data, "--checkpoint_dir", ckpt, "--num_ddim_steps", str(steps),
             "--device", device, "--output_path", sweep_out, "--edit_category_list", "0", "1",
             "--quant", "w8"]))
    counts = _counts()
    want_counts = {"fwd": FLASH_SITES * 2 * steps, "prep": 0, "main": 0, "convert": 0}
    if (not is_quantized(spy.pipes[0].unet) or done["images"] != BATCH
            or device == "cuda" and (counts != want_counts or done["batch"] != BATCH)):
        raise AssertionError(f"w8 sweep: {done}, launches {counts}, want {want_counts}")
    folder = os.path.join(sweep_out, "directinversion+p2p", "annotation_images")
    strips = sorted(os.path.join(d, f) for d, _, files in os.walk(folder) for f in files)
    if len(strips) != BATCH:
        raise AssertionError(f"w8 sweep wrote {strips}")
    for path in strips:
        _check_strip_size(np.asarray(Image.open(path)), config.image_size)
    out = {"sweep": {"images": done["images"], "batch": done["batch"], "steps": steps,
                     "run_s": t_sweep, "load_s": spy.seconds[0],
                     "s_per_image": (t_sweep - spy.seconds[0]) / done["images"],
                     "float_s_per_image": entry["sweep"]["s_per_image"], "launches": counts}}
    del spy
    gc.collect()
    torch.cuda.empty_cache()

    pipe = SDPipeline.create(config, checkpoint_dir=ckpt, device=device,
                             num_ddim_steps=timed_steps)
    x, ctx = _seeded_unet_inputs(config, pipe.device, 2, 77)
    x, ctx = x.to(pipe.dtype), ctx.to(pipe.dtype)
    editor, warm = P2PEditor(pipe), P2PEditor(_pipe_at(pipe, 2))
    img = _random_images(4321, config.image_size)()
    rows, eps = {}, {}
    for mode in ("float", "w8"):
        if mode == "w8":
            quantize_unet_dots(pipe.unet)  # in place: the editors share the module
        with torch.inference_mode():
            eps[mode] = pipe.unet(x, 500, ctx)[0].float()
        warm("directinversion+p2p", img, SRC, TAR, **EDIT_KW)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        strip, t = _sync_time(lambda: editor("directinversion+p2p", img, SRC, TAR, **EDIT_KW))
        counts = _counts()
        _check_strip_size(strip, config.image_size)
        want = {"fwd": FLASH_SITES * 2 * timed_steps, "prep": 0, "main": 0, "convert": 0}
        if device == "cuda" and counts != want:
            raise AssertionError(f"{mode} x1 edit: launches {counts}, want {want}")
        rows[mode] = {"edit_s": t, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "unet_weight_bytes": _module_bytes(pipe.unet), "launches": counts}
    rel = _rel_l2(eps["w8"], eps["float"])
    if not (torch.isfinite(eps["w8"]).all() and rel <= W8_EPS_REL_L2):
        raise AssertionError(f"w8 eps {rel} from the float UNet's, limit {W8_EPS_REL_L2}")
    out.update(x1=rows, steps=timed_steps, eps_rel_l2_vs_float=rel,
               eps_rel_l2_limit=W8_EPS_REL_L2,
               weight_bytes_ratio=rows["w8"]["unet_weight_bytes"]
               / rows["float"]["unet_weight_bytes"],
               phase_s=time.perf_counter() - t0)
    del editor, warm, pipe
    gc.collect()
    torch.cuda.empty_cache()
    print("w8", json.dumps(out), flush=True)
    return out


def _tp_sweep_argv(spec: dict, out: str, log: str, batch: int) -> list:
    return ["--method", "directinversion+p2p", "--data_path", spec["data"], "--output_path", out,
            "--checkpoint_dir", spec["ckpt"], "--num_ddim_steps", str(TP_STEPS),
            "--batch_per_device", str(batch), "--edit_category_list", "0", "1", "--run_log",
            log, "--device", spec["device"]]


def _tp_trainer(spec: dict, grid=None):
    """The training runner's trainer on the smoke's SD1.4 directory (its
    4-channel UNet widened to 8; batch TRAIN_BATCH, one microbatch, ZeRO),
    split over ``grid``'s tp group where one is given; returns (trainer,
    pipeline)."""
    from pnpinversion_tpu_torch.configs import IP2P
    from pnpinversion_tpu_torch.pipeline import SDPipeline
    from pnpinversion_tpu_torch.training import trainer as tr

    cfg4 = dataclasses.replace(IP2P, unet=dataclasses.replace(IP2P.unet, in_channels=4))
    pipe = SDPipeline.create(cfg4, seed=MP_SEED, checkpoint_dir=spec["ckpt"],
                             device=spec["device"])
    unet8 = tr.extend_conv_in(pipe.unet, IP2P.unet.in_channels)
    pipe.unet = None
    model_cfg = dataclasses.replace(pipe.config, unet=unet8.config)
    trainer = tr.EditTrainer(model_cfg, {"vae": pipe.vae, "text": pipe.text_encoder}, unet8,
                             tr.TrainConfig(base_lr=MP_LR, scale_lr=False, accum=1),
                             TRAIN_BATCH, pipe.tokenize([""])[0],
                             group=grid.dp_group if grid else None,
                             tp_group=grid.tp_group if grid else None)
    return trainer, pipe


def _tp_batch(spec: dict, pipe) -> dict:
    """One microbatch of TRAIN_BATCH rows of the pairs at 256^2, as the
    training runner reads them (dp index 0)."""
    from pnpinversion_tpu_torch.training.data import EditPairDataset, WeightedConcat, batches

    src = WeightedConcat([EditPairDataset(spec["pairs"], split="train",
                                          min_resize_res=TRAIN_CROP, max_resize_res=TRAIN_CROP,
                                          crop_res=TRAIN_CROP, flip_prob=0.5)], None)
    p = next(batches(src, TRAIN_BATCH, seed=MP_SEED, process_index=0))
    return {"edited": p["edited"][None], "cond_image": p["cond_image"][None],
            "ids": pipe.tokenize(p["edit"])[None]}


def _tp_rank(rank: int, address: str, spec: dict) -> None:
    """One of the TP_RANKS processes on the card (spawned), one tp group:
    joins the gloo group and warms its CUDA context, waits for the phase's
    data, then runs ``run_sweep_sharded --tp`` (counted, its gathers
    counted), one UNet call on the sweep's split pipeline in bf16 and in f32
    (rank 0 keeps their eps), and one trainer step split over the group
    (counted; its peak memory); writes its numbers to TP_DIR/rank<r>.json."""
    from pnpinversion_tpu_torch.parallel import multihost
    from pnpinversion_tpu_torch.parallel import tensor_parallel as tpar
    from pnpinversion_tpu_torch.runners import run_sweep_sharded
    from pnpinversion_tpu_torch.training import trainer as tr

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (MP_RANKS + TP_RANKS)))
    _record_path_shapes()
    multihost.initialize(address, TP_RANKS, rank, "gloo", spec["device"])
    if spec["device"] == "cuda":  # the context, cuDNN and cuBLAS, while the parent works
        x = torch.randn(1, 8, 16, 16, device="cuda", dtype=torch.bfloat16)
        torch.nn.functional.conv2d(x, torch.randn(8, 8, 3, 3, device=x.device, dtype=x.dtype))
        (x.flatten(1) @ x.flatten(1).T).sum().item()
    deadline = time.perf_counter() + MP_TIMEOUT_S
    while not os.path.exists(spec["ready"]):
        if time.perf_counter() > deadline:
            raise AssertionError(f"rank {rank}: no {spec['ready']} within {MP_TIMEOUT_S} s")
        time.sleep(0.2)
    gathers = {"calls": 0, "bytes": 0}
    gather = multihost.all_gather_columns

    def counted(y, axis, group):
        whole = gather(y, axis, group)
        gathers["calls"] += 1
        gathers["bytes"] += whole.numel() * whole.element_size()
        return whole

    multihost.all_gather_columns = counted
    flags = ["--num_processes", str(TP_RANKS), "--process_id", str(rank),
             "--coordinator_address", address, "--dist_backend", "gloo", "--tp", str(TP_RANKS)]
    out = {}
    try:
        _reset_counts()
        with _CreateSpy() as spy:
            done, t = _sync_time(lambda: run_sweep_sharded.main(
                _tp_sweep_argv(spec, spec["sweep_out"], spec["sweep_log"], TP_IMAGES) + flags))
        out["sweep"] = {"done": done, "run_s": t, "load_s": spy.seconds, "launches": _counts(),
                        "gathers": dict(gathers)}
        pipe = spy.pipes[0]
        del spy
        x, ctx = _seeded_unet_inputs(pipe.config, pipe.device, TP_UNET_ROWS, 77)
        out["unet_call"] = {}
        with torch.inference_mode():
            for name, dt in (("bf16", pipe.dtype), ("f32", torch.float32)):
                pipe.unet(x.to(dt), 500, ctx.to(dt))  # warm-up
                before = dict(gathers)
                eps, t = _sync_time(lambda: pipe.unet(x.to(dt), 500, ctx.to(dt))[0])
                out["unet_call"][name] = {"s": t, "gathers": gathers["calls"] - before["calls"],
                                          "gathered_bytes": gathers["bytes"] - before["bytes"]}
                if rank == 0:
                    torch.save(eps.float().cpu(), os.path.join(spec["dir"], f"eps_{name}.pt"))
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer, tpipe = _tp_trainer(spec, tpar.make_groups(TP_RANKS))
        batch = _tp_batch(spec, tpipe)
        _reset_counts()
        before = dict(gathers)
        m, t = _sync_time(lambda: trainer.train_step(batch, tr.step_generator(
            MP_SEED, 0, trainer.device)))
        out["train"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                        "step_s": t, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "launches": _counts(), "gathers": gathers["calls"] - before["calls"],
                        "split_tensors": sum(a is not None for a in trainer.tp_axes)}
    finally:
        multihost.shutdown()
    out["path_shapes"] = {k: sorted(v) for k, v in PATH_SHAPES.items()}
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def tp_start(device: str = "cuda"):
    """Starts the TP_RANKS ranks of ``tp_phase`` (spawned ``_tp_rank``s):
    each joins its gloo group and warms its CUDA context, then waits for the
    phase to write its data. Returns the phase's spec and the processes;
    ``tp_stop`` ends them."""
    import shutil

    import torch.multiprocessing as mp

    from pnpinversion_tpu_torch.parallel import multihost

    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    spec = {"dir": TP_DIR, "ckpt": os.path.join(ENTRY_DIR, "sd14"), "device": device,
            "data": os.path.join(TP_DIR, "data"), "pairs": os.path.join(TP_DIR, "pairs"),
            "ready": os.path.join(TP_DIR, "ready"), "sweep_out": os.path.join(TP_DIR, "sweep"),
            "sweep_log": os.path.join(TP_DIR, "sweep_log.jsonl")}
    ctx = mp.start_processes(_tp_rank, args=(f"127.0.0.1:{multihost.free_port()}", spec),
                             nprocs=TP_RANKS, join=False, start_method="spawn")
    return spec, ctx


def tp_stop(started) -> None:
    """Ends the ranks that are still running and removes TP_DIR."""
    import shutil

    for p in started[1].processes:
        if p.is_alive():
            p.terminate()
        p.join()
    shutil.rmtree(TP_DIR, ignore_errors=True)


def _tp_reference(spec: dict) -> dict:
    """One process's runs of what the ranks run (in the parent, beside
    them): ``run_sweep`` over the same images at batch TP_IMAGES and at 1
    (batch 1 against batch 2 is one process's own bf16 spread, C5), the same
    UNet call in bf16 and in f32 on the batch-2 run's pipeline, and the same
    trainer step whole, with its loss also in f32."""
    import dataclasses as dc

    from pnpinversion_tpu_torch.runners import run_sweep
    from pnpinversion_tpu_torch.training import trainer as tr

    out = {"sweeps": {}, "eps": {}, "unet_call_s": {}}
    for batch in (TP_IMAGES, 1):
        dest = os.path.join(spec["dir"], f"one_x{batch}")
        with _CreateSpy() as spy:
            done, t = _sync_time(lambda: run_sweep.main(_tp_sweep_argv(
                spec, dest, os.path.join(spec["dir"], f"one_x{batch}.jsonl"), batch)))
        if done != {"images": TP_IMAGES, "batch": batch}:
            raise AssertionError(f"one-process sweep at batch {batch}: {done}")
        out["sweeps"][batch] = {"dir": dest, "run_s": t, "load_s": spy.seconds[0]}
        if batch == TP_IMAGES:
            pipe = spy.pipes[0]
        del spy
    x, ctx = _seeded_unet_inputs(pipe.config, pipe.device, TP_UNET_ROWS, 77)
    with torch.inference_mode():
        for name, dt in (("bf16", pipe.dtype), ("f32", torch.float32)):
            pipe.unet(x.to(dt), 500, ctx.to(dt))
            eps, out["unet_call_s"][name] = _sync_time(
                lambda: pipe.unet(x.to(dt), 500, ctx.to(dt))[0])
            out["eps"][name] = eps.float().cpu()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    trainer, tpipe = _tp_trainer(spec)
    batch = _tp_batch(spec, tpipe)
    torch.cuda.reset_peak_memory_stats()
    draws = trainer.draw(TRAIN_BATCH, TRAIN_CROP, tr.step_generator(MP_SEED, 0, trainer.device))
    cfg, trainer.cfg = trainer.cfg, dc.replace(trainer.cfg, dtype=torch.float32)
    with torch.no_grad():
        loss_f32 = float(trainer.microbatch_loss(
            trainer.unet, torch.as_tensor(batch["edited"][0], device=trainer.device).float(),
            torch.as_tensor(batch["cond_image"][0], device=trainer.device).float(),
            batch["ids"][0].to(trainer.device), draws))
    trainer.cfg = cfg
    m, t = _sync_time(lambda: trainer.train_step(batch, tr.step_generator(MP_SEED, 0,
                                                                         trainer.device)))
    out["train"] = {"loss": float(m["loss"]), "loss_f32": loss_f32,
                    "grad_norm": float(m["grad_norm"]), "step_s": t,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del trainer, tpipe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _jpeg_panels(path: str, size: int) -> np.ndarray:
    from PIL import Image

    strip = np.asarray(Image.open(path).convert("RGB")).astype(np.int64)
    return strip.reshape(size, 4, size, 3).transpose(1, 0, 2, 3)  # (panel, H, W, 3)


def tp_phase(started, size: int = 512) -> dict:
    """The tensor-parallel axis on the smoke's SD1.4 directory, with the
    ranks ``tp_start`` started early: TP_RANKS processes on the one card,
    one tp group over gloo, run ``run_sweep_sharded --tp`` over a
    TP_IMAGES-image mini PIE-Bench at TP_STEPS (bf16, the pipeline's UNet,
    VAE and text tower split by output columns), one UNet call in bf16 and
    in f32, and one trainer step of TRAIN_BATCH rows at 256^2 split over the
    group; one process runs the same beside them (``_tp_reference``). The
    checks: every strip written once by tp index 0 and each image counted
    once; the ranks' launches the one-process count; the f32 eps within
    TP_F32_EPS_RTOL of one process's; the bf16 eps, the panels (mean |diff|
    of the reconstruction and of the edit) and the loss within
    TP_SPREAD_FACTOR of one process's own bf16 spread plus their floors.
    ``size`` lets a CPU rehearsal run it at TINY."""
    t0 = time.perf_counter()
    spec = started[0]
    _mini_pie_bench(TP_DIR, TP_IMAGES, size)
    _pair_dataset(spec["pairs"], TP_PAIRS, TRAIN_CROP)
    ranks, ref = _mp_run(started, lambda: _tp_reference(spec))
    for res in ranks:
        for key in PATH_SHAPES:
            PATH_SHAPES[key].update(tuple(s) for s in res["path_shapes"][key])
    want = {"fwd": FLASH_SITES * 2 * TP_STEPS, "prep": 0, "main": 0, "convert": 0}
    for r, res in enumerate(ranks):
        done = res["sweep"]["done"]
        if (done != {"images": TP_IMAGES if r == 0 else 0, "images_total": TP_IMAGES,
                     "batch": TP_IMAGES, "rank": r, "world": TP_RANKS}
                or spec["device"] == "cuda" and res["sweep"]["launches"] != want):
            raise AssertionError(f"rank {r}'s tp sweep: {res['sweep']}, launches want {want}")
        train = res["train"]["launches"]
        if spec["device"] == "cuda" and not (train["fwd"] == train["prep"] == train["main"]
                                             == train["convert"] == TRAIN_SITES):
            raise AssertionError(f"rank {r}'s tp training step: launches {train}")
    events = [json.loads(line) for line in open(spec["sweep_log"])]
    written = sorted(e["key"] for e in events if e["event"] == "image_done")
    if written != [f"{i:09d}" for i in range(TP_IMAGES)] or [
            (e["process_index"], e["images_total"]) for e in events
            if e["event"] == "sweep_done"] != [(0, TP_IMAGES)]:
        raise AssertionError(f"tp sweep log: {events}")
    # the panels: recon and edit of each image, against one process at batch 2
    from pnpinversion_tpu_torch.data.pie_bench import PieBenchDataset

    diffs = {"tp": {"recon": [], "edit": []}, "spread": {"recon": [], "edit": []}}
    folder = os.path.join("directinversion+p2p", "annotation_images")
    for it in PieBenchDataset(spec["data"]).items():
        rel = os.path.relpath(it.image_path, os.path.join(spec["data"], "annotation_images"))
        got, two, one = (_jpeg_panels(os.path.join(d, folder, rel), size) for d in (
            spec["sweep_out"], ref["sweeps"][TP_IMAGES]["dir"], ref["sweeps"][1]["dir"]))
        # the text panel, and the image panel less the columns whose chroma
        # the JPEG decoder's upsampling mixes with the next panel's
        if not all(np.array_equal(a[0], two[0]) and np.array_equal(a[1][:, :-8], two[1][:, :-8])
                   for a in (got, one)):
            raise AssertionError(f"{rel}: the text or image panel differs")
        for k, panel in (("recon", 2), ("edit", 3)):
            diffs["tp"][k].append(float(np.abs(got[panel] - two[panel]).mean()))
            diffs["spread"][k].append(float(np.abs(one[panel] - two[panel]).mean()))
    eps = {name: torch.load(os.path.join(spec["dir"], f"eps_{name}.pt")) for name in ("bf16",
                                                                                     "f32")}
    one_eps = ref["eps"]
    f32_err = float((eps["f32"] - one_eps["f32"]).abs().max() / one_eps["f32"].abs().max())
    bf16_rel, bf16_spread = _rel_l2(eps["bf16"], one_eps["bf16"]), _rel_l2(one_eps["bf16"],
                                                                           one_eps["f32"])
    loss, one_loss = ranks[0]["train"]["loss"], ref["train"]["loss"]
    loss_bound = (TP_SPREAD_FACTOR * abs(one_loss - ref["train"]["loss_f32"])
                  + TP_LOSS_FLOOR_RTOL * abs(one_loss))
    panel_bound = {k: TP_SPREAD_FACTOR * max(diffs["spread"][k]) + TP_PANEL_FLOOR
                   for k in ("recon", "edit")}
    out = {"ranks": TP_RANKS, "backend": "gloo", "images": TP_IMAGES, "steps": TP_STEPS,
           "sweep_per_rank": [{k: res["sweep"][k] for k in ("run_s", "load_s", "gathers",
                                                            "launches")}
                              for res in ranks],
           "unet_call": {"rows": TP_UNET_ROWS, "per_rank": [res["unet_call"] for res in ranks],
                         "one_process_s": ref["unet_call_s"], "f32_max_err": f32_err,
                         "f32_limit": TP_F32_EPS_RTOL, "bf16_rel_l2": bf16_rel,
                         "bf16_limit": TP_SPREAD_FACTOR * bf16_spread,
                         "one_process_bf16_vs_f32_rel_l2": bf16_spread},
           "panels_mean_abs": {"tp_vs_one_process": diffs["tp"],
                               "one_process_x1_vs_x2": diffs["spread"], "limit": panel_bound},
           "train": {"rows": TRAIN_BATCH, "per_rank": [res["train"] for res in ranks],
                     "one_process": ref["train"], "loss_limit": loss_bound},
           "one_process_sweeps": {b: {k: v for k, v in row.items() if k != "dir"}
                                  for b, row in ref["sweeps"].items()}}
    bad = []
    if not f32_err <= TP_F32_EPS_RTOL:
        bad.append("f32 eps")
    if not bf16_rel <= TP_SPREAD_FACTOR * bf16_spread:
        bad.append("bf16 eps")
    for k in ("recon", "edit"):
        if not max(diffs["tp"][k]) <= panel_bound[k]:
            bad.append(f"{k} panels")
    if any(res["train"]["loss"] != loss for res in ranks) or not abs(loss - one_loss) <= loss_bound:
        bad.append("loss")
    if bad:
        raise AssertionError(f"tp phase: {bad}: {json.dumps(out)[:3000]}")
    out["phase_s"] = time.perf_counter() - t0
    print("tensor_parallel", json.dumps(out), flush=True)
    return out


BWD_SOURCE = "pnpinversion_tpu_torch/csrc/flash_attention_bwd.cu"
F32_FWD_SOURCE = "pnpinversion_tpu_torch/csrc/flash_attention_fwd_f32.cu"
F32_BWD_SOURCE = "pnpinversion_tpu_torch/csrc/flash_attention_bwd_f32.cu"
TPU_FLASH = "pnpinversion_tpu/ops/flash_attention.py"


def _f32_entries(f32: dict, f32_path: dict, fwd_by_path: dict) -> list:
    """The f32 kernels' entries of the kernels line: the forward (its ``ms``
    covers both of its launches, the split pass and the main kernel) and its
    split pass at the f32 DirectInversion scan's 64^2 shape (3 rows) with
    their launches in the f32 directinversion+p2p edit (and, by path, in the
    f32 families of the bf16 pipeline: ``fwd_by_path``; the split pass runs
    once per forward on every path), the dQ and dK/dV kernels (each ``ms``
    covering its own split pass) and the backward's split passes at the f32
    null-text inner loop's 64^2 shape with their launches in the f32
    null-text edit. SDPA's backward computes dQ, dK and dV together, so the
    dK/dV entry's times are the whole f32 backward's (delta, both split
    passes, dQ, dK/dV), like with like, and the kernel's own times stand
    beside them."""
    fwd = next(r for r in f32["fwd_rows"] if r["case"] == "f32_rows3_64x64")
    bwd = next(r for r in f32["bwd_rows"] if r["case"] == "f32_nulltext_64x64")
    err = f32["max_abs_err"]
    di, nt = f32_path["directinversion+p2p"]["launches"], f32_path[NULL_TEXT]["launches"]
    by_path = {"fwd": {"f32 directinversion+p2p": di["fwd"], f"f32 {NULL_TEXT}": nt["fwd"],
                       **fwd_by_path},
               "bwd": {f"f32 {NULL_TEXT}": nt["dq"]},
               "bwd_split": {f"f32 {NULL_TEXT}": nt["bwd_split"]}}
    common = {"route": "cuda", "source": F32_BWD_SOURCE, "shape": bwd["shape"]}
    trace = f32_path["f32_null_text_trace"]["by_kernel"]
    fwd_common = {"route": "cuda", "source": F32_FWD_SOURCE, "replaces": f"{TPU_FLASH}:60",
                  "launches_by_path": by_path["fwd"], "shape": fwd["shape"]}
    return [
        {"name": "flash_attention_fwd_f32", **fwd_common, "launches": di["fwd"],
         "max_abs_err": max(err["o"], err["lse"]), "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
         "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
         "library_ms": fwd["library_ms"], "fp32_bound_ms": fwd["fp32_bound_ms"],
         "split_ms": fwd["split_ms"], "ms_covers": "the split pass and the main kernel",
         "batch_independence": f32["batch_independence"], "per_case": f32["fwd_rows"]},
        {"name": "flash_attention_fwd_f32_split", **fwd_common, "launches": di["split"],
         "max_abs_err": err["split"], "ms": fwd["split_ms"], "plain_ms": fwd["split_plain_ms"],
         "bound_ms": fwd["split_bound_ms"], "bound_by": "bytes", "library_ms": None,
         "part_of": "flash_attention_fwd_f32 (checked bit for bit at every f32 case)"},
        {"name": "flash_attention_bwd_dq_f32", **common, "replaces": f"{TPU_FLASH}:99",
         "launches": nt["dq"], "launches_by_path": by_path["bwd"], "max_abs_err": err["dq"],
         "ms": bwd["dq_ms"], "plain_ms": bwd["plain_dq_ms"], "bound_ms": bwd["dq_bound_ms"],
         "bound_by": bwd["dq_bound_by"], "library_ms": None,
         "fp32_bound_ms": bwd["dq_fp32_bound_ms"], "split_ms": bwd["split_dq_ms"],
         "ms_covers": "its split pass and the dQ kernel", "f32_null_text_trace": trace["dq"]},
        {"name": "flash_attention_bwd_dkv_f32", **common, "replaces": f"{TPU_FLASH}:128",
         "launches": nt["dkv"], "launches_by_path": by_path["bwd"],
         "max_abs_err": max(err["dk"], err["dv"]), "ms": bwd["bwd_ms"],
         "plain_ms": bwd["plain_bwd_ms"], "bound_ms": bwd["bwd_bound_ms"],
         "bound_by": bwd["bwd_bound_by"], "library_ms": bwd["library_bwd_ms"],
         "fp32_bound_ms": bwd["bwd_fp32_bound_ms"],
         "ms_covers": "the whole f32 backward (delta, both split passes, dQ, dK/dV), as SDPA's",
         "library_computes": "dq, dk and dv (the whole backward of f32 SDPA)",
         "dkv_kernel_ms": bwd["dkv_ms"], "dkv_kernel_plain_ms": bwd["plain_dkv_ms"],
         "dkv_kernel_bound_ms": bwd["dkv_bound_ms"],
         "dkv_kernel_fp32_bound_ms": bwd["dkv_fp32_bound_ms"], "split_ms": bwd["split_dkv_ms"],
         "dkv_kernel_ms_covers": "its split pass and the dK/dV kernel",
         "f32_null_text_trace": trace["dkv"],
         "batch_independence": f32["bwd_batch_independence"], "per_case": f32["bwd_rows"]},
        {"name": "flash_attention_bwd_f32_split", **common, "replaces": f"{TPU_FLASH}:99",
         "also_replaces": f"{TPU_FLASH}:128", "launches": nt["bwd_split"],
         "launches_by_path": by_path["bwd_split"], "max_abs_err": err["bwd_split"],
         "ms": bwd["split_dq_ms"] + bwd["split_dkv_ms"],
         "plain_ms": bwd["plain_split_dq_ms"] + bwd["plain_split_dkv_ms"],
         "bound_ms": bwd["bwd_split_dq_bound_ms"] + bwd["bwd_split_dkv_bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "ms_covers": "both split passes of one backward (dQ's of K and V, dK/dV's of Q and dO)",
         "part_of": "flash_attention_bwd_dq_f32 and flash_attention_bwd_dkv_f32 (checked bit "
                    "for bit at every f32 backward case)", "f32_null_text_trace": trace["split"]},
    ]


def _bwd_entries(bwd: dict, launches: dict) -> list:
    """The backward kernels' entries of the kernels line, at the null-text
    inner loop's 64^2 shape. The main kernel does the work of both TPU
    backward kernels (dK/dV and the dQ partials); prep and convert start and
    end B2's dQ (delta, the f32 accumulator, the bf16 dQ). SDPA's backward
    computes what all three do together, so the main entry's times are the
    whole backward's (prep + main + convert), like with like, and the main
    kernel's own times stand beside them."""
    head = next(r for r in bwd["rows"] if r["case"] == "nulltext_64x64")
    err = bwd["max_abs_err"]
    kernels = (("flash_attention_bwd_prep", "prep", "prep", f"{TPU_FLASH}:99", err["delta"], None),
               ("flash_attention_bwd_main", "main", "bwd", f"{TPU_FLASH}:128",
                max(err["dq"], err["dk"], err["dv"]), head["library_bwd_ms"]),
               ("flash_attention_bwd_dq_convert", "convert", "convert", f"{TPU_FLASH}:99",
                err["dq"], None))
    entries = []
    for name, key, timed, replaces, max_err, library in kernels:
        entries.append({
            "name": name, "route": "cuda", "source": BWD_SOURCE, "replaces": replaces,
            "launches": launches[key], "max_abs_err": max_err,
            "ms": head[f"{timed}_ms"], "plain_ms": head[f"plain_{timed}_ms"],
            "bound_ms": head[f"{timed}_bound_ms"], "bound_by": head[f"{timed}_bound_by"],
            "library_ms": library, "shape": head["shape"]})
    entries[1].update(also_replaces=f"{TPU_FLASH}:99",
                      ms_covers="the whole backward (prep, main, dQ convert), as SDPA's",
                      library_computes="dq, dk and dv (the whole backward of SDPA)",
                      main_kernel_ms=head["main_ms"], main_kernel_plain_ms=head["plain_main_ms"],
                      main_kernel_bound_ms=head["main_bound_ms"],
                      dq_run_to_run_max_abs=err["dq_run_to_run"], per_case=bwd["rows"])
    return entries


PHASE_S = {}  # seconds of each phase of ``main``, printed before the kernels line


def _timed(phase, *args, **kwargs):
    """``phase(*args, **kwargs)``, its seconds kept in PHASE_S under its name."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    PHASE_S[phase.__name__] = round(time.perf_counter() - t0, 1)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.ops import build
    from pnpinversion_tpu_torch.ops.flash_attention import (BWD_KERNEL, F32_BWD_KERNEL,
                                                            F32_FWD_KERNEL, KERNEL)
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    t_start = time.perf_counter()
    print(card_line(), flush=True)  # name, power limit: as nvidia-smi prints them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    build_s = build.build([KERNEL, BWD_KERNEL, F32_BWD_KERNEL, F32_FWD_KERNEL])
    print(f"build: {json.dumps(build_s)} total {time.perf_counter() - t0:.1f}s", flush=True)
    for name in (KERNEL, BWD_KERNEL, F32_BWD_KERNEL, F32_FWD_KERNEL):
        summary = ptxas_summary(build.build_log(name))
        print(f"ptxas {name}.cu:", *summary, sep="\n  ", flush=True)
        lost = [line for line in summary if re.search(
            r"Performance Loss|stack frame [1-9]|spill stores [1-9]|spill loads [1-9]|warning",
            line, re.IGNORECASE)]
        if lost:
            raise AssertionError(f"ptxas: spills or serialised wgmma in {name}.cu: {lost}")

    flash = _timed(kernel_phase)
    bwd = _timed(bwd_kernel_phase)
    f32 = _timed(f32_kernel_phase)
    _record_path_shapes()
    pipe, t_create = _sync_time(lambda: SDPipeline.create(SD14, seed=0, num_ddim_steps=50))
    assert pipe.device.type == "cuda" and pipe.dtype == torch.bfloat16
    main_path = _timed(main_path_phase, pipe)
    print("main_path", json.dumps({"create_s": t_create, **main_path}), flush=True)
    batched, batch_out = _timed(batched_phase, pipe, main_path["edit_s_per_image"])
    print("batched_path", json.dumps(batched), flush=True)
    null_text = _timed(null_text_phase, pipe)
    print("null_text_path", json.dumps(null_text), flush=True)
    ddim = _timed(ddim_phase, pipe)
    print("ddim_path", json.dumps(ddim), flush=True)
    variants = _timed(variants_phase, pipe)
    batched_variants = _timed(batched_variants_phase, pipe)
    early_stop = _timed(early_stop_phase, pipe)
    print("batched_null_text_early_stop", json.dumps(early_stop), flush=True)
    families = _timed(families_phase, pipe)
    masactrl_controls = _timed(masactrl_controls_phase, pipe)
    edict = _timed(edict_phase, pipe)
    pix2pix_zero = _timed(pix2pix_zero_phase, pipe)
    stylediffusion = _timed(stylediffusion_phase, pipe)
    del pipe
    gc.collect()  # free it before the SD2.1 and f32 phases read their peak memory
    torch.cuda.empty_cache()
    bld = _timed(bld_phase)
    f32_path = _timed(f32_path_phase)
    print("f32_path_summary", json.dumps(f32_path), flush=True)
    instruct = _timed(instruct_phase)
    print("instruct", json.dumps(instruct), flush=True)
    training = _timed(training_phase)
    gc.collect()
    torch.cuda.empty_cache()
    started = mp_start()  # the ranks warm their CUDA contexts during the entry points
    tp_started = tp_start()
    try:
        entry = _timed(entry_points_phase, keep=True)
        multi = _timed(multi_process_phase, started)
        w8 = _timed(w8_phase, entry)
        tp = _timed(tp_phase, tp_started)
    finally:
        import shutil

        mp_stop(started)
        tp_stop(tp_started)
        shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    print("path_shapes", json.dumps(_check_path_shapes()), flush=True)
    evaluation = _timed(eval_phase, batch_out)
    print("evaluation", json.dumps(evaluation), flush=True)

    head = next(r for r in flash["rows"] if r["case"] == "scan_64x64")
    nt_launches = null_text["launches"]
    fwd_by_path = {"directinversion+p2p": main_path["flash_launches_per_edit"],
                   f"batched directinversion+p2p x{BATCH}": batched["flash_launches_per_batch"],
                   NULL_TEXT: nt_launches["fwd"], "ddim+p2p": ddim["launches"]["fwd"]}
    bwd_by_path = {NULL_TEXT: nt_launches["main"]}
    f32_by_path = {}
    for method, row in families.items():
        by_path = f32_by_path if row["kernel"] == "f32" else fwd_by_path
        by_path[f"{row['steps']} steps: {method}"] = row["launches"]["fwd"]
        if "batch_launches" in row:
            by_path[f"batched {method} x{BATCH}"] = row["batch_launches"]["fwd"]
    for rows in (edict, instruct):
        for method, row in rows.items():
            key = "batch_launches" if method.startswith("batched") else "launches"
            if isinstance(row, dict) and key in row:
                name = f"{method} x{BATCH}" if method.startswith("batched") else method
                f32_by_path[f"{row['steps']} steps: {name}"] = row[key]["fwd"]
    for name, row in masactrl_controls.items():
        fwd_by_path[f"one UNet call, MasaCtrl {name}"] = row["launches"]
    fwd_by_path["dataset_creation"] = training["dataset_creation"]["launches"]["fwd"]
    for name, row in (("training", training["training"]),
                      ("training with remat", training["training"]["remat_after_restore"])):
        fwd_by_path[name], bwd_by_path[name] = row["launches"]["fwd"], row["launches"]["main"]
    fwd_by_path[f"run_sweep x{BATCH}, {ENTRY_STEPS} steps"] = entry["sweep"]["launches"]["fwd"]
    for r, row in enumerate(multi["sweep"]["per_rank"]):
        fwd_by_path[f"run_sweep_sharded rank {r} of {MP_RANKS}, x{BATCH}, {ENTRY_STEPS} steps"] = (
            row["launches"]["fwd"])
    for r, row in enumerate(multi["training"]["per_rank"]):
        name = (f"training rank {r} of {MP_RANKS} (ZeRO), {MP_STEPS} steps of "
                f"{MP_BATCH // MP_RANKS} rows x {MP_ACCUM}")
        fwd_by_path[name], bwd_by_path[name] = row["launches"]["fwd"], row["launches"]["main"]
    name = f"training, one-process reference: {MP_STEPS} steps of 8 rows x {MP_REF_ACCUM}"
    fwd_by_path[name] = multi["training"]["launches"]["fwd"]
    bwd_by_path[name] = multi["training"]["launches"]["main"]
    fwd_by_path[f"run_sweep --quant w8 x{BATCH}, {ENTRY_STEPS} steps"] = (
        w8["sweep"]["launches"]["fwd"])
    fwd_by_path[f"{W8_TIMED_STEPS} steps: directinversion+p2p, w8"] = (
        w8["x1"]["w8"]["launches"]["fwd"])
    for r, row in enumerate(tp["sweep_per_rank"]):
        fwd_by_path[f"run_sweep_sharded --tp {TP_RANKS}, rank {r}, x{TP_IMAGES}, "
                    f"{TP_STEPS} steps"] = row["launches"]["fwd"]
    for r, row in enumerate(tp["train"]["per_rank"]):
        name = f"training step split over tp = {TP_RANKS}, rank {r}, {TRAIN_BATCH} rows"
        fwd_by_path[name], bwd_by_path[name] = row["launches"]["fwd"], row["launches"]["main"]
    f32_by_path[f"run_editing_p2p, {ENTRY_RUNNER_IMAGES} images at {ENTRY_STEPS} steps"] = (
        entry["runner"]["launches"]["fwd"])
    fwd_by_path[f"{BLD_STEPS} steps: blended-latent-diffusion"] = bld["launches"]["fwd"]
    fwd_by_path[f"batched blended-latent-diffusion x{BATCH}"] = bld["batch_launches"]["fwd"]
    for steps, rows in ((P2Z_STEPS, pix2pix_zero), (SD_STEPS, stylediffusion)):
        for method, row in rows.items():
            if not isinstance(row, dict) or not ("launches" in row or "batch_launches" in row):
                continue
            batched = method.startswith("batched")
            counts = row["batch_launches" if batched else "launches"]
            name = f"{steps} steps: {method}" + (f" x{BATCH}" if batched else "")
            fwd_by_path[name], bwd_by_path[name] = counts["fwd"], counts["main"]
    for prefix, rows in ((f"{VARIANT_STEPS} steps: ", variants),
                         ("batched x2, 3 steps: ", batched_variants)):
        for method, row in rows.items():
            fwd_by_path[prefix + method] = row["launches"]["fwd"]
            if row["launches"]["main"]:
                bwd_by_path[prefix + method] = row["launches"]["main"]
    bwd_entries = _bwd_entries(bwd, nt_launches)
    for entry in bwd_entries:
        entry["launches_by_path"] = bwd_by_path
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "pnpinversion_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": f"{TPU_FLASH}:60",
        "launches": main_path["flash_launches_per_edit"],
        "launches_by_path": fwd_by_path,
        "max_abs_err": flash["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": head["shape"], "per_case": flash["rows"]},
        *bwd_entries, *_f32_entries(f32, f32_path, f32_by_path),
    ]}), flush=True)
    print("phase_seconds", json.dumps(PHASE_S), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
