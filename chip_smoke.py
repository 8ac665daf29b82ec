"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (python3 chip_smoke.py).

Phases, each of which raises on failure (the script then exits non-zero):
1. the card's name and power limit, torch/CUDA versions, TF32 flags;
2. build every CUDA kernel of the port from the sources in this checkout (one
   nvcc per source, all started together), print ptxas' registers and
   spills per kernel, and fail on a spill or a wgmma that ptxas serialised;
3. hold each kernel against its plain PyTorch version at every shape the
   paths give it (and a few more), and time kernel, plain version and the
   PyTorch library call that computes the same function, with CUDA events
   around calls queued behind a spin kernel, so no host time is counted: the
   flash forward, then the backward's three kernels (prep, main, dQ
   convert) and the whole backward;
4. drive the first path: ``P2PEditor("directinversion+p2p", ...)`` on an
   SD1.4 pipeline at full width (random weights from a seed, bf16, 512², 50
   DDIM steps), a warm-up edit, a timed edit whose kernel launches are
   counted, and a per-phase timed edit whose latents are checked;
5. drive the second path: ``P2PEditor("null-text-inversion+p2p", ...)`` on
   the same pipeline: a warm-up edit at 2 DDIM steps, then one edit at 50
   whose launches of every kernel are counted and whose phases are
   timed to a synchronize each; the backward kernels run in its inner Adam
   loop, which differentiates through the UNet; then one counted
   ``ddim+p2p`` edit;
6. print one JSON line of kernel numbers, then the result line.

It imports nothing of JAX and nothing of the JAX package. Without CUDA it
exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
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
# a (B, S, H*D) tensor, as the UNet's attention sites make them. B: 3 rows in
# the fused DirectInversion scan, 1 in inversion and null-text's inner loop,
# 2 and 4 in the CFG reconstruction and edit of null-text+p2p and ddim+p2p
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
] + EDGE_CASES
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
] + EDGE_CASES
# relative to max |plain|: P and dS are rounded to bf16 before their products
# (as the TPU kernels round them) and dQ/dK/dV are stored in bf16
FLASH_BWD_RTOL = 2e-2
FLASH_DELTA_RTOL = 1e-3  # f32 sums over d on both sides, in another order


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
        m = re.search(r"Compiling entry function '\S*?(?<=\d)(flash_[a-z_]+?_kernel)"
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


def _bf16_heads(gen, b, h, s, d, strided) -> torch.Tensor:
    """Random bf16 (B, H, S, D) on the card; strided: heads split from a
    (B, S, H*D) tensor, as the UNet's attention sites make them."""
    if strided:
        x = torch.randn((b, s, h * d), generator=gen, device="cuda")
        return x.to(torch.bfloat16).view(b, s, h, d).transpose(1, 2)
    return torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)


def kernel_phase(timing: bool = True) -> dict:
    """Kernel vs plain version at every case; times at the timed cases (none
    with ``timing=False``). Each row names the forward's tile (query rows per
    CTA) and its dynamic shared memory."""
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, worst = [], 0.0
    for name, b, h, sq, sk, d, strided, timed in FLASH_CASES:
        timed = timed and timing
        def make(s):
            return _bf16_heads(gen, b, h, s, d, strided)

        q, k, v = make(sq), make(sk), make(sk)
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
    for name, b, h, sq, sk, d, strided, timed in FLASH_BWD_CASES:
        timed = timed and timing

        def make(s):
            return _bf16_heads(gen, b, h, s, d, strided)

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
NULL_TEXT_STEPS = 50  # DDIM steps of the counted null-text edit
NULL_TEXT_INNER = 10  # the reference's num_inner_steps, the editor's default


def _random_images(seed: int):
    rng = np.random.RandomState(seed)
    return lambda: (rng.rand(512, 512, 3) * 255).astype(np.uint8)


def _reset_counts() -> None:
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    for fn in (fa.flash_attention_fwd,) + fa.BWD_WRAPPERS:
        fn.launches = 0


def _counts() -> dict:
    from pnpinversion_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.flash_attention_fwd.launches,
            "prep": fa.flash_attention_bwd_prep.launches,
            "main": fa.flash_attention_bwd_main.launches,
            "convert": fa.flash_attention_bwd_dq_convert.launches}


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


BWD_SOURCE = "pnpinversion_tpu_torch/csrc/flash_attention_bwd.cu"
TPU_FLASH = "pnpinversion_tpu/ops/flash_attention.py"


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pnpinversion_tpu_torch.configs import SD14
    from pnpinversion_tpu_torch.ops import build
    from pnpinversion_tpu_torch.ops.flash_attention import BWD_KERNEL, KERNEL
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    print(card_line(), flush=True)  # name, power limit: as nvidia-smi prints them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    build_s = build.build([KERNEL, BWD_KERNEL])
    print(f"build: {json.dumps(build_s)} total {time.perf_counter() - t0:.1f}s", flush=True)
    for name in (KERNEL, BWD_KERNEL):
        summary = ptxas_summary(build.build_log(name))
        print(f"ptxas {name}.cu:", *summary, sep="\n  ", flush=True)
        lost = [line for line in summary if re.search(
            r"Performance Loss|stack frame [1-9]|spill stores [1-9]|spill loads [1-9]|warning",
            line, re.IGNORECASE)]
        if lost:
            raise AssertionError(f"ptxas: spills or serialised wgmma in {name}.cu: {lost}")

    flash = kernel_phase()
    bwd = bwd_kernel_phase()
    pipe, t_create = _sync_time(lambda: SDPipeline.create(SD14, seed=0, num_ddim_steps=50))
    assert pipe.device.type == "cuda" and pipe.dtype == torch.bfloat16
    main_path = main_path_phase(pipe)
    print("main_path", json.dumps({"create_s": t_create, **main_path}), flush=True)
    null_text = null_text_phase(pipe)
    print("null_text_path", json.dumps(null_text), flush=True)
    ddim = ddim_phase(pipe)
    print("ddim_path", json.dumps(ddim), flush=True)

    head = next(r for r in flash["rows"] if r["case"] == "scan_64x64")
    nt_launches = null_text["launches"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "pnpinversion_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": f"{TPU_FLASH}:60",
        "launches": main_path["flash_launches_per_edit"],
        "launches_by_path": {"directinversion+p2p": main_path["flash_launches_per_edit"],
                             NULL_TEXT: nt_launches["fwd"],
                             "ddim+p2p": ddim["launches"]["fwd"]},
        "max_abs_err": flash["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": head["shape"], "per_case": flash["rows"]},
        *_bwd_entries(bwd, nt_launches),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
