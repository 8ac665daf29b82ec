"""The main path's edit, its FLOPs and the device time it runs in: the
port's counterpart of the JAX package's ``scripts/mfu.py`` (the workload and
MFU) and ``scripts/_xprof.py`` (device time from a trace). The FLOPs are
``utils/flops.py``'s; ``scripts/mfu_torch.py`` and ``chip_smoke.py``'s
``mfu_phase`` print what this module measures.

Nothing here launches a kernel or needs a card, except ``trace_device``.
"""
from __future__ import annotations

import dataclasses
import re
import subprocess
import time
from typing import Callable, FrozenSet, Tuple

import numpy as np
import torch

from pnpinversion_tpu_torch.utils.flops import FlopCount, FlopCounter

H100_BF16_PEAK = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM at 700 W (NVIDIA's data sheet)

# the main path's edit: bench.py's workload, the cake prompts
MAIN_PATH_PROMPTS = ("a round cake with orange frosting on a wooden plate",
                     "a square cake with orange frosting on a wooden plate")
MAIN_PATH_KW = dict(guidance_scale=7.5, blend_word=(("cake",), ("cake",)),
                    eq_params={"words": ("square",), "values": (2.0,)})


@dataclasses.dataclass(frozen=True)
class EditFlops:
    """The FLOPs of one ``directinversion+p2p`` edit of ``images`` images at
    ``steps`` DDIM steps, from the calls one count made: ``fixed`` is the
    work that does not depend on the steps (VAE encode and decode, the text
    tower where the call embeds its prompts), ``inversion_call`` one UNet
    call of the inversion loop, ``scan_call`` / ``scan_window_call`` one call
    of the fused offsets+edit scan outside / inside P2P's self-attention
    replace window (inside it the source row's probabilities are also
    applied to the edited rows), ``window_steps`` how many of the steps fall
    in that window, ``attention_shapes`` the (kind, B, H, Sq, Sk, d) the
    flash kernel was entered at."""

    steps: int
    images: int
    window_steps: int
    fixed: FlopCount
    inversion_call: FlopCount
    scan_call: FlopCount
    scan_window_call: FlopCount
    attention_shapes: FrozenSet[tuple]

    @property
    def total(self) -> FlopCount:
        return (self.fixed + self.steps * self.inversion_call
                + (self.steps - self.window_steps) * self.scan_call
                + self.window_steps * self.scan_window_call)

    @property
    def per_image(self) -> FlopCount:
        return self.total * (1.0 / self.images)


def at_steps(pipe, steps: int):
    """The pipeline with a DDIM schedule of ``steps`` steps."""
    from pnpinversion_tpu_torch.schedulers.ddim import make_ddim_schedule

    return dataclasses.replace(pipe, schedule=make_ddim_schedule(steps))


def main_path_edit(pipe, images: int = 1) -> Callable:
    """A callable that runs the main path's edit once on the pipeline: the
    single-image editor's ``__call__`` (which embeds its prompts) for one
    image, ``BatchedDirectInversionP2P.edit_batch`` (prompts embedded before,
    as the sweep embeds them) for more. The images are random from seed 0:
    neither the count nor the kernels' work depends on them."""
    from pnpinversion_tpu_torch.control.p2p import stack_tensors
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.parallel.sweep import BatchedDirectInversionP2P

    prompts, edit_kw = MAIN_PATH_PROMPTS, MAIN_PATH_KW
    size = pipe.config.image_size
    imgs = (np.random.RandomState(0).rand(images, size, size, 3) * 255).astype(np.uint8)
    editor = P2PEditor(pipe)
    if images == 1:
        return lambda: editor("directinversion+p2p", imgs[0], *prompts, **edit_kw)
    kw = {k: v for k, v in edit_kw.items() if k != "guidance_scale"}
    spec, tensors = editor.make_control(list(prompts), **kw)
    cond = pipe.encode_prompt(list(prompts))[None].expand(images, -1, -1, -1)
    uncond = pipe.encode_prompt(["", ""])
    tensors = stack_tensors([tensors] * images)
    sweep = BatchedDirectInversionP2P(pipe)
    return lambda: sweep.edit_batch(spec, imgs, cond, uncond, edit_kw["guidance_scale"], tensors)


def _unet_calls(unet, counter: FlopCounter, calls: list):
    """Hooks on ``unet`` that append (control, step, FlopCount of the call)
    for every call, as ``counter`` counts it; returns the handles."""
    from pnpinversion_tpu_torch.control.base import NO_CONTROL

    def pre(module, args, kwargs):
        control = args[3] if len(args) > 3 else kwargs.get("control", NO_CONTROL)
        step = args[6] if len(args) > 6 else kwargs.get("step")
        module._flops_call = (control, step, counter.count)

    def post(module, args, kwargs, out):
        control, step, before = module._flops_call
        calls.append((control, step, counter.count - before))

    return [unet.register_forward_pre_hook(pre, with_kwargs=True),
            unet.register_forward_hook(post, with_kwargs=True)]


def edit_flops(pipe, steps: int = None, images: int = 1, count_steps: int = 2) -> EditFlops:
    """The FLOPs of one main-path edit (``directinversion+p2p``, the cake
    edit) of ``images`` images at ``steps`` DDIM steps (the pipeline's by
    default). The edit runs once, at ``count_steps``, under a counter that
    also takes each UNet call apart; shapes never depend on the steps, so
    the count extends to ``steps`` by the code's own calls: one inversion
    call and one scan call a step, the scan call inside the self-replace
    window on the steps the spec at ``steps`` puts there. Raises if two
    calls of one kind counted differently. ``count_steps`` must put at least
    one scan step inside the window and one outside (2 does for the default
    window, the first 60% of the steps)."""
    from pnpinversion_tpu_torch.control.p2p import P2PControl
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor

    steps = pipe.schedule.num_steps if steps is None else steps
    run = main_path_edit(at_steps(pipe, count_steps), images)
    calls = []
    fc = FlopCounter()
    handles = _unet_calls(pipe.unet, fc, calls)
    try:
        with fc:
            run()
    finally:
        for h in handles:
            h.remove()
    kinds = {"inversion": [], "scan": [], "scan_window": []}
    for control, step, flops in calls:
        if not isinstance(control, P2PControl):
            kinds["inversion"].append(flops)
        else:
            s = control.spec
            kinds["scan_window" if s.self_replace_start <= step < s.self_replace_end
                  else "scan"].append(flops)
    if len(kinds["inversion"]) != count_steps or len(kinds["scan"]) + len(
            kinds["scan_window"]) != count_steps:
        raise AssertionError(f"{len(calls)} UNet calls at {count_steps} steps: "
                             f"{ {k: len(v) for k, v in kinds.items()} }")
    for kind, counts in kinds.items():
        if not counts:
            raise ValueError(f"count_steps={count_steps} runs no {kind} call")
        if any(c != counts[0] for c in counts):
            raise AssertionError(f"the {kind} calls counted differently: {counts}")
    unet_sum = FlopCount()
    for _, _, flops in calls:
        unet_sum = unet_sum + flops
    kw = {k: v for k, v in MAIN_PATH_KW.items() if k != "guidance_scale"}
    spec, _ = P2PEditor(at_steps(pipe, steps)).make_control(list(MAIN_PATH_PROMPTS), **kw)
    window = max(0, min(spec.self_replace_end, steps) - spec.self_replace_start)
    return EditFlops(steps=steps, images=images, window_steps=window,
                     fixed=fc.count - unet_sum, inversion_call=kinds["inversion"][0],
                     scan_call=kinds["scan"][0], scan_window_call=kinds["scan_window"][0],
                     attention_shapes=frozenset(fc.attention_shapes))


# ---------------------------------------------------------------------------
# device time from a trace
# ---------------------------------------------------------------------------

# kernels that run on the tensor cores, by name: cuBLAS's GEMMs (sm90_xmma,
# nvjet, cutlass, ampere/sm80 ...gemm), cuDNN's convolutions (implicit-GEMM
# fprop, dgrad, wgrad) and the port's flash kernels (their main kernels: the
# backward's prep and dQ convert are elementwise); less the GEMMs that run
# on the CUDA cores (FP32 FMA: "ffma", sgemm, gemv), such as the f32
# products of the attention sites whose probabilities are materialised
TENSOR_CORE_KERNEL = re.compile(
    r"gemm|xmma|nvjet|cutlass|wgmma|tensorop|s16816|s1688|fprop|dgrad|wgrad"
    r"|flash_(fwd|bwd)(_f32)?_kernel|flash_bwd_(dq|dkv)_f32_kernel",
    re.IGNORECASE)
CUDA_CORE_KERNEL = re.compile(r"ffma|sgemm|gemv", re.IGNORECASE)
# the other kernels by name, first match: GEMMs on the CUDA cores, softmax,
# PyTorch's elementwise kernels (copies, casts, adds, multiplies,
# activations), its reductions and norms; what none names is "other"
KERNEL_CATEGORIES = (("cuda_core_gemm", CUDA_CORE_KERNEL),
                     ("softmax", re.compile(r"softmax", re.IGNORECASE)),
                     ("elementwise", re.compile(r"elementwise", re.IGNORECASE)),
                     ("reduction_or_norm", re.compile(r"reduce|moments|norm", re.IGNORECASE)))


def is_tensor_core(name: str) -> bool:
    return bool(TENSOR_CORE_KERNEL.search(name)) and not CUDA_CORE_KERNEL.search(name)


def kernel_category(name: str) -> str:
    """"tensor_core" (``is_tensor_core``), else the first of
    ``KERNEL_CATEGORIES`` the name matches, else "other"."""
    if is_tensor_core(name):
        return "tensor_core"
    return next((cat for cat, pattern in KERNEL_CATEGORIES if pattern.search(name)), "other")


def _union_us(intervals) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def kernel_spans(prof) -> list:
    """(name, start µs, end µs) of every device activity in a finished
    torch.profiler trace, read from its raw results (``prof.events()`` builds
    a Python object per event, slow at the ~10⁵ kernels of an edit)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() * 1e-3, (e.start_ns() + e.duration_ns()) * 1e-3)
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def device_activity(spans) -> dict:
    """From the (name, start µs, end µs) of a traced window's device
    activity: ``busy_us`` (the union of the kernels' intervals; copies and
    memsets left out), ``tensor_core_us`` (the union of those whose name
    says tensor cores: ``is_tensor_core``), ``kernels`` (launches),
    ``by_name`` ({name: [us, launches, category]}) and ``by_category``
    ({``kernel_category``: us}, the kernels' summed durations)."""
    busy, tc_spans, by_name = [], [], {}
    for name, start, end in spans:
        row = by_name.get(name)
        if row is None:  # classify each name once: an edit has ~10⁵ kernels, ~10² names
            if name.startswith(("Memcpy", "Memset")):
                continue
            row = by_name[name] = [0.0, 0, kernel_category(name)]
        busy.append((start, end))
        if row[2] == "tensor_core":
            tc_spans.append((start, end))
        row[0] += end - start
        row[1] += 1
    by_category = {}
    for us, _, cat in by_name.values():
        by_category[cat] = by_category.get(cat, 0.0) + us
    return {"busy_us": _union_us(busy), "tensor_core_us": _union_us(tc_spans),
            "kernels": len(busy), "by_name": by_name, "by_category": by_category}


def sync_time(fn: Callable) -> Tuple[object, float]:
    """(fn(), its seconds on the host's clock from a ``torch.cuda.synchronize()``
    before to one after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def trace_device(fn: Callable) -> Tuple[float, dict]:
    """Runs ``fn`` once under torch.profiler (device activity) and returns
    (its wall seconds under the profiler, to a synchronize; its
    ``device_activity``). Raises when the trace holds no kernel: no device
    time, no MFU."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    activity = device_activity(kernel_spans(prof))
    if not activity["kernels"]:
        raise RuntimeError("torch.profiler recorded no device kernel: no device time to divide by")
    return wall, activity


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def mfu(flops: float, seconds: float) -> float:
    """The share of the bf16 dense peak that ``flops`` in ``seconds`` reach."""
    return flops / seconds / H100_BF16_PEAK


def mfu_report(flops: float, images: int, wall_s: float, traced_wall_s: float,
               activity: dict) -> dict:
    """The figures of one measured call of ``images`` images that does
    ``flops``: FLOPs and warm seconds per image (``wall_s``: the call
    untraced, host clock to a synchronize), the device's busy and
    tensor-core seconds from a trace of the same call (``activity``:
    ``device_activity``), its seconds by kind of kernel, the idle share
    (1 - busy / wall), MFU over the wall, the busy and the tensor-core time,
    and the twelve kernels that took the most device time (of all, and of
    those counted as tensor-core work)."""
    busy, tc = activity["busy_us"] * 1e-6, activity["tensor_core_us"] * 1e-6
    ranked = sorted(activity["by_name"].items(), key=lambda kv: -kv[1][0])

    def rows(items):
        return [{"name": name[:120], "ms": us * 1e-3, "launches": n, "category": cat}
                for name, (us, n, cat) in items[:12]]
    return {"flops_per_image": flops / images, "s_per_image": wall_s / images,
            "wall_s": wall_s, "traced_wall_s": traced_wall_s, "device_busy_s": busy,
            "tensor_core_s": tc, "idle_share": 1.0 - busy / wall_s,
            "kernels": activity["kernels"], "mfu_wall": mfu(flops, wall_s),
            "mfu_device_busy": mfu(flops, busy), "mfu_tensor_core": mfu(flops, tc) if tc else None,
            "device_s_by_category": {cat: us * 1e-6 for cat, us in sorted(
                activity["by_category"].items(), key=lambda kv: -kv[1])},
            "kernel_names": len(ranked),
            "tensor_core_names": sum(1 for _, row in ranked if row[2] == "tensor_core"),
            "top_kernels": rows(ranked),
            "top_tensor_core_kernels": rows([kv for kv in ranked if kv[1][2] == "tensor_core"])}
