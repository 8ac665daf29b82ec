"""Flash attention, forward and backward: the Hopper CUDA kernels, their
plain PyTorch versions, the wrappers that pick between them by the tensors'
device, and the ``FlashAttention`` autograd Function that joins them.

The kernels replace the TPU kernels of ``pnpinversion_tpu/ops/flash_attention.py``:
``csrc/flash_attention_fwd.cu`` replaces ``_flash_kernel``, and
``csrc/flash_attention_bwd.cu`` replaces ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``; each header says what bounds it on an H100 and what
the design does about that. Layout is the JAX package's: q (B, H, Sq, D),
k/v (B, H, Sk, D); the forward returns O in the input dtype and the row
log-sum-exp LSE (B, H, Sq) in f32, which the backward reads.

On a CPU tensor a wrapper runs the plain version. On a CUDA tensor it
launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pnpinversion_tpu_torch.ops import build

KERNEL = "flash_attention_fwd"
BWD_KERNEL = "flash_attention_bwd"
MAX_HEAD_DIM = 128


def _acc(x: torch.Tensor) -> torch.dtype:
    """f32 for bf16/f32 inputs, f64 for f64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: f32 scores and softmax, probs cast to v's dtype for PV
    (the einsum path of the JAX package's ops/attention.py)."""
    acc = _acc(q)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    m = scores.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(scores - m).sum(dim=-1, keepdim=True)))[..., 0]
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)
    return out.to(q.dtype), lse


def _probs_and_ds(q, k, v, lse, do, delta, scale):
    """P = exp(scale QK^T - LSE) and dS = P (dO V^T - delta), full S x S, f32."""
    acc = _acc(q)
    p = torch.exp(torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
                  - lse.to(acc)[..., None])
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    return p, p * (dp - delta.to(acc)[..., None])


def flash_attention_bwd_dq_reference(q, k, v, out, lse, do, scale):
    """Plain version of the dq kernel: (dQ, delta = rowsum(dO * O))."""
    acc = _acc(q)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1)
    _, ds = _probs_and_ds(q, k, v, lse, do, delta, scale)
    return (torch.matmul(ds, k.to(acc)) * scale).to(q.dtype), delta


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale):
    """Plain version of the dkv kernel: (dK, dV)."""
    acc = _acc(q)
    p, ds = _probs_and_ds(q, k, v, lse, do, delta, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    dv = torch.matmul(p.transpose(-1, -2), do.to(acc))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, do, scale):
    """Plain backward (the JAX package's ``_flash_bwd_rule``): (dQ, dK, dV)."""
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, out, lse, do, scale)
    return (dq,) + flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)


def _takes_strides(x: torch.Tensor) -> bool:
    return x.stride(3) == 1 and not any(s % 8 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0


def _check_strided(name: str, x: torch.Tensor) -> None:
    if not _takes_strides(x):
        raise ValueError(f"flash kernel: {name} needs a contiguous last dim, strides "
                         f"that are multiples of 8 and 16-byte alignment; got "
                         f"strides {x.stride()}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash kernel: q/k/v must share one CUDA device, got "
                         f"{q.device}/{k.device}/{v.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash kernel takes bf16 only, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash kernel: q (B,H,Sq,D), k/v (B,H,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"flash kernel: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if sq == 0 or k.shape[2] == 0:
        raise ValueError("flash kernel: empty sequence")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"flash kernel: head dim {d} must be a multiple of 8 and <= 128")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_strided(name, x)


def _heads_last(b: int, h: int, s: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """A (B, H, S, D) view of a fresh (B, S, H, D) buffer, so merging heads
    afterwards (or the backward of splitting them) copies nothing."""
    return torch.empty((b, s, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load(KERNEL).pnpi_flash_attention_fwd_bf16
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i64] * 12 + [i32] * 6 + [ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def fwd_smem_bytes(tile_rows: int, d: int) -> int:
    """Dynamic shared memory of the forward kernel's instantiation for
    (tile_rows, d), as the C side computes it."""
    return build.load(KERNEL).pnpi_flash_attention_fwd_smem_bytes(tile_rows, d)


def fwd_tile_rows(bh: int, sq: int, sms: int) -> int:
    """Query rows per CTA of the forward kernel: 128 (two consumer warpgroups)
    or 64 (one). Each consumer warpgroup walks all keys for its 64 rows, so a
    wave of CTAs takes about as long with either tile: pick the one that
    needs fewer waves over ``sms`` SMs at one CTA per SM, then the one that
    keeps more SMs busy, then 128 (K/V loaded once for twice the rows). One
    CTA per SM even where two 64-row CTAs would fit (d <= 64): on the H100 two
    of them were slower than one 128-row CTA at every 64x64 site (1.1x)."""
    def cost(rows: int):
        ctas = -(-sq // rows) * bh
        return -(-ctas // sms), -min(ctas, sms)

    return 64 if cost(64) < cost(128) else 128


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _no_broadcast(x: torch.Tensor) -> torch.Tensor:
    """A copy of an expanded input (a stride 0 over a dim longer than 1),
    which a TMA tensor map cannot describe; other inputs as they are."""
    if 0 in x.stride() and any(st == 0 and n > 1 for st, n in zip(x.stride(), x.shape)):
        return x.contiguous()
    return x


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    lib = build.load(BWD_KERNEL)
    fns = lib.pnpi_flash_attention_bwd_dq_bf16, lib.pnpi_flash_attention_bwd_dkv_bf16
    for fn in fns:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _no_grad_tracking(name: str, *xs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(f"{name} records no autograd graph: call flash_attention "
                           "(FlashAttention.apply) on inputs that require grad")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) of non-causal softmax attention. q/k/v may be strided views
    (e.g. heads split from a (B, S, H*D) tensor); O comes back as a (B, H, Sq,
    D) view of a (B, Sq, H, D) buffer, so merging heads afterwards is free.
    Raises on inputs that require grad while grad mode is on: only
    ``FlashAttention`` may call it then."""
    _no_grad_tracking("flash_attention_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check(q, k, v)
    b, h, sq, d = q.shape
    out, lse = _launch_fwd(q, k, v, scale, fwd_tile_rows(b * h, sq, _sm_count(q.device.index)))
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel with ``rows`` query rows per CTA, on
    inputs ``_check`` has passed."""
    q, k, v = _no_broadcast(q), _no_broadcast(k), _no_broadcast(v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = _heads_last(b, h, sq, d, q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
        b, h, sq, sk, d, rows, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError {err} for q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}")
    return out, lse


def _launch_bwd(fn, name: str, tensors: dict, q: torch.Tensor, sk: int, scale: float) -> None:
    """One backward kernel through its C entry: ``tensors`` maps the C
    interface's slot names to tensors (absent slots are null)."""
    order = ("q", "k", "v", "o", "do", "dq", "dk", "dv")
    ptrs = (ctypes.c_void_p * 10)(*[
        tensors[n].data_ptr() if n in tensors else None for n in order + ("lse", "delta")])
    strides = (ctypes.c_int64 * 24)(*[
        s for n in order for s in (tensors[n].stride()[:3] if n in tensors else (0, 0, 0))])
    b, h, sq, d = q.shape
    err = fn(ptrs, strides, b, h, sq, sk, d, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash {name} kernel launch failed: cudaError {err} for q "
                           f"{tuple(q.shape)}, sk {sk}")


def _check_bwd(q, k, v, lse, do, others) -> None:
    _check(q, k, v)
    for name, x in others:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash backward: {name} {tuple(x.shape)} {x.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
        _check_strided(name, x)
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash backward: lse must be contiguous f32 {tuple(q.shape[:3])}, "
                         f"got {tuple(lse.shape)} {lse.dtype}")


def flash_attention_bwd_dq(q, k, v, out, lse, do, scale):
    """(dQ, delta): the dq kernel (B2), which also writes delta = rowsum(dO*O)
    (B, H, Sq) f32 for the dkv kernel. dQ is a (B, H, Sq, D) view of a
    (B, Sq, H, D) buffer."""
    _no_grad_tracking("flash_attention_bwd_dq", q, k, v, out, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, out, lse, do, scale)
    _check_bwd(q, k, v, lse, do, (("out", out), ("do", do)))
    dq = _heads_last(*q.shape, q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch_bwd(_bwd_kernels()[0], "dq", dict(q=q, k=k, v=v, o=out, do=do, dq=dq, lse=lse,
                                              delta=delta), q, k.shape[2], scale)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale):
    """(dK, dV): the dkv kernel (B3), each a (B, H, Sk, D) view of a
    (B, Sk, H, D) buffer."""
    _no_grad_tracking("flash_attention_bwd_dkv", q, k, v, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    _check_bwd(q, k, v, lse, do, (("do", do),))
    if delta.shape != lse.shape or delta.dtype != torch.float32 or not delta.is_contiguous():
        raise ValueError(f"flash backward: delta must be contiguous f32 {tuple(lse.shape)}")
    dk, dv = _heads_last(*k.shape, k), _heads_last(*v.shape, v)
    _launch_bwd(_bwd_kernels()[1], "dkv", dict(q=q, k=k, v=v, do=do, dk=dk, dv=dv, lse=lse,
                                               delta=delta), q, k.shape[2], scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, scale):
    """(dQ, dK, dV) of ``flash_attention_fwd``: the dq kernel, then the dkv
    kernel. A dO whose strides the kernels do not take (e.g. an expanded
    gradient) is made contiguous first: a copy, not a fallback."""
    if do.is_cuda and not _takes_strides(do):
        do = do.contiguous()
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, scale)
    return (dq,) + flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)


class FlashAttention(torch.autograd.Function):
    """O = softmax(scale q k^T) v, differentiable in q, k and v: the forward
    kernel saves (q, k, v, O, LSE) and the backward runs the dq and dkv
    kernels (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, lse, do, ctx.scale) + (None,)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """O only (the JAX package's ``flash_attention``), differentiable."""
    return FlashAttention.apply(q, k, v, scale)
