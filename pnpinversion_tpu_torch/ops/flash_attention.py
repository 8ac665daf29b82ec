"""Flash-attention forward: the Hopper CUDA kernel, its plain PyTorch version
and the wrapper that picks between them by the tensors' device.

The kernel (``csrc/flash_attention_fwd.cu``) replaces the TPU kernel
``pnpinversion_tpu/ops/flash_attention.py::_flash_kernel``; its header says
what bounds it on an H100 and what the design does about that. Layout is the
JAX package's: q (B, H, Sq, D), k/v (B, H, Sk, D); the outputs are O in the
input dtype and the row log-sum-exp LSE (B, H, Sq) in f32.

On a CPU tensor the wrapper runs the plain version. On a CUDA tensor it
launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pnpinversion_tpu_torch.ops import build

KERNEL = "flash_attention_fwd"
MAX_HEAD_DIM = 128


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: f32 scores and softmax, probs cast to v's dtype for PV
    (the einsum path of the JAX package's ops/attention.py)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = scores.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(scores - m).sum(dim=-1, keepdim=True)))[..., 0]
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)
    return out.to(q.dtype), lse


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
        if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} needs a contiguous last dim, strides "
                             f"that are multiples of 8 and 16-byte alignment; got "
                             f"strides {x.stride()}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load(KERNEL).pnpi_flash_attention_fwd_bf16
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i64] * 12 + [i32] * 5 + [ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) of non-causal softmax attention. q/k/v may be strided views
    (e.g. heads split from a (B, S, H*D) tensor); O comes back as a (B, H, Sq,
    D) view of a (B, Sq, H, D) buffer, so merging heads afterwards is free."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
        b, h, sq, sk, d, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError {err} for q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """O only (the JAX package's ``flash_attention`` forward)."""
    return flash_attention_fwd(q, k, v, scale)[0]
