"""Flash attention, forward and backward: the Hopper CUDA kernels, their
plain PyTorch versions, the wrappers that pick between them by the tensors'
device, and the ``FlashAttention`` autograd Function that joins them.

The kernels replace the TPU kernels of ``pnpinversion_tpu/ops/flash_attention.py``,
which run in the inputs' storage dtype, bf16 or f32. For bf16,
``csrc/flash_attention_fwd.cu`` replaces ``_flash_kernel``, and
``csrc/flash_attention_bwd.cu`` replaces ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` with one pass over the scores (a prep kernel, the
main kernel, a dQ convert kernel). For f32, ``csrc/flash_attention_fwd_f32.cu``
replaces ``_flash_kernel`` (a split pass that writes the hi and lo TF32
halves of K and V^T, and a 3xTF32 wgmma kernel), and
``csrc/flash_attention_bwd_f32.cu`` replaces the two backward kernels one for
one (a dQ and a dK/dV kernel, 3xTF32 wgmma, each fed by its own split pass).
Each header says what bounds it on an H100 and what the design does about
that.
Layout is the JAX package's: q (B, H, Sq, D), k/v (B, H, Sk, D); the forward
returns O in the input dtype and the row log-sum-exp LSE (B, H, Sq) in f32,
which the backward reads.

On a CPU tensor a wrapper runs the plain version. On a CUDA tensor it
launches the kernel of the tensors' dtype (bf16 or f32) or raises: there is
no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math
import types
from typing import Tuple

import torch

from pnpinversion_tpu_torch.ops import build

KERNEL = "flash_attention_fwd"
BWD_KERNEL = "flash_attention_bwd"
F32_FWD_KERNEL = "flash_attention_fwd_f32"
F32_BWD_KERNEL = "flash_attention_bwd_f32"
# the order of the positions in each group of 8 of a transposed tile of the
# f32 kernels (V^T in the forward; K^T, Q^T and dO^T in the backward): slot s
# holds position F32_KEY_PERM[s], so that an accumulator's registers (columns
# 2t and 2t + 1 of a thread: P, dS, P^T, dS^T) are the TF32 A fragment (slots
# t and t + 4) as they stand
F32_KEY_PERM = (0, 2, 4, 6, 1, 3, 5, 7)
# the f32 forward's 128-row tiles (two consumer warpgroups and a producer
# warp: 168 registers a thread) exist up to this head dim; past it ptxas
# spills (d = 64) or the Q tile and two stages outgrow shared memory (d = 80)
F32_WIDE_TILE_MAX_D = 56
# the f32 backward's 128-row tiles (two consumer warpgroups sharing each stage
# of the other side's tiles: 168 registers a thread) exist up to these head
# dims; past them dK/dV spills (d = 56) or dQ's rows and two stages outgrow
# shared memory (d = 48)
F32_BWD_WIDE_TILE_MAX_D = {"dq": 40, "dkv": 48}
MAX_HEAD_DIM = 128
BWD_BLOCK_Q = 64  # query rows per tile of the backward's stats and dQ accumulator
LOG2E = math.log2(math.e)


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


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 ``x``: hi is x rounded to TF32 (to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``) with its low 13 mantissa bits zero, and
    lo = x - hi, exact in f32. hi * y_hi + hi * y_lo + lo * y_hi is the 3xTF32
    product, which drops only lo * y_lo (about 2^-22 of |x y|)."""
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def _probs_and_ds(q, k, v, lse, do, delta, scale):
    """P = exp(scale QK^T - LSE) and dS = P (dO V^T - delta), full S x S, f32."""
    acc = _acc(q)
    p = torch.exp(torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
                  - lse.to(acc)[..., None])
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    return p, p * (dp - delta.to(acc)[..., None])


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale):
    """Plain dQ from the forward's LSE and delta = rowsum(dO * O): the dQ
    half of the plain backward."""
    _, ds = _probs_and_ds(q, k, v, lse, do, delta, scale)
    return (torch.matmul(ds, k.to(_acc(q))) * scale).to(q.dtype)


def _dk_dv(q, k, v, do, p, ds, scale):
    acc = _acc(q)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    dv = torch.matmul(p.transpose(-1, -2), do.to(acc))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale):
    """Plain (dK, dV) from the forward's LSE and delta: the other half."""
    return _dk_dv(q, k, v, do, *_probs_and_ds(q, k, v, lse, do, delta, scale), scale)


def flash_attention_bwd_reference(q, k, v, out, lse, do, scale):
    """Plain backward (the JAX package's ``_flash_bwd_rule``): (dQ, dK, dV)."""
    acc = _acc(q)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1)
    return ((flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale),)
            + flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale))


def _tiles(sq: int) -> int:
    return -(-sq // BWD_BLOCK_Q)


def flash_attention_bwd_prep_reference(out, lse, do):
    """Plain version of the prep kernel: (stats, dq_acc). stats is
    (B*H, n_q, 2, 64): LSE * log2(e) and delta = rowsum(dO * O) of each 64-row
    query tile, 0 past Sq; dq_acc is the zeroed (B*H, 64 * n_q, D) dQ
    accumulator."""
    acc = _acc(out)
    b, h, sq, d = out.shape
    n = _tiles(sq)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1)
    rows = torch.stack((lse.to(acc) * LOG2E, delta), dim=2).reshape(b * h, 2, sq)
    stats = torch.nn.functional.pad(rows, (0, n * BWD_BLOCK_Q - sq))
    stats = stats.reshape(b * h, 2, n, BWD_BLOCK_Q).transpose(1, 2).contiguous()
    return stats, torch.zeros((b * h, n * BWD_BLOCK_Q, d), dtype=acc, device=out.device)


def bwd_stats_rows(stats: torch.Tensor, sq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LSE * log2(e), delta), each (B*H, Sq), from a stats buffer."""
    rows = stats.transpose(1, 2).reshape(stats.shape[0], 2, -1)[..., :sq]
    return rows[:, 0], rows[:, 1]


def flash_attention_bwd_main_reference(q, k, v, do, stats, dq_acc, scale):
    """Plain version of the main kernel: (dK, dV); dS K (unscaled) is added
    into dq_acc's first Sq rows."""
    b, h, sq, d = q.shape
    lse2, delta = (x.reshape(b, h, sq) for x in bwd_stats_rows(stats, sq))
    p, ds = _probs_and_ds(q, k, v, lse2 / LOG2E, do, delta, scale)
    dq_acc[:, :sq] += torch.matmul(ds, k.to(_acc(q))).reshape(b * h, sq, d).to(dq_acc.dtype)
    return _dk_dv(q, k, v, do, p, ds, scale)


def flash_attention_bwd_dq_convert_reference(dq_acc, q, scale):
    """Plain version of the dQ convert kernel: scale * dq_acc in q's layout
    and dtype."""
    b, h, sq, d = q.shape
    return (dq_acc[:, :sq] * scale).reshape(b, h, sq, d).to(q.dtype)


def _takes_strides(x: torch.Tensor) -> bool:
    return x.stride(3) == 1 and not any(s % 8 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0


def _check_strided(name: str, x: torch.Tensor) -> None:
    if not _takes_strides(x):
        raise ValueError(f"flash kernel: {name} needs a contiguous last dim, strides "
                         f"that are multiples of 8 and 16-byte alignment; got "
                         f"strides {x.stride()}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16) -> None:
    """Raises unless q/k/v are ``dtype`` tensors of one CUDA device in shapes
    and strides the kernels take. The dtype first: the wrappers route f32 to
    the f32 kernels and everything else here, so any dtype but those two
    raises ``TypeError``."""
    if not (q.dtype == k.dtype == v.dtype == dtype):
        raise TypeError(f"flash kernels take bf16 or f32 (q, k and v alike); this one takes "
                        f"{dtype}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash kernel: q/k/v must share one CUDA device, got "
                         f"{q.device}/{k.device}/{v.device}")
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


def _tile_by_waves(bh: int, s: int, sms: int) -> int:
    """64 or 128 rows of one sequence per CTA: the tile that needs fewer
    waves over ``sms`` SMs at one CTA per SM, then the one that keeps more
    SMs busy, then 128."""
    def cost(rows: int):
        ctas = -(-s // rows) * bh
        return -(-ctas // sms), -min(ctas, sms)

    return 64 if cost(64) < cost(128) else 128


def fwd_tile_rows(bh: int, sq: int, sms: int) -> int:
    """Query rows per CTA of the forward kernel: 128 (two consumer warpgroups)
    or 64 (one). Each consumer warpgroup walks all keys for its 64 rows, so a
    wave of CTAs takes about as long with either tile: ``_tile_by_waves``
    (128 also loads K/V once for twice the rows). One CTA per SM even where
    two 64-row CTAs would fit (d <= 64): on the H100 two of them were slower
    than one 128-row CTA at every 64x64 site (1.1x)."""
    return _tile_by_waves(bh, sq, sms)


def fwd_f32_tile_keys(d: int) -> int:
    """Keys per shared-memory stage of the f32 forward: 64, or 32 past d = 88,
    where two stages of 64 keys (K and V^T, hi and lo) and one 64-row Q tile
    (hi and lo) would not fit in 227 KB. A function of d alone: the tile
    bounds the order of a row's sums, so a row's result must not depend on
    the batch or the rows per CTA."""
    return 64 if d <= 88 else 32


def fwd_f32_tile_rows(bh: int, sq: int, d: int, sms: int) -> int:
    """Query rows per CTA of the f32 forward: 128 (two consumer warpgroups
    sharing each K/V stage, so each stage is loaded once for twice the rows)
    or 64, by waves as ``fwd_tile_rows``; 64 past ``F32_WIDE_TILE_MAX_D``."""
    return 64 if d > F32_WIDE_TILE_MAX_D else _tile_by_waves(bh, sq, sms)


def bwd_f32_tile_keys(d: int) -> int:
    """Keys per shared-memory stage of the f32 dQ kernel: 64, 32 past d = 56,
    16 past d = 88, so that two stages (K and V hi/lo, K^T hi/lo) and the
    64-row Q and dO tiles (hi/lo) fit in 227 KB. A function of d alone, as
    ``fwd_f32_tile_keys``: the tile bounds the order of a row's sums."""
    return 64 if d <= 56 else 32 if d <= 88 else 16


def bwd_f32_tile_queries(d: int) -> int:
    """Queries per shared-memory stage of the f32 dK/dV kernel: 32, 16 past
    d = 72, 8 past d = 112, so that two stages (Q, dO, Q^T, dO^T hi/lo, LSE
    and delta) and the 64-key K and V tiles (hi/lo) fit in 227 KB. A
    function of d alone."""
    return 32 if d <= 72 else 16 if d <= 112 else 8


def bwd_f32_tile_rows(kernel: str, bh: int, s: int, d: int, sms: int) -> int:
    """Rows per CTA of the f32 backward's ``kernel`` ("dq": queries, "dkv":
    keys; ``s`` their length): 128 (two consumer warpgroups sharing each
    stage) or 64, by waves as ``fwd_tile_rows``; 64 past
    ``F32_BWD_WIDE_TILE_MAX_D``."""
    return 64 if d > F32_BWD_WIDE_TILE_MAX_D[kernel] else _tile_by_waves(bh, s, sms)


def bwd_tile_keys(bh: int, sk: int, sms: int) -> int:
    """Keys per CTA of the backward's main kernel: 128 (two consumer
    warpgroups of 64 keys sharing each Q/dO tile and adding one dQ partial
    per tile) or 64 (one). Each warpgroup walks all query tiles for its 64
    keys, so as in the forward a wave takes about as long with either tile:
    ``_tile_by_waves``."""
    return _tile_by_waves(bh, sk, sms)


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
    return bind_bwd(build.load(BWD_KERNEL))


def bind_bwd(lib: ctypes.CDLL) -> types.SimpleNamespace:
    """The backward's three C entries (prep, main, convert) of a library
    built from ``csrc/flash_attention_bwd.cu`` (or a variant of it)."""
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    fns = types.SimpleNamespace(prep=lib.pnpi_flash_attention_bwd_prep_bf16,
                                main=lib.pnpi_flash_attention_bwd_bf16,
                                convert=lib.pnpi_flash_attention_bwd_dq_convert_bf16)
    fns.prep.argtypes = [ptr] * 5 + [i64] * 6 + [i32] * 4 + [ptr]
    fns.main.argtypes = [ptr] * 8 + [i64] * 18 + [i32] * 6 + [f32, ptr]
    fns.convert.argtypes = [ptr] * 2 + [i64] * 3 + [i32] * 4 + [f32, ptr]
    for fn in vars(fns).values():
        fn.restype = ctypes.c_int
    return fns


def bwd_smem_bytes(tile_keys: int, d: int) -> int:
    """Dynamic shared memory of the backward main kernel's instantiation for
    (tile_keys, d), as the C side computes it."""
    return build.load(BWD_KERNEL).pnpi_flash_attention_bwd_smem_bytes(tile_keys, d)


def _no_grad_tracking(name: str, *xs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(f"{name} records no autograd graph: call flash_attention "
                           "(FlashAttention.apply) on inputs that require grad")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) of non-causal softmax attention: the bf16 kernel, or on f32
    inputs the f32 one (``flash_attention_fwd_f32``; this wrapper's count is
    the bf16 kernel's launches). q/k/v may be strided views
    (e.g. heads split from a (B, S, H*D) tensor); O comes back as a (B, H, Sq,
    D) view of a (B, Sq, H, D) buffer, so merging heads afterwards is free.
    Raises on inputs that require grad while grad mode is on: only
    ``FlashAttention`` may call it then."""
    _no_grad_tracking("flash_attention_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.dtype == torch.float32:
        return flash_attention_fwd_f32(q, k, v, scale)
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


def _raise_on(err: int, name: str, q: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(f"flash backward {name} kernel launch failed: cudaError {err} for "
                           f"q {tuple(q.shape)}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_like(q, others) -> None:
    for name, x in others:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash backward: {name} {tuple(x.shape)} {x.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
        _check_strided(name, x)


def _check_bwd(q, k, v, lse, do, others) -> None:
    _check(q, k, v)
    _check_like(q, others)
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash backward: lse must be contiguous f32 {tuple(q.shape[:3])}, "
                         f"got {tuple(lse.shape)} {lse.dtype}")


def _check_f32(name: str, x: torch.Tensor, shape: tuple, like: torch.Tensor) -> None:
    if (tuple(x.shape) != shape or x.dtype != torch.float32 or x.device != like.device
            or not x.is_contiguous()):
        raise ValueError(f"flash backward: {name} must be contiguous f32 {shape} on "
                         f"{like.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")


def _check_acc(q: torch.Tensor, stats: torch.Tensor, dq_acc: torch.Tensor) -> None:
    b, h, sq, d = q.shape
    n = _tiles(sq)
    _check_f32("stats", stats, (b * h, n, 2, BWD_BLOCK_Q), q)
    _check_f32("dq_acc", dq_acc, (b * h, n * BWD_BLOCK_Q, d), q)


def _launch_bwd_prep(out, lse, do, stream: int):
    """One launch of the prep kernel on inputs ``_check_bwd`` has passed."""
    b, h, sq, d = out.shape
    n = _tiles(sq)
    stats = torch.empty((b * h, n, 2, BWD_BLOCK_Q), dtype=torch.float32, device=out.device)
    dq_acc = torch.empty((b * h, n * BWD_BLOCK_Q, d), dtype=torch.float32, device=out.device)
    _raise_on(_bwd_kernels().prep(out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                  stats.data_ptr(), dq_acc.data_ptr(), *out.stride()[:3],
                                  *do.stride()[:3], b, h, sq, d, stream), "prep", out)
    flash_attention_bwd_prep.launches += 1
    return stats, dq_acc


def _launch_bwd_main(q, k, v, do, stats, dq_acc, scale, tile_keys, stream: int):
    """One launch of the main kernel on checked inputs that TMA can describe,
    with ``tile_keys`` (64 or 128) keys per CTA, or ``bwd_tile_keys``'s choice
    where it is None."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tile_keys is None:
        tile_keys = bwd_tile_keys(b * h, sk, _sm_count(q.device.index))
    dk, dv = _heads_last(b, h, sk, d, k), _heads_last(b, h, sk, d, v)
    _raise_on(_bwd_kernels().main(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats.data_ptr(),
        dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *do.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
        b, h, sq, sk, d, tile_keys, scale, stream), "main", q)
    flash_attention_bwd_main.launches += 1
    return dk, dv


def _launch_bwd_dq_convert(dq_acc, q, scale, stream: int):
    """One launch of the dQ convert kernel on a checked accumulator."""
    b, h, sq, d = q.shape
    dq = _heads_last(b, h, sq, d, q)
    _raise_on(_bwd_kernels().convert(dq_acc.data_ptr(), dq.data_ptr(), *dq.stride()[:3], b, h,
                                     sq, d, scale, stream), "dq convert", q)
    flash_attention_bwd_dq_convert.launches += 1
    return dq


def flash_attention_bwd_prep(out, lse, do):
    """(stats, dq_acc): the prep kernel, which writes LSE * log2(e) and
    delta = rowsum(dO * O) of every query row into a (B*H, n_q, 2, 64) f32
    buffer (0 past Sq) and zeroes the (B*H, 64 * n_q, D) f32 dQ
    accumulator."""
    _no_grad_tracking("flash_attention_bwd_prep", out, do)
    if out.device.type == "cpu":
        return flash_attention_bwd_prep_reference(out, lse, do)
    _check_bwd(out, out, out, lse, do, (("do", do),))
    return _launch_bwd_prep(out, lse, do, _stream(out))


def flash_attention_bwd_main(q, k, v, do, stats, dq_acc, scale):
    """(dK, dV): the main backward kernel (B2 and B3 in one pass), each a
    (B, H, Sk, D) view of a (B, Sk, H, D) buffer; it adds dS K (unscaled)
    into ``dq_acc`` (a TMA bulk reduce-add per query tile), in an order that
    varies from run to run."""
    _no_grad_tracking("flash_attention_bwd_main", q, k, v, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_main_reference(q, k, v, do, stats, dq_acc, scale)
    _check(q, k, v)
    _check_like(q, (("do", do),))
    _check_acc(q, stats, dq_acc)
    q, k, v, do = (_no_broadcast(x) for x in (q, k, v, do))
    return _launch_bwd_main(q, k, v, do, stats, dq_acc, float(scale), None, _stream(q))


def flash_attention_bwd_dq_convert(dq_acc, q, scale):
    """dQ = scale * dq_acc in q's dtype: the dQ convert kernel, a (B, H, Sq,
    D) view of a (B, Sq, H, D) buffer."""
    if dq_acc.device.type == "cpu":
        return flash_attention_bwd_dq_convert_reference(dq_acc, q, scale)
    b, h, sq, d = q.shape
    _check_f32("dq_acc", dq_acc, (b * h, _tiles(sq) * BWD_BLOCK_Q, d), q)
    if q.dtype != torch.bfloat16 or d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"flash backward: dQ of bf16 q with d % 8 == 0, d <= 128; got "
                         f"{q.dtype}, d = {d}")
    return _launch_bwd_dq_convert(dq_acc, q, float(scale), _stream(q))


flash_attention_bwd_prep.launches = 0
flash_attention_bwd_main.launches = 0
flash_attention_bwd_dq_convert.launches = 0
BWD_WRAPPERS = (flash_attention_bwd_prep, flash_attention_bwd_main,
                flash_attention_bwd_dq_convert)


def flash_attention_bwd(q, k, v, out, lse, do, scale):
    """(dQ, dK, dV) of ``flash_attention_fwd``: for bf16 the prep, main and dQ
    convert kernels in turn, on inputs checked once; for f32 delta =
    rowsum(dO * O) (one reduction, as the JAX package takes it outside its
    kernels) and then the f32 dQ and dK/dV kernels (each after its split
    pass). The plain versions on CPU
    tensors. A dO whose strides the kernels do not take (e.g. an expanded
    gradient) is made contiguous first: a copy, not a fallback."""
    if do.device.type == "cpu":
        stats, dq_acc = flash_attention_bwd_prep(out, lse, do)
        dk, dv = flash_attention_bwd_main(q, k, v, do, stats, dq_acc, scale)
        return flash_attention_bwd_dq_convert(dq_acc, q, scale), dk, dv
    _no_grad_tracking("flash_attention_bwd", q, k, v, out, do)
    if not _takes_strides(do):
        do = do.contiguous()
    if q.dtype == torch.float32:
        _check_like(q, (("out", out), ("do", do)))
        delta = (do * out).sum(dim=-1).contiguous()
        return ((flash_attention_bwd_dq_f32(q, k, v, do, lse, delta, scale),)
                + flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta, scale))
    _check_bwd(q, k, v, lse, do, (("out", out), ("do", do)))
    stream, scale = _stream(q), float(scale)
    stats, dq_acc = _launch_bwd_prep(out, lse, do, stream)
    q, k, v, do = (_no_broadcast(x) for x in (q, k, v, do))
    dk, dv = _launch_bwd_main(q, k, v, do, stats, dq_acc, scale, None, stream)
    return _launch_bwd_dq_convert(dq_acc, q, scale, stream), dk, dv


@functools.lru_cache(maxsize=None)
def _f32_kernels() -> types.SimpleNamespace:
    """The C entries of ``csrc/flash_attention_fwd_f32.cu`` (the forward's
    split pass and main kernel) and ``csrc/flash_attention_bwd_f32.cu`` (the
    backward's split pass, and the dQ or the dK/dV kernel)."""
    fwd, bwd = build.load(F32_FWD_KERNEL), build.load(F32_BWD_KERNEL)
    ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    fns = types.SimpleNamespace(split=fwd.pnpi_flash_attention_fwd_f32_split,
                                fwd=fwd.pnpi_flash_attention_fwd_f32,
                                bwd_split=bwd.pnpi_flash_attention_bwd_f32_split,
                                bwd=bwd.pnpi_flash_attention_bwd_f32)
    fns.split.argtypes = [ptr] * 3 + [i64] * 6 + [i32] * 5 + [ptr]
    fns.fwd.argtypes = [ptr] * 4 + [i64] * 6 + [i32] * 6 + [f32, ptr]
    fns.bwd_split.argtypes = [ptr] * 5 + [i64] * 6 + [i32] * 6 + [ptr]
    fns.bwd.argtypes = [ptr] * 7 + [i64] * 12 + [i32] * 6 + [f32, i32, ptr]
    for fn in vars(fns).values():
        fn.restype = ctypes.c_int
    return fns


def fwd_f32_smem_bytes(tile_rows: int, d: int) -> int:
    """Dynamic shared memory of the f32 forward's instantiation for
    (tile_rows, d), as the C side computes it (-1: none)."""
    return build.load(F32_FWD_KERNEL).pnpi_flash_attention_fwd_f32_smem_bytes(tile_rows, d)


def bwd_f32_smem_bytes(kernel: str, tile_rows: int, d: int) -> int:
    """Dynamic shared memory of the f32 backward's ``kernel`` ("dq" or
    "dkv") for (tile_rows, d), as the C side computes it (-1: none)."""
    return build.load(F32_BWD_KERNEL).pnpi_flash_attention_bwd_f32_smem_bytes(
        int(kernel == "dkv"), tile_rows, d)


def _core_matrices(x: torch.Tensor) -> torch.Tensor:
    """(..., R, K) -> (..., R * K) in the wgmma core-matrix order of the f32
    forward's tiles: 8x4 blocks of 32 contiguous values (8 rows of 4), row
    groups outermost, then column groups."""
    *lead, r, c = x.shape
    x = x.reshape(*lead, r // 8, 8, c // 4, 4).transpose(-3, -2)
    return x.reshape(*lead, r * c)


def _split_tiles(x: torch.Tensor, t: int) -> torch.Tensor:
    """(B, H, S, D) -> (B*H, n, t, D): n = ceil(S / t) tiles of t positions,
    zero past S."""
    b, h, s, d = x.shape
    n = -(-s // t)
    return torch.nn.functional.pad(x.float(), (0, 0, 0, n * t - s)).reshape(b * h, n, t, d)


def _split_transposed(x: torch.Tensor, t: int) -> torch.Tensor:
    """(B, H, S, D) -> (B*H, n, D, t): the tiles transposed, the positions of
    each group of 8 in ``F32_KEY_PERM`` order. The permutation as views:
    slot 4 h + u of a group holds position 2 u + h (an index tensor would be
    a host-to-device copy that waits for the device)."""
    tiles = _split_tiles(x, t)
    bh, n, _, d = tiles.shape
    tiles = tiles.reshape(bh, n, t // 8, 4, 2, d).transpose(3, 4)
    return tiles.reshape(bh, n, t, d).transpose(-1, -2)


def _split_halves(arrays) -> list:
    """hi and lo (``tf32_split``) of each tile array, in core-matrix order."""
    out = []
    for x in arrays:
        out.extend(tf32_split(_core_matrices(x.contiguous())))
    return out


def flash_attention_fwd_f32_split_reference(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of the f32 forward's split pass: a (B*H, n, 4, KT * D)
    f32 tensor, n = ceil(Sk / KT) tiles of KT = ``fwd_f32_tile_keys(D)`` keys
    (zero past Sk), each K hi, K lo, V^T hi, V^T lo (``tf32_split``) in core-
    matrix order; V^T's rows are head-dim columns, its keys in each group of 8
    in ``F32_KEY_PERM`` order."""
    kt = fwd_f32_tile_keys(k.shape[3])
    return torch.stack(_split_halves((_split_tiles(k, kt), _split_transposed(v, kt))), dim=2)


def flash_attention_bwd_f32_split_reference(x: torch.Tensor, y: torch.Tensor, lse=None,
                                            delta=None) -> torch.Tensor:
    """Plain version of the f32 backward's split pass: a (B*H, n, F) f32
    tensor of n = ceil(S / T) tiles (zero past S). For the dQ kernel (x = K,
    y = V, no ``lse``/``delta``; T = ``bwd_f32_tile_keys(D)``) each tile is
    K, V (rows of D) and K^T (rows are head-dim columns, the keys of each
    group of 8 in ``F32_KEY_PERM`` order), each hi then lo (``tf32_split``)
    in core-matrix order: F = 6 T D. For the dK/dV kernel (x = Q, y = dO,
    ``lse`` and ``delta`` the (B, H, Sq) f32 rows; T =
    ``bwd_f32_tile_queries(D)``) Q, dO, Q^T, dO^T, then the tile's LSE (+inf
    past Sq, so those queries' P is 0) and delta (0 past Sq): F = 8 T D + 2 T."""
    b, h, s, d = x.shape
    dkv = lse is not None
    t = bwd_f32_tile_queries(d) if dkv else bwd_f32_tile_keys(d)
    arrays = [_split_tiles(x, t), _split_tiles(y, t), _split_transposed(x, t)]
    if dkv:
        arrays.append(_split_transposed(y, t))
    out = torch.stack(_split_halves(arrays), dim=2)
    out = out.reshape(out.shape[0], out.shape[1], -1)
    if not dkv:
        return out
    n = out.shape[1]
    stats = [torch.nn.functional.pad(z.reshape(b * h, s).float(), (0, n * t - s), value=fill)
             .reshape(b * h, n, t) for z, fill in ((lse, math.inf), (delta, 0.0))]
    return torch.cat([out, *stats], dim=-1)


def _launch_split_f32(k, v):
    """One launch of the f32 forward's split pass on checked inputs."""
    b, h, sk, d = k.shape
    kt = fwd_f32_tile_keys(d)
    out = torch.empty((b * h, -(-sk // kt), 4, kt * d), dtype=torch.float32, device=k.device)
    _raise_on(_f32_kernels().split(k.data_ptr(), v.data_ptr(), out.data_ptr(), *k.stride()[:3],
                                   *v.stride()[:3], b, h, sk, d, kt, _stream(k)),
              "f32 split", k)
    flash_attention_fwd_f32_split.launches += 1
    return out


def flash_attention_fwd_f32_split(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The f32 forward's split pass alone (``flash_attention_fwd_f32`` runs
    it before its main kernel): its plain version on CPU tensors."""
    _no_grad_tracking("flash_attention_fwd_f32_split", k, v)
    if k.device.type == "cpu":
        return flash_attention_fwd_f32_split_reference(k, v)
    _check(k, k, v, torch.float32)
    return _launch_split_f32(k, v)


flash_attention_fwd_f32_split.launches = 0


def _launch_fwd_f32(q, k, v, scale: float, rows=None):
    """One f32 forward on inputs ``_check`` has passed: the split pass, then
    the main kernel with ``rows`` (64 or 128) query rows per CTA, or
    ``fwd_f32_tile_rows``' choice where it is None."""
    b, h, sq, d = q.shape
    if rows is None:
        rows = fwd_f32_tile_rows(b * h, sq, d, _sm_count(q.device.index))
    kv = _launch_split_f32(k, v)
    out = _heads_last(b, h, sq, d, q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _f32_kernels().fwd(
        q.data_ptr(), kv.data_ptr(), out.data_ptr(), lse.data_ptr(), *q.stride()[:3],
        *out.stride()[:3], b, h, sq, k.shape[2], d, rows, scale, _stream(q))
    if err != 0:
        raise RuntimeError(f"f32 flash kernel launch failed: cudaError {err} for q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}, {rows} rows per CTA")
    return out, lse


def _launch_bwd_split_f32(x, y, lse=None, delta=None):
    """One launch of the f32 backward's split pass on checked inputs: the dQ
    kernel's (x = K, y = V) or, with ``lse`` and ``delta``, the dK/dV
    kernel's (x = Q, y = dO)."""
    b, h, s, d = x.shape
    dkv = lse is not None
    t = bwd_f32_tile_queries(d) if dkv else bwd_f32_tile_keys(d)
    width = t * d * (8 if dkv else 6) + (2 * t if dkv else 0)
    out = torch.empty((b * h, -(-s // t), width), dtype=torch.float32, device=x.device)
    _raise_on(_f32_kernels().bwd_split(
        x.data_ptr(), y.data_ptr(), lse.data_ptr() if dkv else None,
        delta.data_ptr() if dkv else None, out.data_ptr(), *x.stride()[:3], *y.stride()[:3],
        b, h, s, d, t, int(dkv), _stream(x)), "f32 split", x)
    flash_attention_bwd_f32_split.launches += 1
    return out


def flash_attention_bwd_f32_split(x: torch.Tensor, y: torch.Tensor, lse=None,
                                  delta=None) -> torch.Tensor:
    """The f32 backward's split pass alone (each f32 backward kernel runs its
    own before it): the dQ kernel's (x = K, y = V) or, given the (B, H, Sq)
    ``lse`` and ``delta``, the dK/dV kernel's (x = Q, y = dO); the plain
    version on CPU tensors."""
    _no_grad_tracking("flash_attention_bwd_f32_split", x, y)
    if (lse is None) != (delta is None):
        raise ValueError("flash backward split: lse and delta come together (the dK/dV "
                         "kernel's split) or not at all (the dQ kernel's)")
    if x.device.type == "cpu":
        return flash_attention_bwd_f32_split_reference(x, y, lse, delta)
    _check(x, x, y, torch.float32)
    if lse is not None:
        _check_stats(x, lse, delta)
    return _launch_bwd_split_f32(x, y, lse, delta)


flash_attention_bwd_f32_split.launches = 0


def _launch_bwd_f32(q, k, v, do, lse, delta, scale: float, dq_only: bool, rows=None):
    """One f32 dQ (``dq_only``) or dK/dV computation on checked inputs: the
    kernel's split pass, then the kernel with ``rows`` (64 or 128) rows per
    CTA, or ``bwd_f32_tile_rows``' choice where it is None. dQ, or (dK, dV),
    each a (B, H, S, D) view of a (B, S, H, D) buffer."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kernel = "dq" if dq_only else "dkv"
    if rows is None:
        rows = bwd_f32_tile_rows(kernel, b * h, sq if dq_only else sk, d,
                                 _sm_count(q.device.index))
    if dq_only:
        tiles = _launch_bwd_split_f32(k, v)
        own, out = (q, do), (_heads_last(b, h, sq, d, q),)
        stats, lengths = (lse.data_ptr(), delta.data_ptr()), (sq, sk)
    else:
        tiles = _launch_bwd_split_f32(q, do, lse, delta)
        own, out = (k, v), (_heads_last(b, h, sk, d, k), _heads_last(b, h, sk, d, v))
        stats, lengths = (None, None), (sk, sq)
    o2 = out[-1]  # dV, or dQ again (the dQ kernel writes one output)
    _raise_on(_f32_kernels().bwd(
        own[0].data_ptr(), own[1].data_ptr(), tiles.data_ptr(), *stats, out[0].data_ptr(),
        o2.data_ptr(), *own[0].stride()[:3], *own[1].stride()[:3], *out[0].stride()[:3],
        *o2.stride()[:3], b, h, *lengths, d, rows, scale, int(not dq_only), _stream(q)),
        f"f32 {'dQ' if dq_only else 'dK/dV'} ({rows} rows per CTA)", q)
    return out[0] if dq_only else out


def flash_attention_fwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) of f32 q/k/v: the f32 forward (its split pass, then 3xTF32
    wgmma on the tensor cores, f32 accuracy whatever the process's TF32
    flags), its plain version on CPU tensors. Strided views as for
    ``flash_attention_fwd``; O comes back as a (B, H, Sq, D) view of a (B, Sq,
    H, D) buffer. Each call allocates the split pass's output, B*H x Sk x D x
    16 bytes (the hi and lo of K and V^T)."""
    _no_grad_tracking("flash_attention_fwd_f32", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check(q, k, v, torch.float32)
    out, lse = _launch_fwd_f32(q, k, v, float(scale))
    flash_attention_fwd_f32.launches += 1
    return out, lse


def _check_stats(q, lse, delta) -> None:
    for name, x in (("lse", lse), ("delta", delta)):
        _check_f32(name, x, tuple(q.shape[:3]), q)


def flash_attention_bwd_dq_f32(q, k, v, do, lse, delta, scale):
    """dQ of f32 inputs from the forward's LSE and delta = rowsum(dO * O), each
    a contiguous (B, H, Sq) f32 tensor: the f32 dQ kernel (its split pass of
    K and V, then 3xTF32 wgmma; a CTA's 64 or 128 queries walk every key, no
    atomics), its plain version on CPU tensors."""
    _no_grad_tracking("flash_attention_bwd_dq_f32", q, k, v, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    _check(q, k, v, torch.float32)
    _check_like(q, (("do", do),))
    _check_stats(q, lse, delta)
    dq = _launch_bwd_f32(q, k, v, do, lse, delta, float(scale), True)
    flash_attention_bwd_dq_f32.launches += 1
    return dq


def flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta, scale):
    """(dK, dV) of f32 inputs from the forward's LSE and delta: the f32 dK/dV
    kernel (its split pass of Q, dO, LSE and delta, then 3xTF32 wgmma; a
    CTA's 64 or 128 keys walk every query, no atomics), its plain version on
    CPU tensors."""
    _no_grad_tracking("flash_attention_bwd_dkv_f32", q, k, v, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    _check(q, k, v, torch.float32)
    _check_like(q, (("do", do),))
    _check_stats(q, lse, delta)
    dk, dv = _launch_bwd_f32(q, k, v, do, lse, delta, float(scale), False)
    flash_attention_bwd_dkv_f32.launches += 1
    return dk, dv


flash_attention_fwd_f32.launches = 0
flash_attention_bwd_dq_f32.launches = 0
flash_attention_bwd_dkv_f32.launches = 0
F32_WRAPPERS = (flash_attention_fwd_f32, flash_attention_fwd_f32_split,
                flash_attention_bwd_dq_f32, flash_attention_bwd_dkv_f32,
                flash_attention_bwd_f32_split)


class FlashAttention(torch.autograd.Function):
    """O = softmax(scale q k^T) v, differentiable in q, k and v: the forward
    kernel of the inputs' dtype saves (q, k, v, O, LSE) and the backward runs
    that dtype's backward kernels (the plain versions on CPU tensors)."""

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
