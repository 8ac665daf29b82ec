"""Model FLOPs of the port's code: the port's counterpart of the JAX
package's ``scripts/_flops.py``. ``utils/mfu.py`` counts the main path's
edit with it and divides the count by device time.

What is counted, by kind (``FlopCount``):

- ``matmul`` and ``conv``: every matrix product and convolution, forward and
  backward, from its shapes, by PyTorch's ``FlopCounterMode`` (aten's mm,
  addmm, bmm, baddbmm, convolution, convolution_backward, ...).
- ``attention_fwd`` and ``attention_bwd``: the flash attention kernel, by
  formula at the one place it is entered
  (``ops/flash_attention.py::FlashAttention``): 4·B·H·Sq·Sk·d forward (QKᵀ
  and PV), 8·B·H·Sq·Sk·d backward (dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K,
  dK = dSᵀ·Q: the four products of autograd's backward through the plain
  path). On the card the kernel is a ctypes launch that no dispatch mode
  sees; on the CPU it is the kernel's plain version, whose products are not
  counted a second time on top of the formula. Attention that takes the
  plain path (``ops/attention.py::use_flash`` false: the CPU, short or
  ragged sequences, the sites whose probabilities a controller edits) is
  counted once, by its products, under ``matmul``. So the same code gives
  the same total on either device.

These are model FLOPs, not the hardware's: the fused bf16 backward kernel
recomputes P from the LSE and so does 10·B·H·Sq·Sk·d (PERF.md §6), and the
JAX count (``scripts/_flops.py::_flash_flops``) takes its two backward
kernels, which each recompute the scores, as 14·. Neither recomputation is
the model's work, and neither is counted here. Elementwise work (norms,
softmax, activations, the DDIM update) is not counted, as in the JAX count.

The JAX count of the same programs differs by three named amounts
(``tests/_torch_flops.py``): its GroupNorm reduces through one-hot (C, G)
membership products, four a norm (8·B·C·G), where the port reshapes; its P2P
self-attention replace computes the source row's products on every step and
selects them with ``where``, where the port computes them only inside the
replace window; and its ``vmap`` over a sweep's images computes the
timestep embedding once for all of them, where the port computes it per row.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FlopCount:
    """FLOPs by kind; ``total`` is their sum."""

    matmul: float = 0.0
    conv: float = 0.0
    attention_fwd: float = 0.0
    attention_bwd: float = 0.0

    @property
    def total(self) -> float:
        return self.matmul + self.conv + self.attention_fwd + self.attention_bwd

    def _zip(self, other, op) -> "FlopCount":
        return FlopCount(*(op(a, b) for a, b in zip(dataclasses.astuple(self),
                                                     dataclasses.astuple(other))))

    def __add__(self, other: "FlopCount") -> "FlopCount":
        return self._zip(other, lambda a, b: a + b)

    def __sub__(self, other: "FlopCount") -> "FlopCount":
        return self._zip(other, lambda a, b: a - b)

    def __mul__(self, k: float) -> "FlopCount":
        return FlopCount(*(k * a for a in dataclasses.astuple(self)))

    __rmul__ = __mul__

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "total": self.total}


def attention_flops(kind: str, q: torch.Tensor, k: torch.Tensor) -> float:
    """The flash formula for q (B, H, Sq, d), k (B, H, Sk, d): 4·B·H·Sq·Sk·d
    forward, 8· backward."""
    b, h, sq, d = q.shape
    return {"fwd": 4.0, "bwd": 8.0}[kind] * b * h * sq * k.shape[2] * d


_ACTIVE: Optional["FlopCounter"] = None  # the counter inside whose block code runs


class FlopCounter:
    """``with FlopCounter() as fc: ...`` counts what runs inside; ``fc.count``
    is the ``FlopCount`` so far, ``fc.attention_shapes`` the (kind, B, H,
    Sq, Sk, d) the flash kernel was entered at. One counts at a time."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self._mode = FlopCounterMode(display=False)
        self._excluded = FlopCount()  # products of the flash kernel's plain version
        self._attention = FlopCount()
        self.attention_shapes = set()

    def __enter__(self) -> "FlopCounter":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FlopCounter is already counting")
        self._mode.__enter__()
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return self._mode.__exit__(*exc)

    def _dispatched(self) -> FlopCount:
        matmul = conv = 0.0
        for op, n in self._mode.flop_counts["Global"].items():
            if "convolution" in str(op):
                conv += n
            else:
                matmul += n
        return FlopCount(matmul=matmul, conv=conv)

    @property
    def count(self) -> FlopCount:
        return self._dispatched() - self._excluded + self._attention


@contextlib.contextmanager
def counted_attention(kind: str, q: torch.Tensor, k: torch.Tensor):
    """Wraps one entry into the flash kernel (``kind`` "fwd" or "bwd"): the
    active counter adds the formula and drops whatever the body dispatches
    (the plain version's products on the CPU; nothing on the card). Free
    when no counter is active."""
    counter = _ACTIVE
    if counter is None:
        yield
        return
    before = counter._dispatched()
    try:
        yield
    finally:
        counter._excluded = counter._excluded + (counter._dispatched() - before)
        counter._attention = counter._attention + FlopCount(
            **{f"attention_{kind}": attention_flops(kind, q, k)})
        counter.attention_shapes.add((kind, *q.shape[:3], k.shape[2], q.shape[3]))


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[object, FlopCount]:
    """(fn(*args, **kwargs), the FLOPs it ran)."""
    with FlopCounter() as fc:
        out = fn(*args, **kwargs)
    return out, fc.count
