"""A rank's record of what it decided on the host and what it computed: the
check that the ranks of a tensor-parallel group stay together.

The ranks of a tp group (``parallel/tensor_parallel.py``) are separate
processes that must take the same host-side branches: a loop that stops on a
loss read back from the device (null-text's and null-latent's per-image stop
in ``inversion/ddim_inversion.py``, StyleDiffusion's in
``inversion/stylediffusion.py``) and stopped at another step on one rank
would pair that rank's collectives with the wrong ones of the others. Within
``recording()``, those loops note each inner step's losses, the values the
stop reads (``losses``), and the inner steps they took at each outer step
(``decision``), and the sweep notes a digest of each batch's decoded panels
before they are written (``digest``). Ranks whose records are equal read the
same values, took the same branches and hold the same results; a rank that
writes no strips is checked by its record alone. Outside ``recording()``
these calls do nothing (``losses`` reads nothing back from the device).
"""
from __future__ import annotations

import contextlib
import hashlib
from typing import Iterator, Optional

import numpy as np

_RECORD: Optional[dict] = None


@contextlib.contextmanager
def recording() -> Iterator[dict]:
    """Yields the record filled until the block ends: {"decisions": [[kind,
    value], ...], "losses": [[kind, [loss, ...]], ...], "digests": [[kind,
    sha1 hex], ...]}, in the order taken."""
    global _RECORD
    outer, _RECORD = _RECORD, {"decisions": [], "losses": [], "digests": []}
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def decision(kind: str, value: int) -> None:
    """Notes a host-side decision (an inner loop's step count)."""
    if _RECORD is not None:
        _RECORD["decisions"].append([kind, int(value)])


def losses(kind: str, loss) -> None:
    """Notes a loss tensor's values (one per image) as host floats."""
    if _RECORD is not None:
        _RECORD["losses"].append([kind, loss.detach().float().cpu().reshape(-1).tolist()])


def digest(kind: str, *arrays) -> None:
    """Notes the sha1 of host arrays' bytes (with their shapes and dtypes)."""
    if _RECORD is None:
        return
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.shape}{a.dtype}".encode())
        h.update(a.tobytes())
    _RECORD["digests"].append([kind, h.hexdigest()])
