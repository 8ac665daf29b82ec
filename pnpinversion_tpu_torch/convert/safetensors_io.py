"""The safetensors file format, read and written without the ``safetensors``
package (the GPU host has none).

A file is an 8-byte little-endian header length N, N bytes of JSON, then the
raw little-endian tensor bytes. The JSON maps each tensor's name to its
``dtype``, ``shape`` and ``data_offsets`` [begin, end) into the byte buffer
that follows the header; an optional ``__metadata__`` maps strings to
strings. The writer lays a file out byte for byte as the ``safetensors``
package does: tensors ordered by dtype (the package's enum order, largest
first) then by name, compact JSON with ``__metadata__`` first, the header
padded with spaces to a multiple of 8 bytes. (The package writes the
metadata's keys in its hash map's order, so with more than one key its bytes
vary from run to run; the writer sorts them.)
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# safetensors name -> torch dtype; the order is the package's dtype enum
# order among these five, which the writer sorts by (largest first)
DTYPES = {"F16": torch.float16, "BF16": torch.bfloat16, "I32": torch.int32,
          "F32": torch.float32, "I64": torch.int64}
_NAMES = {v: k for k, v in DTYPES.items()}
_RANK = {name: i for i, name in enumerate(DTYPES)}
_MAX_HEADER = 100 * 2**20


def _parse_header(buf: memoryview, path: str) -> Tuple[dict, Dict[str, str], int]:
    if len(buf) < 8:
        raise ValueError(f"{path}: {len(buf)} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > min(_MAX_HEADER, len(buf) - 8):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    meta = header.pop("__metadata__", None) or {}
    return header, meta, 8 + n


def _check_entries(header: dict, size: int, path: str) -> list:
    """(begin, end, name, dtype, shape) of every tensor, sorted; refuses an
    unknown dtype, a size that does not match the shape, offsets outside the
    buffer and overlapping tensors."""
    spans = []
    for name, info in header.items():
        dtype = info.get("dtype")
        if dtype not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype!r}; "
                             f"supported: {sorted(DTYPES)}")
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * DTYPES[dtype].itemsize
        if not 0 <= begin <= end <= size:
            raise ValueError(f"{path}: tensor {name!r} offsets [{begin}, {end}) fall outside "
                             f"the {size}-byte buffer")
        if end - begin != nbytes:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, its "
                             f"{dtype} shape {shape} needs {nbytes}")
        spans.append((begin, end, name, dtype, shape))
    spans.sort()
    for (b0, e0, n0, _, _), (b1, _, n1, _, _) in zip(spans, spans[1:]):
        if b1 < e0:
            raise ValueError(f"{path}: tensors {n0!r} and {n1!r} overlap")
    return spans


def read_safetensors(path: str, with_metadata: bool = False):
    """{name: CPU tensor} of a safetensors file (and its ``__metadata__``
    when ``with_metadata``). The tensors share one buffer read from disk."""
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    header, meta, start = _parse_header(memoryview(raw), path)
    spans = _check_entries(header, len(raw) - start, path)
    out: Dict[str, torch.Tensor] = {}
    for begin, end, name, dtype, shape in spans:
        dt = DTYPES[dtype]
        offset = start + begin
        if end == begin:
            t = torch.empty(shape, dtype=dt)
        elif offset % dt.itemsize == 0:
            t = torch.frombuffer(raw, dtype=dt, count=(end - begin) // dt.itemsize,
                                 offset=offset).reshape(shape)
        else:  # an unaligned tensor: copy its bytes out
            t = torch.frombuffer(bytearray(raw[offset:start + end]), dtype=dt).reshape(shape)
        out[name] = t
    return (out, meta) if with_metadata else out


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(v))


def write_safetensors(path: str, tensors: Mapping[str, object],
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Writes tensors (torch tensors or numpy arrays of a supported dtype) as
    the ``safetensors`` package lays them out."""
    items = {k: _as_tensor(v) for k, v in tensors.items()}
    for name, t in items.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not one of "
                             f"{sorted(DTYPES)}")
    order = sorted(items, key=lambda k: (-_RANK[_NAMES[items[k].dtype]], k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(sorted(metadata.items()))
    offset = 0
    for name in order:
        t = items[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    text += b" " * ((-(8 + len(text))) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in order:
            t = items[name]
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
