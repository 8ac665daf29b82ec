"""Multi-process runs over ``torch.distributed``, one process per GPU (port of
``pnpinversion_tpu/parallel/multihost.py``, with the device placement and the
local launcher that the JAX package gets from its device mesh,
``parallel/sweep.py::make_dp_mesh``).

The sweep is embarrassingly parallel: each process takes a disjoint slice of
the mapping file (``process_shard``) and the file-based skip-existing
contract handles restarts; the final counts reduce with one collective
(``allreduce_metrics``). The trainer all-reduces its gradients in flat
buckets (``all_reduce_``) and gathers its ZeRO-sharded update block by block
(``all_gather_blocks_``); a tensor-parallel layer gathers its output's
column blocks (``all_gather_columns``).

Where a JAX process drives all its local chips through one mesh, PyTorch maps
one device to one process: ``launch_local`` starts N processes on this host
(the ``spawn`` start method), and ``rank_device`` puts rank r on
``cuda:<r % device_count>``. The backend is explicit: NCCL needs one GPU per
rank, so two ranks on one GPU use gloo, whose collectives on CUDA tensors are
``broadcast`` and ``all_reduce`` only (staged through the host). So every
collective here is one of those two, a gather being a broadcast from each
rank, except ``all_gather_columns`` on NCCL, which is one
``all_gather_into_tensor``.
Every collective has the process group's timeout, so a lost rank fails the
run instead of hanging it.
"""
from __future__ import annotations

import datetime
import importlib
import os
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pnpinversion_tpu_torch.utils.device import resolve_device

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 600.0  # every collective's limit: a full-width gradient bucket through gloo included
BUCKET_BYTES = 256 << 20  # the most one flat all_reduce of ``all_reduce_`` carries


def free_port() -> int:
    """A TCP port on the loopback that is free now (port 0 bound, then freed)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device=None, local_rank: int = 0) -> torch.device:
    """The device of this process: ``device`` when it names one (``cpu``,
    ``cuda:1``), else ``cuda:<local_rank % device_count>``; raises without
    CUDA (``resolve_device``)."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device=None, timeout_s: float = TIMEOUT_S) -> bool:
    """Joins the process group of ``num_processes`` processes as rank
    ``process_id`` through ``tcp://<coordinator_address>`` (host:port of rank
    0). A no-op for one process unless a backend is named (a group of one, so
    the collectives run); a no-op too when this process already belongs to a
    group (of that size as that rank, where they are given): the caller that
    made the group owns it.
    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo otherwise; for
    NCCL the device becomes the process's current one. Returns whether it
    made the group, which the caller then ends with ``shutdown``."""
    world_size = num_processes or 1
    rank_ = process_id or 0
    if dist.is_initialized():
        if num_processes is not None and (dist.get_world_size(),
                                          dist.get_rank()) != (world_size, rank_):
            raise RuntimeError(f"this process is rank {dist.get_rank()} of "
                               f"{dist.get_world_size()}, not {rank_} of {world_size}")
        return False
    if world_size <= 1 and backend is None:
        return False
    if world_size > 1 and (coordinator_address is None or process_id is None):
        raise ValueError("--num_processes > 1 needs --process_id and --coordinator_address")
    if not 0 <= rank_ < world_size:
        raise ValueError(f"process_id {rank_} is outside 0..{world_size - 1}")
    device = torch.device(device) if device is not None else torch.device("cpu")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        torch.cuda.set_device(device)
    address = coordinator_address or f"127.0.0.1:{free_port()}"
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world_size,
                            rank=rank_, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _collective_device() -> torch.device:
    """Where the group's small collectives run: the current GPU for NCCL,
    the host for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_shard(items: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> List:
    """This process's slice of the items: those whose index is its rank
    modulo the process count (the JAX package's partition)."""
    pi = rank() if process_index is None else process_index
    pc = world() if process_count is None else process_count
    return [it for i, it in enumerate(items) if i % pc == pi]


def allreduce_metrics(local_sums: np.ndarray, local_count: int) -> np.ndarray:
    """The sum of every process's ``local_sums`` over the sum of their
    counts (one all_reduce in float64); one process's mean without a group."""
    sums = np.asarray(local_sums)
    if not dist.is_initialized():
        return sums / max(local_count, 1)
    buf = torch.tensor(np.append(sums.astype(np.float64), float(local_count)),
                       dtype=torch.float64, device=_collective_device())
    dist.all_reduce(buf)
    total = buf.cpu().numpy()
    return (total[:-1] / max(total[-1], 1.0)).astype(sums.dtype)


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int):
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + t.numel() * t.element_size() > bucket_bytes:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel() * t.element_size()
    if bucket:
        yield bucket


def all_reduce_(tensors: Sequence[torch.Tensor], group=None,
                bucket_bytes: int = BUCKET_BYTES) -> int:
    """Sums each tensor over the group in place, through flat buckets of at
    most ``bucket_bytes`` (a larger tensor is a bucket of its own): one
    all_reduce a bucket, not one a tensor. The tensors share a dtype and a
    device; views may be strided. Returns the number of collectives."""
    n = 0
    for bucket in _buckets(tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(v.view(t.shape))
        n += 1
    return n


def block(t: torch.Tensor, axis: Optional[int], rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` along ``axis``, one of ``world`` equal
    blocks (a view); ``t`` itself when ``axis`` is None."""
    if axis is None:
        return t
    n = t.shape[axis] // world
    return t.narrow(axis, rank * n, n)


def all_gather_blocks_(tensors: Sequence[torch.Tensor], axes: Sequence[int], group=None,
                       bucket_bytes: int = BUCKET_BYTES) -> int:
    """Fills every rank's copy of each tensor with every rank's block of it
    (``block`` along its axis): bucket by bucket, rank r packs its blocks
    flat and broadcasts them, one broadcast a rank, so each rank sends its
    own blocks once (half the bytes of a zero-filled all_reduce between two
    ranks). The tensors share a dtype and a device. Returns the number of
    collectives."""
    world_size, me = dist.get_world_size(group), dist.get_rank(group)
    n = 0
    for bucket in _buckets(tensors, bucket_bytes):
        axes_b, axes = axes[:len(bucket)], axes[len(bucket):]
        for r in range(world_size):
            blocks = [block(t, a, r, world_size) for t, a in zip(bucket, axes_b)]
            if r == me:
                flat = torch.cat([b.reshape(-1) for b in blocks])
            else:
                flat = torch.empty(sum(b.numel() for b in blocks), dtype=bucket[0].dtype,
                                   device=bucket[0].device)
            src = r if group is None else dist.get_global_rank(group, r)
            dist.broadcast(flat, src=src, group=group)
            if r != me:
                for b, v in zip(blocks, flat.split([b.numel() for b in blocks])):
                    b.copy_(v.view(b.shape))
            n += 1
    return n


def all_gather_columns(y: torch.Tensor, axis: int, group) -> torch.Tensor:
    """Every rank's block of a layer's output along ``axis``, concatenated in
    rank order (the whole output on every rank of ``group``). NCCL: one
    ``all_gather_into_tensor``; gloo: one broadcast from each rank, of the
    bytes (gloo's CUDA broadcast then needs no support for the dtype). The
    blocks travel with ``axis`` last, which for a channels_last NCHW tensor
    is its memory order (no copy), and the result keeps that layout."""
    world_size, me = dist.get_world_size(group), dist.get_rank(group)
    y_last = y.movedim(axis, -1).contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((world_size,) + y_last.shape, dtype=y.dtype, device=y.device)
        dist.all_gather_into_tensor(out, y_last, group=group)
        parts = out.unbind(0)
    else:
        parts = []
        for r in range(world_size):
            buf = y_last if r == me else torch.empty_like(y_last)
            dist.broadcast(buf.view(torch.uint8), src=dist.get_global_rank(group, r),
                           group=group)
            parts.append(buf)
    return torch.cat(parts, dim=-1).movedim(-1, axis)


def _run_rank(process_id: int, module: str, argv: List[str], n: int, address: str) -> None:
    if "OMP_NUM_THREADS" not in os.environ:  # the host's cores shared, not each taken n times
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    importlib.import_module(module).main(argv + ["--num_processes", str(n), "--process_id",
                                                 str(process_id), "--coordinator_address",
                                                 address])


def launch_local(module: str, argv: Sequence[str], n: int) -> None:
    """Runs ``<module>.main(argv + the rank flags)`` in n processes on this
    host (the ``spawn`` start method, a free loopback port for rank 0, each
    with 1/n of the host's cores for its CPU work unless OMP_NUM_THREADS is
    set) and waits for them; when one fails the others are ended and it
    raises."""
    import torch.multiprocessing as mp

    mp.start_processes(_run_rank, args=(module, list(argv), n, f"127.0.0.1:{free_port()}"),
                       nprocs=n, join=True, start_method="spawn")
