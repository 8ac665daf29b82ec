"""The batched PIE-Bench sweep over several processes, one per GPU (the port
of ``runners/run_sweep_sharded.py``), through ``torch.distributed``.

    # one host, N GPUs: N processes, started here
    python -m pnpinversion_tpu_torch.runners.run_sweep_sharded --method directinversion+p2p \\
        --data_path D --output_path O --n_devices N
    # one command per process (one per host, or per GPU), rank 0 at HOST:PORT
    python -m pnpinversion_tpu_torch.runners.run_sweep_sharded ... --num_processes 2 \\
        --process_id 0 --coordinator_address HOST:PORT [--dist_backend gloo]

Each process takes every ``num_processes``-th item of the mapping file
(``multihost.process_shard``) *before* the skip-existing filter, as the JAX
runner does, so an item stays on its process across restarts; then it edits
its pending items as ``runners/run_sweep.py`` does on one GPU
(``--batch_per_device`` images a call, 4 on the card for the light P2P
family), on ``cuda:<process_id % device_count>`` unless ``--device`` is
given. No process returns early: every one, even with nothing pending,
reaches the final reduction of the counts and logs ``sweep_done`` with the
total. A process builds its pipeline only when it has items to edit.

``--dist_backend`` is NCCL on the card by default; two processes on one GPU
need gloo (NCCL refuses two ranks on one device). ``--device cpu`` with
gloo runs the sweep on the host. ``--n_devices`` without
``--num_processes`` starts that many local processes (``spawn``); with
``--num_processes`` each process is one rank.

``--tp T`` (T dividing the W processes) is the JAX runner's tensor-parallel
axis (``parallel/tensor_parallel.py``): W / T groups of T ranks, each group's
ranks splitting the pipeline's layers by output columns and editing the same
images. The items are sharded over the dp index (the group), the batch is
``--batch_per_device`` images a group, so the images in flight scale with
W / T only, and only a group's tp index 0 writes the strips and the log; the
final reduction counts each image once. ``--tp`` with one process (on the
CPU too) raises.
"""
from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

import numpy as np

from pnpinversion_tpu_torch.cli import check_args
from pnpinversion_tpu_torch.parallel import multihost
from pnpinversion_tpu_torch.parallel.tensor_parallel import make_groups
from pnpinversion_tpu_torch.runners import run_sweep
from pnpinversion_tpu_torch.utils.observability import RunLogger


def add_process_args(parser) -> None:
    """The multi-process flags, shared with the training runner."""
    parser.add_argument("--n_devices", type=int, default=None,
                        help="local processes to start, one per GPU (without --num_processes)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel factor: ranks a group that splits the layers "
                             "by output columns (it must divide the processes)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="the number of processes of the run (ranks)")
    parser.add_argument("--process_id", type=int, default=None, help="this process's rank")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of rank 0")
    parser.add_argument("--dist_backend", type=str, default=None, choices=multihost.BACKENDS,
                        help="nccl (the default on the card) or gloo (the CPU, or several "
                             "ranks on one GPU)")


def check_process_args(args) -> bool:
    """Refuses a ``--tp`` that does not divide the processes (the flags', or
    the group's this process already belongs to; one process included);
    returns whether this call starts ``--n_devices`` local processes
    (``--n_devices`` > 1 without ``--num_processes``)."""
    world = args.num_processes or args.n_devices or multihost.world()
    if args.tp < 1 or world % args.tp:
        raise ValueError(f"--tp {args.tp} does not divide the {world} processes (--n_devices "
                         f"or --num_processes)")
    return args.num_processes is None and (args.n_devices or 1) > 1


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    """Returns {"images": this process's edits (its group's at tp index 0,
    0 at the others), "images_total": all groups', "batch", "rank",
    "world"}; None where it started local processes."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = run_sweep.sweep_argparser()
    add_process_args(parser)
    args = parser.parse_args(argv)
    check_args(args)
    if check_process_args(args):
        multihost.launch_local("pnpinversion_tpu_torch.runners.run_sweep_sharded", argv,
                               args.n_devices)
        return None
    method = args.method
    device = multihost.rank_device(args.device, args.process_id or 0)
    owned = multihost.initialize(args.coordinator_address, args.num_processes, args.process_id,
                                 args.dist_backend, device)
    try:
        rank, world = multihost.rank(), multihost.world()
        grid = make_groups(args.tp)
        writer = grid.tp_index == 0  # a group's first rank writes its strips and the log
        logger = RunLogger(args.run_log if writer else None)
        items = multihost.process_shard(run_sweep.sweep_items(args), grid.dp_index, grid.dp)
        pending = run_sweep.pending_items(args, method, logger, items)
        batch = 0
        if pending:
            pipe = run_sweep.sweep_pipeline(args, method, device)
            batch = run_sweep.run_sweep(args, method, pipe, pending, logger, grid.tp_group,
                                        write=writer)
            del pipe
        else:
            print("nothing to do", flush=True)
        # every process reaches this collective, with or without work; a
        # group's images count once
        edited = len(pending) if writer else 0
        mean = multihost.allreduce_metrics(np.array([float(edited)]), 1)
        total = int(round(float(mean[0]) * world))
        logger.log("sweep_done", images_total=total, images=edited, method=method,
                   process_index=rank, process_count=world)
        print(json.dumps({"sweep_done": total, "images": edited, "batch": batch,
                          "rank": rank, "world": world}), flush=True)
        return {"images": edited, "images_total": total, "batch": batch, "rank": rank,
                "world": world}
    finally:
        if owned:
            multihost.shutdown()


if __name__ == "__main__":
    main()
