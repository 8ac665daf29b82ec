"""Seconds and accuracy of the tensor-parallel axis (``--tp``,
``parallel/tensor_parallel.py``) on a host with several NVIDIA GPUs: one
process a GPU over NCCL (the backend the runners pick on the card), SD1.4 in
bf16 with random weights from seed 0.

Every rank holds the whole pipeline and, for each tp in ``--tp``, a copy split
over its tp group (``make_groups``: W / tp groups of tp ranks); it times one
UNet call at ``--rows`` rows (512^2 latents, seeded inputs) in bf16 and in
f32, whole and split (the median of ``--calls`` calls, each to a
synchronize, after a warm-up), counts the split call's gathers and the bytes
they gather, and compares the split call's eps with the whole one's on the
same inputs (f32: max |difference| over max |eps|; bf16: relative L2, beside
the whole call's own bf16-against-f32 distance), and the f32 gradient of
mean(eps^2) with respect to the inputs (the backward's gathers and
all-reduces) with the whole one's. Rank 0 prints the card's name and power
limit and one JSON object (also written to ``--out``).

    python3 scripts/time_torch_tp.py [--gpus 4] [--tp 2,4] [--rows 2] \\
        [--calls 5] [--out FILE]

``--device cpu --config tiny`` rehearses it on the host (gloo, TINY).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _time_calls(fn, calls: int) -> float:
    fn()
    times = []
    for _ in range(calls):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _rank(rank: int, world: int, address: str, spec: dict) -> None:
    from pnpinversion_tpu_torch import configs
    from pnpinversion_tpu_torch.parallel import multihost
    from pnpinversion_tpu_torch.parallel import tensor_parallel as tpar
    from pnpinversion_tpu_torch.pipeline import SDPipeline

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = multihost.rank_device(spec["device"], rank)
    multihost.initialize(address, world, rank, spec["backend"], device)
    config = configs.TINY if spec["config"] == "tiny" else configs.SD14
    gathers = {"calls": 0, "bytes": 0}
    gather = multihost.all_gather_columns

    def counted(y, axis, group):
        whole = gather(y, axis, group)
        gathers["calls"] += 1
        gathers["bytes"] += whole.numel() * whole.element_size()
        return whole

    multihost.all_gather_columns = counted
    g = torch.Generator().manual_seed(77)
    s = config.unet.sample_size
    x = torch.randn((spec["rows"], s, s, config.unet.in_channels), generator=g).to(device)
    ctx = torch.randn((spec["rows"], config.text.max_length, config.unet.context_dim),
                      generator=g).to(device)
    out = {"world": world, "rows": spec["rows"], "whole": {}, "split": {}}

    def input_grad(unet):
        """d mean(eps^2) / d (x, context) of an f32 call: the backward through
        the gathers and the input-gradient all-reduces."""
        xs, cs = x.clone().requires_grad_(True), ctx.clone().requires_grad_(True)
        unet(xs, 500, cs)[0].pow(2).mean().backward()
        return torch.cat([xs.grad.flatten(), cs.grad.flatten()])

    try:
        pipe = SDPipeline.create(config, seed=0, device=device)
        ref = {}
        with torch.inference_mode():
            for name, dt in (("bf16", pipe.dtype), ("f32", torch.float32)):
                call = lambda: pipe.unet(x.to(dt), 500, ctx.to(dt))[0]  # noqa: E731
                ref[name] = call().float()
                out["whole"][name] = {"s": _time_calls(call, spec["calls"])}
        out["whole"]["bf16_vs_f32_rel_l2"] = float(
            (ref["bf16"] - ref["f32"]).norm() / ref["f32"].norm())
        ref_grad = input_grad(pipe.unet)
        for tp in spec["tps"]:
            grid = tpar.make_groups(tp)
            split = SDPipeline.create(config, seed=0, device=device)
            tpar.shard_pipeline_(split, grid.tp_group)
            row = {}
            with torch.inference_mode():
                for name, dt in (("bf16", pipe.dtype), ("f32", torch.float32)):
                    call = lambda: split.unet(x.to(dt), 500, ctx.to(dt))[0]  # noqa: E731
                    before = dict(gathers)
                    eps = call().float()
                    row[name] = {"gathers": gathers["calls"] - before["calls"],
                                 "gathered_bytes": gathers["bytes"] - before["bytes"],
                                 "s": _time_calls(call, spec["calls"])}
                    diff = eps - ref[name]
                    row[name]["err"] = float(diff.abs().max() / ref[name].abs().max()
                                             if name == "f32" else diff.norm() / ref[name].norm())
            grad = input_grad(split.unet)
            row["f32_input_grad_err"] = float((grad - ref_grad).abs().max()
                                              / ref_grad.abs().max())
            out["split"][f"tp{tp}"] = row
            del split, grad
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        multihost.barrier()
    finally:
        multihost.shutdown()
    if rank == 0:
        with open(spec["result"], "w") as f:
            json.dump(out, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gpus", type=int, default=4, help="processes, one a GPU")
    ap.add_argument("--tp", default="2,4")
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="sd14", choices=["sd14", "tiny"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < args.gpus:
            print(f"time_torch_tp: needs {args.gpus} CUDA devices", file=sys.stderr)
            return 1
        import chip_smoke
        from pnpinversion_tpu_torch.ops import build
        from pnpinversion_tpu_torch.ops.flash_attention import F32_FWD_KERNEL, KERNEL

        print(chip_smoke.card_line(), flush=True)
        build.build([KERNEL, F32_FWD_KERNEL])  # once here; the ranks load them
    import tempfile

    import torch.multiprocessing as mp

    from pnpinversion_tpu_torch.parallel import multihost

    tps = [int(t) for t in args.tp.split(",") if args.gpus % int(t) == 0]
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        spec = {"device": args.device, "backend": "nccl" if args.device == "cuda" else "gloo",
                "config": args.config, "rows": args.rows, "calls": args.calls, "tps": tps,
                "result": os.path.join(tmp, "rank0.json")}
        mp.start_processes(_rank, args=(args.gpus, f"127.0.0.1:{multihost.free_port()}", spec),
                           nprocs=args.gpus, join=True, start_method="spawn")
        with open(spec["result"]) as f:
            out = json.load(f)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
