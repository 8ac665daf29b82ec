"""The readings that a cell's limits are set from, at the cell's own size, in
one process:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \\
        [--controls reference:fp8] [--control-seeds 1,2,3] [--out F]

For each seed one chunk of the cell's traffic (one batched call of the
cell's entry, at its batch, steps and sizes) runs through the program and
the check, as in a run of ``run.py``; it prints the numbers the check
compares (the lower readings). On the control seeds it also prints each
control's: ``reference:<precision>`` is the reference computed one precision
below the configuration's (``fp8``: every product's operands rounded to
float8 e4m3; ``tf32``: TF32 on) put in the program's place on the same
captured inputs. One JSON line per seed and candidate; a control must read
at least three times the program's largest reading on one number.
"""
import gc
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def one(cell: dict, seed: int, device, references=()) -> dict:
    """{candidate: numbers} of one chunk at ``seed``."""
    import importlib

    import torch

    from perfbench import harness
    from perfbench.reference import check as C
    from perfbench.reference import models

    mix = cell["mix"]
    tmp = tempfile.mkdtemp(prefix="perfbench-control-")
    try:
        ctx = {"config": cell["config"], "mix": mix, "seed": seed, "device": device,
               "items": mix["batch_per_device"], "tmp": tmp}
        driver = importlib.import_module(f"perfbench.drivers.{cell['driver']}").Driver(ctx)
        driver.prepare()
        method = harness.method(mix)
        driver.arm(0, method.calls_per_chunk(mix))
        driver.window()
        inputs = driver.check_inputs()
        driver.release()
        del driver
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = harness.build_reference(cell["config"], mix, seed, inputs["vocab"], device)
        real = len(inputs["items"])
        with torch.inference_mode():
            out = method.outputs(ref, inputs["calls"], inputs["vae"], inputs["items"],
                                 inputs["n"], mix, inputs["strips"])
            res = {"program": C.numbers(out["program"], out["reference"], real)}
            for precision in references:
                models.set_precision(precision)
                try:
                    ctl = method.outputs(ref, inputs["calls"], inputs["vae"], inputs["items"],
                                         inputs["n"], mix)
                finally:
                    models.set_precision("f32")
                res[f"reference:{precision}"] = C.numbers(ctl["reference"], out["reference"],
                                                          real)
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None, rehearsal=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from perfbench import harness

    harness.setup_env()
    import torch

    cell = harness.load_cell(args.workload)
    if rehearsal:
        cell["config"] = rehearsal.get("config", cell["config"])
        cell["mix"] = {**cell["mix"], **rehearsal.get("mix", {})}
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("perfbench: the control readings need a CUDA device", file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s] or seeds[:3]
    refs = tuple(c.split(":", 1)[1] for c in args.controls.split(",") if c)
    lines = []
    for seed in seeds:
        res = one(cell, seed, device, references=refs if seed in control_seeds else ())
        for cand, nums in res.items():
            line = {"workload": args.workload, "seed": seed, "candidate": cand, **nums}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
