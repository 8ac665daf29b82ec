"""The benchmark's one command:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of BENCHMARK.json on the CUDA devices of this machine:
set-up (the seeded data under ``$TMPDIR``, the program's pipeline with the
benchmark's seeded weights, a warm-up batch), the measured window (one call of
the program's entry over a fixed number of items: ``seconds`` over the mix's
``nominal_batch_s``, at least two batches), with ``--trace 1`` one more batch
under torch.profiler, then the check against the plain reference. The last
line of standard output is the result as one JSON object; the numbers the
check compared, each beside its limit, are the last lines of standard error
and the result's last key. Without the CUDA devices the cell asks for it
prints no result and exits 2.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def profile_batch(torch, driver, device) -> dict:
    """One more batch under torch.profiler (host and device activity), with
    the benchmark's spans around each UNet call."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import device_trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    driver.probe.reset(spans=True)
    with profile(activities=acts) as prof:
        with record_function("perfbench.profiled_batch"):
            t0 = time.perf_counter()
            images = driver.profiled_batch()
            _sync(torch, device)
            wall = time.perf_counter() - t0
    calls = driver.probe.calls
    dev, host = device_trace.trace_spans(prof)
    activity = device_trace.device_activity(dev)
    span = next(((s, e) for n, s, e in host if n == "perfbench.profiled_batch"), None)
    gaps = device_trace.idle_gaps(activity["intervals"], host, span) if span else []
    return {"wall_s": wall, "images": images, "calls": calls, "activity": activity,
            "gaps": gaps}


def check(torch, cell, inputs, seed, device) -> dict:
    """The compared numbers of the program against the reference."""
    from perfbench import harness
    from perfbench.reference import check as C

    mix = cell["mix"]
    ref = harness.build_reference(cell["config"], mix, seed, inputs["vocab"], device)
    with torch.inference_mode():
        out = harness.method(mix).outputs(ref, inputs["calls"], inputs["vae"], inputs["items"],
                                          inputs["n"], mix, inputs["strips"])
        return C.numbers(out["program"], out["reference"], len(inputs["items"]))


def main(argv=None, rehearsal=None) -> int:
    """``rehearsal`` (tests only): {"device": "cpu", "config": {...}, "mix": {...}}
    overrides that drive a run without a card at a small size."""
    args = parse(argv)
    from perfbench import harness

    harness.setup_env()
    import numpy as np
    import torch

    cell = harness.load_cell(args.workload)
    chips = cell["cell"]["chips"]
    if rehearsal:
        cell["config"] = rehearsal.get("config", cell["config"])
        cell["mix"] = {**cell["mix"], **rehearsal.get("mix", {})}
        device = torch.device(rehearsal.get("device", "cpu"))
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    mix = cell["mix"]
    batch = mix["batch_per_device"]
    batches = max(2, int(round(args.seconds / mix["nominal_batch_s"])))
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        ctx = {"config": cell["config"], "mix": mix, "seed": args.seed, "device": device,
               "items": batch * batches, "tmp": tmp}
        driver = importlib.import_module(f"perfbench.drivers.{cell['driver']}").Driver(ctx)
        driver.prepare()
        driver.warmup()
        chunk = int(np.random.default_rng([args.seed, 7]).integers(batches))
        driver.arm(chunk, harness.method(mix).calls_per_chunk(mix))
        _sync(torch, device)
        t_window = time.perf_counter()
        setup_s = t_window - T0
        result = driver.window()
        _sync(torch, device)
        window_s = time.perf_counter() - t_window
        probe = driver.probe.summary()
        inputs = driver.check_inputs()
        prof = profile_batch(torch, driver, device) if args.trace else None
        cuda = device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        driver.release()
        del driver
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        try:
            numbers = check(torch, cell, inputs, args.seed, device)
            note = None
        except Exception:  # noqa: BLE001 - a check that cannot run is a failed check
            numbers, note = {}, traceback.format_exc(limit=4)
        limits = (cell["limits"] or {}).get("numbers", {})
        missing = result["attempted"] - result["images"]
        checked = {k: [numbers.get(k), v["limit"]] for k, v in limits.items()}
        checked["strips_missing"] = [missing, 0]
        correct = (note is None and bool(limits)
                   and all(v is not None and v <= lim for v, lim in checked.values()))
        run = {"cell": cell, "mix": mix, "work": cell["work"] or {}, "window_s": window_s,
               "images": result["images"], "batch_images": batch, "probe": probe,
               "profile": prof, "peak_bytes": peak, "setup_s": setup_s}
        metrics = {}
        if args.trace:
            for m in cell["per_layer"]:
                reader = harness.load_module("metrics", m["name"])
                value = reader.read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                if hasattr(reader, "note"):
                    print(reader.note(run))
        else:
            e2e = {"setup_s": setup_s,
                   "sweep_images_per_s": result["images"] / window_s,
                   "runner_s_per_image": window_s / max(result["images"], 1)}
            for m in cell["end_to_end"]:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else device.type,
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": chips, "memory_peak_bytes": peak,
               "power_limit_w": power_limit() if cuda else None}
        line = {"correct": correct, "attempted": result["attempted"], "failed": missing,
                "metrics": metrics, "device": dev}
        if prof:
            act = prof["activity"]
            dev.update(busy_s=act["busy_us"] * 1e-6, window_s=prof["wall_s"])
            top = sorted(act["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
            line["breakdown"] = {"device_ops": [[n[:120], r[0] * 1e-6] for n, r in top],
                                 "idle_gaps": [[n, s] for n, s in prof["gaps"]]}
        line["checked"] = checked
        if note:
            print(note, file=sys.stderr)
        bad = harness.forbidden_modules(sys.modules)
        if bad:  # after the check and every reader: nothing loads later
            print(f"perfbench: loaded in the measuring process: {', '.join(bad)}",
                  file=sys.stderr)
            return 3
        for k, (v, lim) in checked.items():
            print(f"{k} {v} limit {lim}", file=sys.stderr)
        print(json.dumps(line))
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
