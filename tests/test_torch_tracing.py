"""The port's tracer (``utils/observability.py``) on the CPU at TINY: with no
profiler recording, a sweep records nothing and enters no
``record_function``; under ``torch.profiler`` a P2P and a BLD sweep give one
``pnpi.sweep.batch`` span per chunk with its stages in order, the editor
stages and UNet calls under them, the strip writer's span on its own thread
under its chunk's request id, the UNet counters the benchmark's probe reads,
and spans on the profiler's own clock; the per-image runner gives its image's
span over the editor stages; ``--profile_dir`` traces the sweep's first
chunk and writes its spans and counters beside the trace."""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from pnpinversion_tpu_torch.configs import TINY  # noqa: E402
from pnpinversion_tpu_torch.data.pie_bench import mask_encode  # noqa: E402
from pnpinversion_tpu_torch.pipeline import SDPipeline  # noqa: E402
from pnpinversion_tpu_torch.utils import observability as obs  # noqa: E402

STEPS = 2
PROMPTS = [("a cat sitting on a mat", "a dog sitting on a mat", "cat dog"),
           ("a red car on the road", "a blue car on the road", "red blue")]
SWEEP_STAGES = ["pnpi.sweep.load_images", "pnpi.sweep.encode_prompts", "pnpi.sweep.edit"]


def _dataset(root, n: int) -> str:
    """A PIE-Bench mapping of n seeded PNG images, every item with blend words."""
    rng = np.random.RandomState(0)
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "annotation_images", "0_random"))
    mapping = {}
    for i in range(n):
        rel = f"0_random/{i:06d}.png"
        Image.fromarray((rng.rand(24, 24, 3) * 255).astype(np.uint8)).save(
            os.path.join(data, "annotation_images", rel))
        mask = np.zeros((512, 512), np.uint8)
        mask[128:384, 96:320] = 1
        src, tar, blend = PROMPTS[i % len(PROMPTS)]
        mapping[f"{i:06d}"] = {"image_path": rel, "original_prompt": src,
                               "editing_prompt": tar, "editing_instruction": "make it so",
                               "editing_type_id": "0", "blended_word": blend,
                               "mask": mask_encode(mask)}
    with open(os.path.join(data, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)
    return data


_PIPE = {}


def _pipe():
    if "tiny" not in _PIPE:
        _PIPE["tiny"] = _ORIG_CREATE(SDPipeline, TINY, num_ddim_steps=STEPS, device="cpu",
                                     dtype=torch.float32)
    return _PIPE["tiny"]


_ORIG_CREATE = SDPipeline.create.__func__


def _sweep(root, method: str, n: int = 3, batch: int = 2, profiled: bool = True):
    """A tiny ``run_sweep`` as ``perfbench/drivers/run_sweep.py`` calls it, with the
    benchmark's UNet probe on; returns (spans, counters, probe, images)."""
    from perfbench.harness import UnetProbe
    from pnpinversion_tpu_torch.runners.run_sweep import pending_items, run_sweep, sweep_argparser
    from pnpinversion_tpu_torch.utils.observability import RunLogger

    data = _dataset(str(root), n)
    args = sweep_argparser().parse_args([
        "--method", method, "--batch_per_device", str(batch), "--data_path", data,
        "--output_path", os.path.join(str(root), "out"), "--num_ddim_steps", str(STEPS),
        "--device", "cpu"])
    pipe = _pipe()
    probe = UnetProbe(pipe.unet)
    obs.reset()
    try:
        logger = RunLogger(None)
        if profiled:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                run_sweep(args, method, pipe, pending_items(args, method, logger), logger)
        else:
            prof = None
            run_sweep(args, method, pipe, pending_items(args, method, logger), logger)
    finally:
        probe.remove()
    return {"spans": obs.spans(), "counters": obs.counters(), "probe": probe.summary(),
            "images": n, "prof": prof}


@pytest.fixture(scope="module")
def p2p_run(tmp_path_factory):
    return _sweep(tmp_path_factory.mktemp("p2p"), "directinversion+p2p")


@pytest.fixture(scope="module")
def bld_run(tmp_path_factory):
    return _sweep(tmp_path_factory.mktemp("bld"), "blended-latent-diffusion")


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


def _descendants(spans, parent):
    out, frontier = [], [parent["id"]]
    while frontier:
        kids = [s for s in spans if s["parent"] in frontier]
        out += kids
        frontier = [s["id"] for s in kids]
    return out


# ---------------------------------------------------------------- the tracer


def test_off_records_nothing_and_enters_no_record_function(tmp_path, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with the profiler off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert obs.span("pnpi.x") is obs.span("pnpi.y", request=3, rows=2)  # the shared null
    run = _sweep(tmp_path, "directinversion+p2p", n=2, profiled=False)
    assert run["probe"]["calls"] > 0
    assert run["spans"] == [] and run["counters"] == {}


def test_span_tree_request_and_counters_by_hand():
    obs.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs.span("pnpi.a", request="k1", size=3):
            with obs.span("pnpi.b"):
                obs.count("pnpi.n")
                obs.count("pnpi.n", 4)
                obs.host_sync("site", "cpu")  # no CUDA device: not a host wait
        with obs.span("pnpi.c", request=7):
            pass
    a, b, c = obs.spans()
    assert [s["name"] for s in (a, b, c)] == ["pnpi.a", "pnpi.b", "pnpi.c"]
    assert a["parent"] is None and b["parent"] == a["id"] and c["parent"] is None
    assert (a["request"], b["request"], c["request"]) == ("k1", "k1", 7)
    assert a["attrs"] == {"size": 3} and a["start_ns"] <= b["start_ns"] <= b["end_ns"] <= a["end_ns"]
    assert obs.counters() == {"pnpi.n": 5}
    obs.count("pnpi.n")  # the profiler is off again
    assert obs.counters() == {"pnpi.n": 5}
    obs.reset()
    assert obs.spans() == [] and obs.counters() == {}


def test_buffer_is_bounded_and_threads_are_safe(monkeypatch):
    """Sixteen threads, switching every microsecond: no count and no span id
    is lost, each thread nests its own spans, and the buffer keeps
    the newest ``maxlen``."""
    from collections import deque

    threads, each = 16, 200
    monkeypatch.setattr(obs, "_spans", deque(maxlen=threads * each))
    monkeypatch.setattr(obs, "_profiling", lambda: True)
    obs.reset()

    def work(i):
        for _ in range(each // 2):
            with obs.span("pnpi.outer", request=i):
                with obs.span("pnpi.inner"):
                    obs.count("pnpi.n")
                obs.count("pnpi.n", 2)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    got = obs.spans()
    assert obs.counters() == {"pnpi.n": threads * each // 2 * 3}
    assert len(got) == threads * each and len({s["id"] for s in got}) == len(got)
    outer = {s["id"]: s for s in got if s["name"] == "pnpi.outer"}
    inner = [s for s in got if s["name"] == "pnpi.inner"]
    assert all(s["parent"] is None for s in outer.values())
    assert all(outer[s["parent"]]["thread"] == s["thread"]
               and outer[s["parent"]]["request"] == s["request"] for s in inner)
    with obs.span("pnpi.last"):
        pass
    assert len(obs.spans()) == threads * each and obs.spans()[-1]["name"] == "pnpi.last"


# ------------------------------------------------------------- the sweeps


@pytest.mark.parametrize("which", ["p2p", "bld"])
def test_sweep_batches_and_their_stages(which, request):
    run = request.getfixturevalue(f"{which}_run")
    spans = run["spans"]
    main = threading.get_ident()
    batches = [s for s in spans if s["name"] == "pnpi.sweep.batch"]
    assert [(b["attrs"]["index"], b["attrs"]["images"], b["request"]) for b in batches] == \
        [(0, 2, 0), (1, 1, 1)]
    for b in batches:
        kids = [s["name"] for s in _children(spans, b)]
        wait = ["pnpi.sweep.saver_wait"] if b["attrs"]["index"] else []
        assert kids == SWEEP_STAGES + wait, kids
        below = _descendants(spans, b)
        assert all(s["request"] == b["request"] and s["thread"] == main for s in below)
        names = {s["name"] for s in below}
        stages = {"pnpi.edit.vae_encode", "pnpi.edit.sample", "pnpi.edit.vae_decode",
                  "pnpi.edit.to_host", "pnpi.unet.call"}
        if which == "p2p":
            stages.add("pnpi.edit.invert")
        assert stages <= names, names
        edit = next(s for s in _children(spans, b) if s["name"] == "pnpi.sweep.edit")
        calls = [s for s in below if s["name"] == "pnpi.unet.call"]
        assert all(edit["start_ns"] <= s["start_ns"] <= s["end_ns"] <= edit["end_ns"]
                   for s in calls)
    tops = [s["name"] for s in spans if s["parent"] is None and s["thread"] == main]
    assert tops[0] == "pnpi.sweep.prepare" and tops[-1] == "pnpi.sweep.saver_wait"
    assert tops.count("pnpi.sweep.batch") == 2


@pytest.mark.parametrize("which", ["p2p", "bld"])
def test_unet_counters_match_the_benchmark_probe(which, request):
    run = request.getfixturevalue(f"{which}_run")
    c, probe = run["counters"], run["probe"]
    assert c["pnpi.unet.calls"] == probe["calls"] > 0
    calls = [s for s in run["spans"] if s["name"] == "pnpi.unet.call"]
    assert len(calls) == probe["calls"]
    assert sum(s["attrs"]["rows"] for s in calls) == c["pnpi.unet.rows"]
    # the benchmark's unet_rows_per_image arithmetic
    assert c["pnpi.unet.rows"] / run["images"] == probe["rows"] / run["images"]
    assert not [k for k in c if k.startswith("pnpi.sync.")]  # no CUDA device, no host wait


def test_writer_thread_span_carries_its_chunk(p2p_run):
    spans = p2p_run["spans"]
    writes = [s for s in spans if s["name"] == "pnpi.sweep.write_strip"]
    assert sorted(s["request"] for s in writes) == [0, 1]
    assert {s["attrs"]["images"] for s in writes} == {2, 1}
    assert all(s["thread"] != threading.get_ident() and s["parent"] is None for s in writes)
    waits = [s for s in spans if s["name"] == "pnpi.sweep.saver_wait"]
    assert len(waits) == 2  # batch 1's hand-off and the close


def test_spans_share_the_profilers_clock(p2p_run):
    """Every span on the profiled thread holds its ``record_function`` mirror
    in the profiler's events (its start read before the mirror's, its end
    after: the two clocks agree to the microsecond), and the starts lie
    within 50 µs of each other in the median (entering a ``record_function``
    takes 5-60 µs on this kind of host, more when the thread is switched
    out between the two reads)."""
    mirrors = {}
    for e in p2p_run["prof"].profiler.kineto_results.events():
        if e.name().startswith("pnpi."):
            mirrors.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    main = threading.get_ident()
    ours = {}
    for s in p2p_run["spans"]:
        if s["thread"] == main:
            ours.setdefault(s["name"], []).append((s["start_ns"], s["end_ns"]))
    assert set(ours) == set(mirrors) and "pnpi.unet.call" in ours
    gaps = []
    for name, spans in ours.items():
        assert len(spans) == len(mirrors[name]), name
        for (a, z), (ma, mz) in zip(sorted(spans), sorted(mirrors[name])):
            assert a - 2_000 <= ma <= mz <= z + 2_000, (name, ma - a, z - mz)
            gaps.append(ma - a)
    assert np.median(gaps) < 50_000, gaps


# ------------------------------------------------------- runner and profile_dir


def test_runner_image_span_over_the_editor_stages(tmp_path):
    from pnpinversion_tpu_torch.cli import run_benchmark, standard_argparser
    from pnpinversion_tpu_torch.editors.p2p_editor import P2PEditor
    from pnpinversion_tpu_torch.runners import run_editing_p2p as runner

    data = _dataset(str(tmp_path), 1)
    args = standard_argparser(["directinversion+p2p"]).parse_args([
        "--data_path", data, "--output_path", str(tmp_path / "out"),
        "--num_ddim_steps", str(STEPS), "--device", "cpu"])
    editor = P2PEditor(_pipe())
    obs.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run_benchmark(args, lambda m, item: editor(m, image_path=item.image_path,
                                                   **runner.edit_kwargs(item)),
                      runner.IMAGE_SAVE_PATHS)
    spans = obs.spans()
    image = next(s for s in spans if s["name"] == "pnpi.runner.image")
    assert image["request"] == "000000" and image["parent"] is None
    kids = [s["name"] for s in _children(spans, image)]
    assert kids == ["pnpi.edit.vae_encode", "pnpi.edit.invert", "pnpi.edit.sample",
                    "pnpi.edit.vae_decode", "pnpi.edit.to_host"], kids
    below = _descendants(spans, image)
    assert all(s["request"] == "000000" for s in below)
    assert sum(s["name"] == "pnpi.unet.call" for s in below) == 2 * STEPS
    save = next(s for s in spans if s["name"] == "pnpi.runner.save_strip")
    assert save["parent"] is None and save["start_ns"] >= image["end_ns"]


def test_sweep_profile_dir_traces_the_first_chunk(tmp_path, monkeypatch):
    from pnpinversion_tpu_torch.runners import run_sweep

    monkeypatch.setattr(SDPipeline, "create", classmethod(lambda cls, *a, **kw: _pipe()))
    data = _dataset(str(tmp_path), 3)
    trace_dir = str(tmp_path / "trace")
    done = run_sweep.main(["--data_path", data, "--output_path", str(tmp_path / "out"),
                           "--batch_per_device", "2", "--num_ddim_steps", str(STEPS),
                           "--device", "cpu", "--profile_dir", trace_dir])
    assert done == {"images": 3, "batch": 2}
    assert sorted(os.listdir(trace_dir)) == [f"spans_{os.getpid()}.json",
                                             f"trace_{os.getpid()}.json"]
    with open(os.path.join(trace_dir, f"trace_{os.getpid()}.json")) as f:
        events = json.load(f)["traceEvents"]
    batches = [e for e in events if e.get("name") == "pnpi.sweep.batch"]
    assert len(batches) == 1  # the first chunk only
    assert any(e.get("name") == "pnpi.unet.call" for e in events)
    # the spans file: the first chunk's spans, its strip writer's among them, and its counters
    with open(os.path.join(trace_dir, f"spans_{os.getpid()}.json")) as f:
        got = json.load(f)
    spans, c = got["spans"], got["counters"]
    assert [s["request"] for s in spans if s["name"] == "pnpi.sweep.batch"] == [0]
    (write,) = [s for s in spans if s["name"] == "pnpi.sweep.write_strip"]
    assert write["request"] == 0 and write["attrs"] == {"images": 2}
    assert write["thread"] != threading.get_ident()
    calls = [s for s in spans if s["name"] == "pnpi.unet.call"]
    assert c["pnpi.unet.calls"] == len(calls) > 0
    assert c["pnpi.unet.rows"] == sum(s["attrs"]["rows"] for s in calls)
