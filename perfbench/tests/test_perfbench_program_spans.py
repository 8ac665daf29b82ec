"""The readers of the program's own spans and counters
(``program_spans.py``, ``metrics/unet_idle_share.*``,
``between_unet_idle_ms_per_image.sweep``, ``host_syncs_per_unet_call.*``)
on a synthetic record with made-up spans: idle under no span, gaps that cross
span boundaries, a span on another thread left out; None without the tracer,
without device time or without a UNet call; and on the CPU rehearsal of
every cell, traced, no reader raises and the new ones read nothing."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import harness, program_spans  # noqa: E402

NEW = ["unet_idle_share.sweep", "unet_idle_share.runner", "between_unet_idle_ms_per_image.sweep",
       "host_syncs_per_unet_call.sweep", "host_syncs_per_unet_call.runner"]
MAIN, WRITER = 11, 22
KERNELS = [(100.0, 110.0), (120.0, 130.0), (200.0, 260.0), (300.0, 305.0), (330.0, 340.0)]


def _span(i, parent, name, a, b, thread=MAIN):
    return {"id": i, "parent": parent, "name": name, "start_ns": int(a * 1000),
            "end_ns": int(b * 1000), "request": 0, "thread": thread, "attrs": {}}


SPANS = [_span(1, None, "pnpi.sweep.batch", 50, 320),
         _span(2, 1, "pnpi.sweep.edit", 90, 280),
         _span(3, 2, "pnpi.unet.call", 100, 140),
         _span(4, 2, "pnpi.unet.call", 190, 270),
         _span(5, None, "pnpi.sweep.saver_wait", 350, 380),
         _span(6, None, "pnpi.sweep.write_strip", 0, 500, WRITER)]
COUNTERS = {"pnpi.unet.calls": 2, "pnpi.unet.rows": 24, "pnpi.sync.timestep": 2,
            "pnpi.sync.images": 1}


def _run(busy=105.0, images=4):
    return {"profile": {"activity": {"busy_us": busy, "intervals": list(KERNELS)},
                        "images": images, "wall_s": 360e-6, "calls": 2}}


@pytest.fixture()
def traced(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: (SPANS, COUNTERS))
    program_spans._CACHE.clear()


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_idle_put_down_to_the_innermost_span(traced):
    s = program_spans.split(_run())
    # gaps 50-100 (batch 40, edit 10: a gap across a boundary), 110-120 (call),
    # 130-200 (call 10, edit 50, call 10), 260-300 (call, edit, batch), 305-330
    # (batch 15, none 10), 340-380 (none 10, saver_wait 30)
    assert s["by_span"] == pytest.approx({"pnpi.sweep.batch": 75.0, "pnpi.sweep.edit": 70.0,
                                          "pnpi.unet.call": 40.0, None: 20.0,
                                          "pnpi.sweep.saver_wait": 30.0})
    assert s["idle_us"] == pytest.approx(235.0)
    assert s["inside_unet_us"] == pytest.approx(40.0)
    assert s["outside_unet_us"] == pytest.approx(195.0)
    assert s["unet_us"] == pytest.approx(120.0) and s["window_us"] == pytest.approx(330.0)


def test_readers_arithmetic(traced):
    run = _run()
    for name in ("unet_idle_share.sweep", "unet_idle_share.runner"):
        assert _read(name, run) == pytest.approx(100.0 * 40 / 120)
    assert _read("between_unet_idle_ms_per_image.sweep", run) == pytest.approx(0.195 / 4)
    for name in ("host_syncs_per_unet_call.sweep", "host_syncs_per_unet_call.runner"):
        assert _read(name, run) == pytest.approx(1.5)
    note = harness.load_module("metrics", "between_unet_idle_ms_per_image.sweep").note(run)
    assert "under no span 8.51% of the idle" in note  # 20 of 235
    assert "pnpi.sync.timestep 2" in harness.load_module(
        "metrics", "host_syncs_per_unet_call.sweep").note(run)


def test_nesting_at_shared_boundaries():
    segs = program_spans.segments([(0.0, 10.0, "pnpi.a"), (0.0, 4.0, "pnpi.unet.call"),
                                   (4.0, 10.0, "pnpi.b"), (10.0, 12.0, "pnpi.c")])
    assert segs == [(0.0, 4.0, "pnpi.unet.call", True), (4.0, 10.0, "pnpi.b", False),
                    (10.0, 12.0, "pnpi.c", False)]
    assert program_spans.idle_gaps([(1.0, 3.0), (2.0, 5.0), (9.0, 20.0)], 0.0, 10.0) == \
        [(0.0, 1.0), (5.0, 9.0)]


def test_none_without_tracer_device_time_or_calls(monkeypatch):
    program_spans._CACHE.clear()
    monkeypatch.setattr(program_spans, "recorded", lambda: None)  # a program without it
    for name in NEW:
        assert _read(name, _run()) is None
        mod = harness.load_module("metrics", name)
        if hasattr(mod, "note"):
            assert "nothing to read" in mod.note(_run())
    monkeypatch.setattr(program_spans, "recorded", lambda: (SPANS, COUNTERS))
    for name in NEW:
        program_spans._CACHE.clear()
        assert _read(name, _run(busy=0.0)) is None  # no device time
        assert _read(name, {"profile": None}) is None  # no trace
    no_calls = [s for s in SPANS if s["name"] != "pnpi.unet.call"]
    monkeypatch.setattr(program_spans, "recorded", lambda: (no_calls, {"pnpi.sync.images": 1}))
    for name in NEW:
        program_spans._CACHE.clear()
        assert _read(name, _run()) is None


@pytest.mark.parametrize("cell", ["sd14.di-p2p.sweep-b4", "sd21.bld.sweep-b4",
                                  "sd14.di-p2p.runner-f32"])
def test_traced_rehearsal_reads_nothing_new_and_raises_nowhere(cell):
    from test_perfbench_rehearsal import rehearse

    result, rc, forbidden, err = rehearse(cell, "--trace", "1",
                                          *(["--batch", "1"] if "runner" in cell else []))
    assert rc == 0 and forbidden == [] and result["correct"] is True, err[-2000:]
    assert not set(NEW) & set(result["metrics"])
    assert "breakdown" in result
