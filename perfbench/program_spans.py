"""The program's own spans and counters over the profiled batch
(``pnpinversion_tpu_torch.utils.observability``: ``spans()``, ``counters()``;
they record only while a profiler does, so they hold the profiled batch
alone), set against the batch's device intervals
(``run["profile"]["activity"]["intervals"]``: kineto µs, Unix-epoch ns over
1000, the spans' own clock). Every stretch with no kernel running is put down
to the innermost ``pnpi.*`` span open on the main thread (the one that makes
the UNet calls) at that instant. A program without the tracer, a run without
a trace, without device time or without a UNet call reads None.
"""
from __future__ import annotations

from perfbench import readers

UNET = "pnpi.unet.call"
SYNC = "pnpi.sync."

_CACHE: dict = {}


def recorded():
    """(spans, counters) the program recorded, or None where it has no tracer."""
    try:
        from pnpinversion_tpu_torch.utils import observability as obs
    except ImportError:
        return None
    if not (hasattr(obs, "spans") and hasattr(obs, "counters")):
        return None
    return obs.spans(), obs.counters()


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] with no interval running, sorted."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if hi > end:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def segments(spans) -> list:
    """One thread's spans (properly nested, µs) cut at their boundaries:
    [(start, end, innermost name or None, inside a UNet call)], contiguous
    from the first span's start to the last one's end."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, t = [], [], spans[0][0] if spans else 0.0

    def emit(to):
        nonlocal t
        if to > t:
            out.append((t, to, stack[-1][2] if stack else None,
                        any(s[2] == UNET for s in stack)))
        t = max(t, to)

    for s in spans:
        while stack and stack[-1][1] <= s[0]:
            emit(stack[-1][1])
            stack.pop()
        emit(s[0])
        stack.append(s)
    while stack:
        emit(stack[-1][1])
        stack.pop()
    return out


def attribute(gaps, segs) -> dict:
    """Idle µs by innermost span (None: under no span), inside and outside
    the UNet calls; the UNet calls' own µs; the window's µs."""
    by_span, inside, outside, j = {}, 0.0, 0.0, 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, name, in_unet = segs[k]
            us = min(b, s1) - max(a, s0)
            if us > 0:
                by_span[name] = by_span.get(name, 0.0) + us
                if in_unet:
                    inside += us
                else:
                    outside += us
            k += 1
    return {"by_span": by_span, "inside_unet_us": inside, "outside_unet_us": outside,
            "idle_us": sum(b - a for a, b in gaps),
            "unet_us": sum(s[1] - s[0] for s in segs if s[3]),
            "window_us": (segs[-1][1] - segs[0][0]) if segs else 0.0}


def split(run):
    """``attribute`` over the profiled batch's main thread, or None."""
    act = readers.activity(run)
    if act is None:
        return None
    if _CACHE.get("profile") is not run["profile"]:  # one split a run, for every reader
        _CACHE.update(profile=run["profile"], split=_split(act))
    return _CACHE["split"]


def _split(act):
    got = recorded()
    if got is None:
        return None
    spans, _ = got
    main = next((s["thread"] for s in spans if s["name"] == UNET), None)
    if main is None:
        return None
    mine = [(s["start_ns"] * 1e-3, s["end_ns"] * 1e-3, s["name"]) for s in spans
            if s["thread"] == main and s["name"].startswith("pnpi.")]
    segs = segments(mine)
    return attribute(idle_gaps(act["intervals"], segs[0][0], segs[-1][1]), segs)


def unet_idle_share(run):
    """100 x the idle time inside UNet calls over their time."""
    s = split(run)
    if s is None or s["unet_us"] <= 0:
        return None
    return 100.0 * s["inside_unet_us"] / s["unet_us"]


def between_unet_idle_ms_per_image(run):
    s = split(run)
    if s is None or not run["profile"]["images"]:
        return None
    return s["outside_unet_us"] * 1e-3 / run["profile"]["images"]


def idle_note(run, name: str) -> str:
    """The coverage of the split: idle under no span, and inside plus outside
    the UNet calls against the traced idle (the profiled batch's wall less
    its busy time)."""
    s = split(run)
    if s is None:
        return f"{name}: nothing to read"
    act, idle = run["profile"]["activity"], s["idle_us"]
    traced = max(run["profile"]["wall_s"] * 1e6 - act["busy_us"], 1e-9)
    top = sorted(s["by_span"].items(), key=lambda kv: -kv[1])[:8]
    return (f"{name}: idle {idle * 1e-3:.3f} ms over the spans' {s['window_us'] * 1e-3:.3f} ms; "
            f"inside UNet calls {s['inside_unet_us'] * 1e-3:.3f} ms, outside "
            f"{s['outside_unet_us'] * 1e-3:.3f} ms, together {100.0 * idle / traced:.2f}% of "
            f"the traced idle {traced * 1e-3:.3f} ms; under no span "
            f"{100.0 * s['by_span'].get(None, 0.0) / max(idle, 1e-9):.2f}% of the idle; by span "
            + ", ".join(f"{k or 'none'} {v * 1e-3:.3f}" for k, v in top))


def host_syncs_per_unet_call(run):
    """The ``pnpi.sync.*`` counters' sum over ``pnpi.unet.calls``."""
    if readers.activity(run) is None:
        return None
    got = recorded()
    if got is None:
        return None
    counters = got[1]
    calls = counters.get("pnpi.unet.calls", 0)
    if not calls:
        return None
    return sum(v for k, v in counters.items() if k.startswith(SYNC)) / calls


def syncs_note(run, name: str) -> str:
    got = recorded() if readers.activity(run) is not None else None
    if got is None or not got[1].get("pnpi.unet.calls"):
        return f"{name}: nothing to read"
    c = got[1]
    return (f"{name}: {c['pnpi.unet.calls']} UNet calls, "
            + ", ".join(f"{k} {v}" for k, v in sorted(c.items()) if k.startswith(SYNC)))
