"""Structured run logs and the program's own tracer.

``RunLogger`` (port of ``pnpinversion_tpu/utils/observability.py``'s): one
JSON object per event, appended to a JSONL file, one line per write, so a log
survives a crash and several processes may share one.

The tracer: ``span(name, request=None, **attrs)`` around a stage and
``count(name, n=1)`` at an event, named ``pnpi.<layer>.<stage>``. It records
only while a ``torch.profiler`` records on the calling thread (one flag
check, ``torch._C._autograd._profiler_enabled()``); otherwise ``span``
returns a shared null context and ``count`` returns at once: nothing is
recorded, no ``record_function`` is entered and nothing is allocated
(a hot caller checks ``tracing()`` once and enters ``NULL`` itself). There
is no flag of its own: run the program under ``torch.profiler.profile``
(``--profile_dir`` of the runners, or the caller's own profile) to turn it
on. While on, each span keeps its name, its start and end in
``time.time_ns()`` (the profiler's clock: kineto's events carry Unix-epoch
ns), the id of the span it opened under, a request id (the sweep's chunk
index, the runner's image key; a span without one takes its parent's), the
thread and its attributes, and opens a ``record_function`` of the same name,
so the span also stands in the profiler's timeline and chrome trace.
Counters count only while on. Both stay in memory, the spans in a bounded
buffer, until ``spans()``, ``counters()`` and ``reset()`` read or clear them,
or ``write(path, since_ns, before)`` puts them in a JSON file (``--profile_dir``
writes one beside its chrome trace). The profiler follows only the thread
that started it: work handed to another thread passes ``traced=tracing()``,
read where it was handed over; such a span has no mirror in the profiler's
timeline and stands only in the tracer's buffer.

``host_sync(site, device)`` counts ``pnpi.sync.<site>``, a copy between the
host and a CUDA device that makes the host wait for the stream.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

CAPACITY = 1 << 16  # spans kept; the oldest go first
_profiling = torch._C._autograd._profiler_enabled

_lock = threading.Lock()
_spans: collections.deque = collections.deque(maxlen=CAPACITY)
_counters: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


class RunLogger:
    """Appends events to ``path``; with no path it writes nothing."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **fields: Any) -> None:
        if not self.path:
            return
        rec: Dict[str, Any] = {"ts": time.time(), "event": event}
        rec.update(fields)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    @contextlib.contextmanager
    def image(self, key: str, method: str) -> Iterator[None]:
        """Logs the start, the end (with seconds) or the error of one image."""
        t0 = time.perf_counter()
        self.log("image_start", key=key, method=method)
        try:
            yield
        except Exception as e:  # recorded, then re-raised
            self.log("image_error", key=key, method=method, error=repr(e),
                     seconds=round(time.perf_counter() - t0, 4))
            raise
        self.log("image_done", key=key, method=method,
                 seconds=round(time.perf_counter() - t0, 4))


NULL = contextlib.nullcontext()  # reusable: the one context of every span while off


def tracing() -> bool:
    """True while a profiler records on this thread."""
    return _profiling()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "request", "attrs", "id", "parent", "start", "_rec")

    def __init__(self, name: str, request, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.request is None and parent is not None:
            self.request = parent.request
        self.id = next(_ids)
        self._rec = None
        self.start = time.time_ns()  # read first: the span holds its mirror
        if _profiling():  # the mirror in the profiler's timeline
            self._rec = torch.profiler.record_function(self.name)
            self._rec.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        rec = {"id": self.id, "parent": self.parent, "name": self.name,
               "start_ns": self.start, "end_ns": end, "request": self.request,
               "thread": threading.get_ident(), "attrs": self.attrs}
        with _lock:
            _spans.append(rec)
        return False


def span(name: str, request=None, traced: Optional[bool] = None, **attrs):
    """A context manager that records the block as a span while tracing is
    on (``traced``, where given, in place of this thread's own check), and
    is a shared null context otherwise."""
    if not (_profiling() if traced is None else traced):
        return NULL
    return _Span(name, request, attrs)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name`` while tracing is on."""
    if not _profiling():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def host_sync(site: str, device) -> None:
    """Counts ``pnpi.sync.<site>`` while tracing is on, where ``device`` (the
    far end of a copy the host waits for) is a CUDA device."""
    if _profiling() and torch.device(device).type == "cuda":
        count("pnpi.sync." + site)


def spans() -> List[dict]:
    """The recorded spans, by start: each {id, parent, name, start_ns, end_ns,
    request, thread, attrs}."""
    with _lock:
        out = list(_spans)
    return sorted(out, key=lambda s: (s["start_ns"], s["id"]))


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def write(path: str, since_ns: int = 0, before: Optional[Dict[str, int]] = None) -> None:
    """Writes {"spans": the spans that started at ``since_ns`` or later,
    "counters": what each counter gained since ``before`` (an earlier
    ``counters()``)} to ``path`` as JSON."""
    before = before or {}
    gained = {k: v - before.get(k, 0) for k, v in counters().items() if v != before.get(k, 0)}
    with open(path, "w") as f:
        json.dump({"spans": [s for s in spans() if s["start_ns"] >= since_ns],
                   "counters": gained}, f)


def reset() -> None:
    """Clears the spans and the counters."""
    with _lock:
        _spans.clear()
        _counters.clear()
