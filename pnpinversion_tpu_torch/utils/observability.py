"""Structured run logs (port of ``pnpinversion_tpu/utils/observability.py``'s
``RunLogger``): one JSON object per event, appended to a JSONL file, one line
per write, so a log survives a crash and several processes may share one.
The JAX module's profiler hooks are TPU tooling and are not ported."""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional


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
