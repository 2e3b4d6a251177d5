"""Structured JSONL metrics stream + stdlib logging (SURVEY.md §5.5; a copy
of cloudvectordb_tpu/utils/metrics.py, which imports no JAX), and the
port's spans.

No external service dependencies: the environment is offline, so observability
is a local ``metrics.jsonl`` (one JSON object per event) plus python logging.

Spans (``span``) mark the layers of the search path and the pipeline's
stages on ``torch.profiler``'s own timeline. They are live only while a
profiler records: then each one opens a host span of its name (a
function-scope span, which the profiler gives no device-side copy, so the
trace's device ops stay as they were) and keeps a record with its counts
until ``reset_spans()`` (``span_records()`` reads them). Otherwise a span
costs one flag read and creates nothing. A span makes no device call: the
device ops it issued are those the profiler saw launched inside its host
span.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from pathlib import Path
from typing import Any

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_LOG_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "cvdb") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_LOG_FORMAT))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class MetricsWriter:
    """Append-only JSONL metrics: one line per event, flushed immediately."""

    def __init__(self, path: str | Path | None):
        self._fh = None
        if path is not None:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._fh = p.open("a")

    def log(self, event: str, **fields: Any) -> dict:
        rec = {"ts": time.time(), "event": event, **fields}
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StageTimer:
    """Wall-clock timer for pipeline stages; logs to a MetricsWriter and
    opens the span ``cvdb.stage.<stage>`` around the stage."""

    def __init__(self, metrics: MetricsWriter, stage: str):
        self.metrics = metrics
        self.stage = stage
        self.t0 = 0.0
        self.elapsed = 0.0
        self._span = _NOOP

    def __enter__(self):
        self._span = span(f"cvdb.stage.{self.stage}")
        self._span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        self._span.__exit__(*exc)
        self.metrics.log("stage_done", stage=self.stage, wall_s=self.elapsed)


# -- spans ------------------------------------------------------------------

#: the span of one request; it starts a call, and the spans inside it carry
#: the call's id
SEARCH = "cvdb.search"
#: finished records kept until reset_spans(); later spans are counted as dropped
SPAN_CAP = 1 << 16
_NOOP = contextlib.nullcontext()


class _SpanLog:
    """The finished spans of the process, the count of those dropped past
    ``SPAN_CAP``, the last call id, and each thread's stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: list = []
        self.dropped = 0
        self.calls = 0
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def new_call(self) -> int:
        with self.lock:
            self.calls += 1
            return self.calls

    def keep(self, rec) -> None:
        with self.lock:
            if len(self.records) < SPAN_CAP:
                self.records.append(rec)
            else:
                self.dropped += 1


_LOG = _SpanLog()


class _Span:
    """One live span (``span`` makes it only while a profiler records)."""

    __slots__ = ("name", "counts", "call", "root", "host")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = _LOG.stack()
        self.call = stack[-1].call if stack else None
        self.root = self.name == SEARCH and self.call is None
        if self.root:
            self.call = _LOG.new_call()
        stack.append(self)
        self.host = _RecordFunctionFast(self.name)
        self.host.__enter__()
        return self

    def __exit__(self, *exc):
        self.host.__exit__(*exc)
        self.host = None
        _LOG.stack().pop()
        _LOG.keep(self)
        return False


def span(name: str, **counts: int):
    """A span of ``name`` around a ``with`` block; ``counts`` are host
    integers the caller already holds (counts known only inside the block
    go into the ``counts`` dict of the span that ``with`` gives). Live only
    while a profiler records (module docstring); otherwise the shared no-op
    context, after one flag read, and ``with`` gives None."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, counts)


def span_records() -> dict:
    """The finished spans, oldest first: ``records``, a dict each (``name``,
    ``call`` (the id of the ``cvdb.search`` span it lies in, or None),
    ``root`` (it opened that call), ``counts``), and ``dropped``, the spans
    past ``SPAN_CAP``."""
    with _LOG.lock:
        recs, dropped = list(_LOG.records), _LOG.dropped
    return {"records": [{"name": r.name, "call": r.call, "root": r.root,
                         "counts": dict(r.counts)} for r in recs],
            "dropped": dropped}


def reset_spans() -> None:
    """Forget every finished span and the dropped count."""
    with _LOG.lock:
        _LOG.records.clear()
        _LOG.dropped = 0
