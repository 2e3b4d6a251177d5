"""Structured JSONL metrics stream + stdlib logging (SURVEY.md §5.5; a copy
of cloudvectordb_tpu/utils/metrics.py, which imports no JAX).

No external service dependencies: the environment is offline, so observability
is a local ``metrics.jsonl`` (one JSON object per event) plus python logging.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any

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
    """Wall-clock timer for pipeline stages; logs to a MetricsWriter."""

    def __init__(self, metrics: MetricsWriter, stage: str):
        self.metrics = metrics
        self.stage = stage
        self.t0 = 0.0
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        self.metrics.log("stage_done", stage=self.stage, wall_s=self.elapsed)
