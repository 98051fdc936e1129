"""Structured metrics logging (SURVEY.md §5 "metrics/logging/observability").

The reference prints epoch loss/time to stdout; here each epoch's metrics
dict can additionally be appended to a JSONL file — greppable, plottable,
and durable across restarts (the writer reopens in append mode)."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, record: dict) -> None:
        if not self.path:
            return
        record = {"ts": round(time.time(), 3), **record}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
