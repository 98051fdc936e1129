"""Tracing: the profiler, the program's spans and its counters (port of
``graphconvgeo_tpu/utils/profiling.py``).

- :func:`trace` — ``torch.profiler`` over the CPU and, on a machine with
  CUDA, the card, writing a Chrome trace (``trace.json``) into a directory.
  It raises if CUDA is present but the trace holds no CUDA activity, so a
  profile never silently misses the card.
- :class:`span` — a named part of the program (``fit.step``,
  ``operands.adjacency``, ...). Each one appends a :class:`SpanRecord` (its
  name, the enclosing span, the fit's epoch and its host seconds) to an
  in-memory store. While a ``torch.profiler`` records, the span is also a
  ``record_function`` range in the trace and, once CUDA is initialized, a
  pair of CUDA events on the current stream, resolved into the record's
  ``device_s`` by :func:`span_records`. :func:`reset_spans` empties the store.
- ``counters`` — plain integers the program adds to where the work happens
  (``head_blocks``: the streamed head's row blocks, ``ops/ce_stream.py``;
  ``dense_fallback``: float32 CUDA products left to ``torch.matmul`` under
  ``ops/dense.py``'s row threshold; ``attn_rest_edges``: the rest's edges
  (those outside the dense tiles) that each forward and each backward run
  of the tiled GAT layer walks with the tiled ones,
  ``ops/attention_tiled.py``; ``dot_attn_edges``: the pattern's edges that
  each forward and each backward application of the graph transformer's
  dot-product attention walks, ``ops/attention_dot.py``);
  :func:`reset_counters` zeroes them, as ``cuda_build.reset_launch_counts``
  zeroes the kernel launches.

The models label ``input_layer``, ``conv_<i>`` / ``attn_<i>`` and
``output_layer`` with ``record_function`` directly.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# NVIDIA H100 SXM data-sheet peaks at its 700 W power limit (dense, no
# sparsity): HBM3 bytes per second and operations per second by type. A
# card set below 700 W runs slower under load.
H100 = {
    "name": "NVIDIA H100 SXM, 700 W",
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops": 67e12,  # FFMA, outside the tensor cores
    "tf32_flops": 495e12,  # tensor cores
    "bf16_flops": 989e12,  # tensor cores
}

TRACE_FILE = "trace.json"
MAX_SPAN_RECORDS = 1 << 16  # the store keeps the newest records

counters: dict = {"head_blocks": 0, "dense_fallback": 0, "attn_rest_edges": 0,
                  "dot_attn_edges": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def _has_cuda_events(prof) -> bool:
    from torch.autograd import DeviceType

    return any(e.device_type == DeviceType.CUDA for e in prof.events())


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block into ``logdir/trace.json`` (a Chrome trace; open it
    in Perfetto or chrome://tracing). Traces the card when CUDA is
    available, and raises after the block if it caught no CUDA activity."""
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if cuda and not _has_cuda_events(prof):
        raise RuntimeError(
            "torch.profiler recorded no CUDA activity: the card could not be traced"
        )
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@dataclasses.dataclass
class SpanRecord:
    """One span: ``parent`` is the name of the span open around it (None at
    the top), ``epoch`` the fit's epoch (None outside a fit's epochs),
    ``host_s`` its seconds on the host's clock, ``device_s`` the card's
    seconds between its two events (None unless a profiler recorded it on a
    CUDA process; filled by :func:`span_records`)."""

    name: str
    parent: Optional[str]
    epoch: Optional[int]
    host_s: float = 0.0
    device_s: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)  # (start, end)


_records: collections.deque = collections.deque(maxlen=MAX_SPAN_RECORDS)
_open: list = []  # the records of the spans open now, innermost last


class span:
    """``with span("fit.step", epoch=3): ...`` records the block (see the
    module docstring). ``epoch`` defaults to the enclosing span's. Off the
    profiler it costs one probe of the profiler's state, two clock reads
    and one append, and never synchronizes."""

    __slots__ = ("name", "epoch", "_record", "_range", "_start", "_t0")

    def __init__(self, name: str, *, epoch: Optional[int] = None):
        self.name, self.epoch = name, epoch

    def __enter__(self) -> SpanRecord:
        parent = _open[-1] if _open else None
        epoch = self.epoch if self.epoch is not None or parent is None else parent.epoch
        rec = self._record = SpanRecord(self.name, parent and parent.name, epoch)
        _open.append(rec)
        _records.append(rec)
        self._range = self._start = None
        if torch._C._autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
            if torch.cuda.is_initialized():
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record()
        self._t0 = time.perf_counter()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self._record
        rec.host_s = time.perf_counter() - self._t0
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.events = (self._start, end)
        if self._range is not None:
            self._range.__exit__(*exc)
        _open.pop()
        return False


def span_records() -> list:
    """The stored records, oldest first. Resolves the closed spans' CUDA
    events into ``device_s`` (one synchronize when any are pending)."""
    pending = [r for r in _records if r.events is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            start, end = r.events
            r.device_s = start.elapsed_time(end) * 1e-3
            r.events = None
    return list(_records)


def reset_spans() -> None:
    _records.clear()
