"""The readers of the program's spans (``metrics/step_ms.py``,
``dev_predict_ms.py``, ``loop_idle_ms.py``, ``adjacency_s.py``,
``input_operand_s.py``): on a hand-built trace, on a CPU trace, where the
program keeps no span records."""

import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from graphconvgeo_torch.utils import profiling
from graphconvgeo_torch.utils.profiling import SpanRecord, span
from portbench import harness
from portbench.traceread import Trace

READERS = ["step_ms", "dev_predict_ms", "loop_idle_ms", "adjacency_s", "input_operand_s"]


def _event(name, start, end, device=False, annotation=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation)


def _hand_trace() -> Trace:
    """Two kernels (0-100 and 300-400 us), the host in ``fit.eval`` from 50
    to 350 us (its projection onto the card's timeline too) and in
    ``fit.step`` from 0 to 50."""
    events = [
        _event("kernel_a", 0.0, 100.0, device=True),
        _event("kernel_b", 300.0, 400.0, device=True),
        _event("fit.eval", 50.0, 350.0, annotation=True),
        _event("fit.eval", 50.0, 350.0, device=True, annotation=True),
        _event("fit.step", 0.0, 50.0, annotation=True),
    ]
    return Trace(types.SimpleNamespace(events=lambda: events))


def _read(name, rec):
    return harness.load_reader(harness.BENCH_DIR, name)(rec)


def test_loop_idle_ms_is_the_gap_inside_the_loop_ranges_per_epoch():
    rec = {"trace": _hand_trace(), "traced": {"epochs": 2}}
    # the card idles 100-300 us, all of it inside fit.eval: 0.2 ms over 2 epochs
    assert _read("loop_idle_ms", rec) == pytest.approx(0.1)


def test_span_readers_read_the_records(monkeypatch):
    recs = [SpanRecord("operands.adjacency", None, None, host_s=9.0),
            SpanRecord("operands.input", None, None, host_s=4.0),
            SpanRecord("operands.adjacency", None, None, host_s=11.0),
            SpanRecord("fit.step", None, 0, host_s=0.1),  # untraced: no device time
            SpanRecord("fit.step", None, 1, host_s=0.1, device_s=1.8),
            SpanRecord("fit.step", None, 2, host_s=0.1, device_s=2.0),
            SpanRecord("fit.predict", None, 1, host_s=0.5, device_s=0.5)]
    monkeypatch.setattr(profiling, "span_records", lambda: recs)
    rec = {"trace": _hand_trace(), "traced": {"epochs": 2}}
    assert _read("step_ms", rec) == pytest.approx(1900.0)
    assert _read("dev_predict_ms", rec) == pytest.approx(500.0)
    assert _read("adjacency_s", rec) == 11.0 and _read("input_operand_s", rec) == 4.0


def test_span_readers_read_nothing_where_the_program_keeps_no_records(monkeypatch):
    monkeypatch.delattr(profiling, "span_records")
    rec = {"trace": _hand_trace(), "traced": {"epochs": 2}}
    assert [_read(n, rec) for n in READERS if n != "loop_idle_ms"] == [None] * 4


def test_every_span_reader_reads_nothing_on_a_cpu_trace():
    profiling.reset_spans()
    with span("operands.adjacency"), span("operands.input"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for epoch in range(2):
            for name in ("fit.step", "fit.predict", "fit.eval", "fit.record", "fit.best_state"):
                with span(name, epoch=epoch):
                    torch.ones(64).cumsum(0)
    rec = {"trace": Trace(prof), "traced": {"epochs": 2}}
    assert {n: _read(n, rec) for n in READERS} == dict.fromkeys(READERS)
    profiling.reset_spans()
