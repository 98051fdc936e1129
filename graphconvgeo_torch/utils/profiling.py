"""Tracing and roofline accounting (port of
``graphconvgeo_tpu/utils/profiling.py``).

- :func:`trace` — ``torch.profiler`` over the CPU and, on a machine with
  CUDA, the card, writing a Chrome trace (``trace.json``) into a directory.
  It raises if CUDA is present but the trace holds no CUDA activity, so a
  profile never silently misses the card.
- :func:`annotate` — a named range in the trace (``record_function``); the
  models label ``input_layer``, ``conv_<i>`` / ``attn_<i>`` and
  ``output_layer`` with it.
- :func:`roofline_report` — one Â·H application against a card's limits.
"""

from __future__ import annotations

import contextlib
import os

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


def annotate(name: str):
    """A named range in a :func:`trace` (a no-op outside one)."""
    return record_function(name)


def roofline_report(*, nnz: int, n_rows: int, feat: int, seconds: float, chip: dict = H100) -> dict:
    """Roofline accounting for one Â·H application in float32: the bytes it
    must move (each nonzero's value and column, one gathered row of H per
    nonzero, H read and the output written once) and its FFMA operations,
    against ``chip``'s limits."""
    flops = 2.0 * nnz * feat
    bytes_min = nnz * (8 + 4 * feat) + 2 * n_rows * feat * 4
    t_mem = bytes_min / chip["hbm_bytes_per_s"]
    t_flops = flops / chip["f32_flops"]
    bound = max(t_mem, t_flops)
    return {
        "edges_per_sec": nnz / seconds,
        "achieved_gbps": bytes_min / seconds / 1e9,
        "roofline_seconds": bound,
        "roofline_fraction": bound / seconds,
        "memory_bound": t_mem >= t_flops,
    }
