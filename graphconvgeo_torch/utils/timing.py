"""Device timing by differenced loop counts (port of
``graphconvgeo_tpu/utils/timing.py``).

Run a step ``iters_lo`` and ``iters_hi`` times, chaining its output back
into its input, and difference the two times: the fixed costs of a run
(the first launch's latency, the final synchronize, the host's return)
cancel, leaving the time of one more step. On a CUDA tensor each run is
timed by CUDA events around the launches, read after a synchronize; on the
CPU by ``time.perf_counter``.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _run_seconds(step: Callable, x0: torch.Tensor, iters: int, step_args: tuple) -> float:
    """Seconds to run ``x = step(x, *step_args)`` ``iters`` times from x0."""
    if x0.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x = x0
        for _ in range(iters):
            x = step(x, *step_args)
        end.record()
        torch.cuda.synchronize(x0.device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    x = x0
    for _ in range(iters):
        x = step(x, *step_args)
    float(x.float().sum())  # consume the result inside the timed run
    return time.perf_counter() - t0


def device_trial_seconds(
    step: Callable,
    x0: torch.Tensor,
    *step_args,
    iters_lo: int = 2,
    iters_hi: int = 18,
    trials: int = 3,
) -> list:
    """Seconds per iteration of ``x -> step(x, *step_args)`` (x keeps its
    shape), one differenced measurement per trial after one warm-up run of
    each count, so callers can report the median and the spread."""
    _run_seconds(step, x0, iters_lo, step_args)
    _run_seconds(step, x0, iters_hi, step_args)
    out = []
    for _ in range(trials):
        t_lo = _run_seconds(step, x0, iters_lo, step_args)
        t_hi = _run_seconds(step, x0, iters_hi, step_args)
        out.append(max((t_hi - t_lo) / (iters_hi - iters_lo), 1e-12))
    return out


def device_seconds_per_iter(
    step: Callable,
    x0: torch.Tensor,
    *step_args,
    iters_lo: int = 2,
    iters_hi: int = 18,
    trials: int = 3,
) -> float:
    """The least seconds per iteration over ``trials`` measurements."""
    return min(
        device_trial_seconds(
            step, x0, *step_args, iters_lo=iters_lo, iters_hi=iters_hi, trials=trials
        )
    )
