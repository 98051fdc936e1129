"""The port's span records (``graphconvgeo_torch/utils/profiling.py ::
span_records``) for the per-layer metrics that read them. A program that
keeps no such records gives an empty list, and those metrics read
nothing."""

from __future__ import annotations


def records() -> list:
    from graphconvgeo_torch.utils import profiling

    read = getattr(profiling, "span_records", None)
    return read() if read is not None else []


def mean_device_ms(name: str):
    """Mean milliseconds of the card's time in the ``name`` spans that
    measured it (the spans run while a profiler recorded on the card: the
    traced job's), or None."""
    secs = [r.device_s for r in records() if r.name == name and r.device_s is not None]
    return 1e3 * sum(secs) / len(secs) if secs else None


def last_host_s(rec, name: str):
    """Host seconds of the last ``name`` span, or None where there is none
    or the traced job ran no operation on the card (a run off the card)."""
    if not rec["trace"].intervals():
        return None
    found = [r.host_s for r in records() if r.name == name]
    return found[-1] if found else None
