"""Milliseconds an epoch in which the card ran no operation while the host
was in the training loop's own parts: the dev ``geo_eval``, the history
record and the best-state clones (the ``fit.eval``, ``fit.record`` and
``fit.best_state`` ranges of the traced job, on the profiler's clock), over
the traced job's epochs."""

LOOP = ("fit.eval", "fit.record", "fit.best_state")


def _union(ranges: list) -> list:
    out = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_us(busy: list, ranges: list) -> float:
    """Microseconds of ``ranges`` that no interval of ``busy`` (merged,
    sorted) covers."""
    total = 0.0
    for lo, hi in _union(ranges):
        covered = sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in busy)
        total += (hi - lo) - covered
    return total


def read(rec):
    trace = rec["trace"]
    busy = trace.intervals()
    ranges = [(e.time_range.start, e.time_range.end) for e in trace.host if e.name in LOOP]
    epochs = rec["traced"]["epochs"]
    if not busy or not ranges or epochs <= 0:
        return None
    return idle_us(busy, ranges) * 1e-3 / epochs
