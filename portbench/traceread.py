"""Reading a ``torch.profiler`` trace of the traced window: the device's
busy time as the union of its operations' intervals (concurrent kernels
count once), the kernels' time by name, the device time of the operations
launched under a host op, and the device's idle gaps labelled by what the
host was doing."""

from __future__ import annotations

import bisect
import collections

NAME_CHARS = 120  # names in the breakdown are cut to this length


def _is_device(evt) -> bool:
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CUDA


def _is_operation(evt, annotations: set) -> bool:
    """A device event that is an operation (a kernel, a copy, a fill), not a
    named range's projection onto the device's timeline."""
    return not getattr(evt, "is_user_annotation", False) and evt.name not in annotations


class Trace:
    """The events of one profiled window; ``t0``/``t1`` are its first start
    and last end on the trace's clock, in microseconds."""

    def __init__(self, prof):
        events = list(prof.events())
        ranges = {e.name for e in events
                  if not _is_device(e) and getattr(e, "is_user_annotation", False)}
        self.device = sorted(
            ((e.time_range.start, e.time_range.end, e.name) for e in events
             if _is_device(e) and _is_operation(e, ranges)),
            key=lambda t: t[0],
        )
        self.host = [e for e in events if not _is_device(e)]
        starts = [e.time_range.start for e in self.host] + [d[0] for d in self.device]
        ends = [e.time_range.end for e in self.host] + [d[1] for d in self.device]
        self.t0 = min(starts) if starts else 0.0
        self.t1 = max(ends) if ends else 0.0

    def intervals(self) -> list:
        """The device's busy intervals (merged), in microseconds."""
        out = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) * 1e-6

    def kernel_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for s, e, name in self.device if match(name)) * 1e-6

    def top_device_ops(self, k: int = 10) -> list:
        total = collections.Counter()
        for s, e, name in self.device:
            total[name[:NAME_CHARS]] += (e - s) * 1e-6
        return [[name, sec] for name, sec in total.most_common(k)]

    def _outermost(self, match) -> list:
        """The host ops whose name ``match`` accepts and that run inside no
        other such op."""
        out = []
        for e in self.host:
            if not match(e.name):
                continue
            parent = e.cpu_parent
            while parent is not None and not match(parent.name):
                parent = parent.cpu_parent
            if parent is None:
                out.append(e)
        return out

    def op_calls(self, match) -> int:
        """How many times a host op whose name ``match`` accepts ran (its
        outermost such op counts once)."""
        return len(self._outermost(match))

    def op_device_seconds(self, match) -> float:
        """Device seconds of the kernels launched under a host op whose name
        ``match`` accepts (its outermost such op counts them once)."""
        return sum(_subtree_kernel_us(e) for e in self._outermost(match)) * 1e-6

    def idle_gaps(self, window: tuple, k: int = 10) -> list:
        """The device's idle time inside ``window`` (trace microseconds),
        summed by the innermost host op running at each gap's midpoint
        ("python" where no op runs), the largest ``k``."""
        lo, hi = window
        gaps = []
        prev = lo
        for s, e in self.intervals():
            if e <= lo:
                continue
            if s > prev:
                gaps.append((prev, min(s, hi)))
            prev = max(prev, e)
            if prev >= hi:
                break
        if prev < hi:
            gaps.append((prev, hi))
        host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in self.host),
                      key=lambda t: t[0])
        starts = [h[0] for h in host]

        total = collections.Counter()
        for s, e in gaps:
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(starts, mid)
            best = "python"
            # the innermost op covering mid: nested ops start later, so the
            # latest-starting op that still runs at mid
            for j in range(i - 1, max(i - 200, -1), -1):
                if host[j][1] >= mid:
                    best = host[j][2]
                    break
            total[best[:NAME_CHARS]] += (e - s) * 1e-6
        return [[name, sec] for name, sec in total.most_common(k)]


def _subtree_kernel_us(evt) -> float:
    total = sum(k.duration for k in getattr(evt, "kernels", []))
    for child in evt.cpu_children:
        total += _subtree_kernel_us(child)
    return total
