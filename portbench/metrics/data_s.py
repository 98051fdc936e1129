"""Seconds of the port's host data layer in set-up (``data/``, ``native/``,
``sparse/reorder.py``: the projection and normalisation of Â, the
reordering), from the benchmark's own span around those calls."""


def read(rec):
    return rec["spans"].get("data")
