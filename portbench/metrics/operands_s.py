"""Seconds of the port's operand and model construction in set-up
(``sparse/``, the ``models/`` and trainer constructors), from the
benchmark's own span around those calls."""


def read(rec):
    return rec["spans"].get("operands")
