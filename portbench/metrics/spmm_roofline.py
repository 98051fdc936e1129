"""Percent of its roofline at which the card ran the traced job's Â·H
applications: their least time (``counts.apply_bound`` of the operator at
the model's width: each nonzero once, the source read once at the gather
dtype, the output written once; a factorized Â as its two incidence
products) times the applications, over the device time of everything those
applications launched: kernel 1 on the tiles, the rests' gathers and
scatters, the casts and the stacking of the source. An application is one
outermost run of the factorized operator's autograd Function
(``sparse/factorized.py :: _FactorizedCore``, forward, backward and remat's
recompute alike). A materialized Â has no such single op, so this reader
finds nothing to read there."""

OPERATOR = "_FactorizedCore"  # its backward runs as "_FactorizedCoreBackward"


def _match(name: str) -> bool:
    return OPERATOR in name


def read(rec):
    if rec["config"]["adjacency"] != "factorized":
        return None
    trace = rec["trace"]
    applies = trace.op_calls(_match)
    seconds = trace.op_device_seconds(_match)
    if applies == 0 or seconds <= 0:
        return None
    return 100.0 * applies * rec["apply_bound"]["bound_s"] / seconds
