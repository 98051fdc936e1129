"""Percent of its roofline at which the card ran the traced job's
dot-product edge attention (the graph transformer's): its least time (the
family's ``dot_attn_bound``: one forward and one backward application at
the model's width, each edge's column once, each [n, ·] operand read once,
each output written once, float32 at the FFMA peak) times the forward and
the backward applications, over the device time of everything those
applications launched: the three dot-product sweeps and the copy of r. A
forward application is one outermost run of the autograd Function
``ops/attention_dot.py :: _TiledDotAttnCore`` (the step's and the
predict's), a backward one run of its ``_TiledDotAttnCoreBackward``. A cell
without that Function, or whose family counts no ``dot_attn_bound``, finds
nothing to read."""

OPERATOR = "_TiledDotAttnCore"
BACKWARD = OPERATOR + "Backward"


def read(rec):
    bound = rec.get("dot_attn_bound")
    if bound is None:
        return None
    trace = rec["trace"]
    fwd = trace.op_calls(lambda name: OPERATOR in name and BACKWARD not in name)
    bwd = trace.op_calls(lambda name: BACKWARD in name)
    seconds = trace.op_device_seconds(lambda name: OPERATOR in name)
    if fwd + bwd == 0 or seconds <= 0:
        return None
    least = fwd * bound["fwd"]["bound_s"] + bwd * bound["bwd"]["bound_s"]
    return 100.0 * least / seconds
