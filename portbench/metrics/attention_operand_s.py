"""Seconds of the host's time in building the GAT's attention operand
(``models/gat.py :: GraphAttentionNet``: ``TiledAttentionPattern.from_scipy``,
its tiles, their packed masks and the bucketed rest, and its copy to the
card), from the program's ``operands.attention`` span."""

from portbench.spanread import last_host_s


def read(rec):
    return last_host_s(rec, "operands.attention")
