"""Seconds of the host's time in building the input operand of X
(``models/gcn.py :: build_input_operands``: the slab and its rest), from
the program's ``operands.input`` span."""

from portbench.spanread import last_host_s


def read(rec):
    return last_host_s(rec, "operands.input")
