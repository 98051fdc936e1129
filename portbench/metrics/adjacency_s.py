"""Seconds of the host's time in building the factorized Â
(``FactorizedAdjacency.from_groups``: the factors, the dense tiles and
their packing, the rests), from the program's ``operands.adjacency``
span."""

from portbench.spanread import last_host_s


def read(rec):
    return last_host_s(rec, "operands.adjacency")
