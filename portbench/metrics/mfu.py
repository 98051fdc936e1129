"""Percent of the card's dense bf16 peak (989 TFLOP/s, the highest dense
rate of any precision these configurations admit) that the model's
operations of a full-graph epoch (``counts.epoch_flops``) make over the
window's wall time an epoch."""

from portbench.counts import H100


def read(rec):
    return 100.0 * rec["epoch_flops"] / (rec["epoch_s"] * H100["bf16_flops"])
