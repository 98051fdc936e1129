"""Milliseconds of the card's time in one Adam step of a full-graph epoch:
the mean over the traced job's ``fit.step`` spans (``Trainer.fit``) of the
time between their two CUDA events."""

from portbench.spanread import mean_device_ms


def read(rec):
    return mean_device_ms("fit.step")
