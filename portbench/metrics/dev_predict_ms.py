"""Milliseconds of the card's time in an epoch's dev predict (the streamed
head over every row, and the copy of the classes to the host): the mean
over the traced job's ``fit.predict`` spans (``Trainer.fit``) of the time
between their two CUDA events."""

from portbench.spanread import mean_device_ms


def read(rec):
    return mean_device_ms("fit.predict")
