"""Percent of the traced job's wall time in which no operation ran on the
card: 100 · (1 − union of the device's operation intervals / the job's
wall)."""


def read(rec):
    wall, busy = rec["traced"]["wall_s"], rec["trace"].busy_s()
    if wall <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
