"""GiB of the card's memory the port had allocated at its peak in the
window (``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(rec):
    peak = rec["memory"]["window_peak_bytes"]
    return peak / 2**30 if peak else None
