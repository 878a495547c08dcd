"""wire.busy_ms: the mean of the step driver's last_stats["wire_busy_ms"]
over the window's steps (the union of the wire lanes' node time)."""

from harness import readers


def read(rec):
    return readers.mean_stat(rec, "wire_busy_ms")
