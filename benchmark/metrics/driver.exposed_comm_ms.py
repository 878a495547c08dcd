"""driver.exposed_comm_ms: the step driver's own accounting, the mean of
last_stats["exposed_comm_ms"] over the window's steps (the compute lane
waiting on the wire)."""

from harness import readers


def read(rec):
    return readers.mean_stat(rec, "exposed_comm_ms")
