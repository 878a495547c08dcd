"""client.pull_all_ms: the median wall time of the window's pull_all calls,
timed by the harness around each call (host clock)."""

from harness import readers


def read(rec):
    return readers.median_ms(rec, "pull_all")
