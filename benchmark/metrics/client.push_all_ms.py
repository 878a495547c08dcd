"""client.push_all_ms: the median wall time of the window's push_all calls,
timed by the harness around each call (host clock)."""

from harness import readers


def read(rec):
    return readers.median_ms(rec, "push_all")
