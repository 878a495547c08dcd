"""setup_s: process start to the window's start, seconds, less the
check's own reads of the server's state (host clock)."""


def read(rec):
    return rec["setup_s"]
