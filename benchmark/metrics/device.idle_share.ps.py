"""device.idle_share.ps: the share of the traced rounds in which no kernel
or copy of the clients' or the server's process ran, percent."""

from harness import readers


def read(rec):
    return readers.idle_share(rec, "ps")
