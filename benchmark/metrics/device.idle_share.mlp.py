"""device.idle_share.mlp: the share of the traced steps in which no kernel
or copy of the trainer's or the server's process ran, percent."""

from harness import readers


def read(rec):
    return readers.idle_share(rec, "train")
