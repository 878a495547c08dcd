"""kernel.k1_roofline.ps: K1's byte bound for the elements the traced rounds
pushed, over K1's summed device time in the traces, percent."""

from harness import readers


def read(rec):
    return readers.k1_share(rec, "ps")
