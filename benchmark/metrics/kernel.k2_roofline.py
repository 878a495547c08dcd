"""kernel.k2_roofline: K2's byte bound (a code read, an fp32 value written,
a scale a block) for the codes widened in the traced rounds, on the server
and the clients, over K2's summed device time in both traces, percent."""

from harness import readers


def read(rec):
    return readers.k2_share(rec, "ps")
