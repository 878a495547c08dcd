"""kernel.k1_roofline.mlp: K1's byte bound (20 B an fp32 element at the
card's HBM rate) for the elements the traced steps pushed, over K1's summed
device time in the traces, percent."""

from harness import readers


def read(rec):
    return readers.k1_share(rec, "train")
