"""wire.h2d_gbps.mlp: the bytes of the run's H2D copies between host
pages and the card in the trainer's process (the server's handlers too,
where they share it) over those copies' host seconds, GB/s: the
program's torch_wire_h2d_bytes over torch_stage_h2d_us on /vars."""

from harness import wire_counters


def read(rec):
    return wire_counters.gbps(rec, "train", "h2d")
