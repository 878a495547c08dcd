"""wire.d2h_gbps.mlp: the bytes of the run's D2H copies between host
pages and the card in the trainer's process (the server's handlers too,
where they share it) over those copies' host seconds, GB/s: the
program's torch_wire_d2h_bytes over torch_stage_d2h_us on /vars."""

from harness import wire_counters


def read(rec):
    return wire_counters.gbps(rec, "train", "d2h")
