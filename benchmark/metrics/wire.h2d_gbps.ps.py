"""wire.h2d_gbps.ps: the bytes of the run's H2D copies between host
pages and the card in the clients' process over those copies' host
seconds, GB/s: the program's torch_wire_h2d_bytes over
torch_stage_h2d_us on /vars."""

from harness import wire_counters


def read(rec):
    return wire_counters.gbps(rec, "ps", "h2d")
