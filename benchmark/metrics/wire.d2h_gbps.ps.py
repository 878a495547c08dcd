"""wire.d2h_gbps.ps: the bytes of the run's D2H copies between host
pages and the card in the clients' process over those copies' host
seconds, GB/s: the program's torch_wire_d2h_bytes over
torch_stage_d2h_us on /vars."""

from harness import wire_counters


def read(rec):
    return wire_counters.gbps(rec, "ps", "d2h")
