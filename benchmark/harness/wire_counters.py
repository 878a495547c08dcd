"""The wire's copy rates from the program's own counters, read as an
operator reads /vars: ``torch_wire_<dir>_bytes`` (the bytes of the copies
between host pages and the card) and ``torch_stage_<dir>_us`` (their
host time), ``<dir>`` ``h2d`` or ``d2h``, through
``observability.metrics.dump_vars("torch_")`` in this process. Reading
creates nothing: a program without the counters reads as None.

The counters cover the whole run of this process up to the read: set-up,
the window, the traced stretch and the check's pulls."""

from __future__ import annotations


def read_vars() -> dict:
    """This process's ``torch_`` series on /vars: ``{name: int}``."""
    from brpc_tpu_torch.observability import metrics

    out = {}
    for line in metrics.dump_vars("torch_").splitlines():
        name, sep, value = line.partition(" : ")
        if sep:
            try:
                out[name.strip()] = int(value)
            except ValueError:
                pass  # a series that is not a plain count
    return out


def gbps(rec: dict, kind: str, direction: str):
    """The copies' bytes over their host seconds, GB/s, for a card run of
    ``kind``; None on another kind, a rehearsal, or no copy counted."""
    if rec.get("kind") != kind or "peaks" not in rec:
        return None
    found = read_vars()
    nbytes = found.get(f"torch_wire_{direction}_bytes")
    us = found.get(f"torch_stage_{direction}_us")
    if not nbytes or not us:
        return None
    return nbytes / us / 1e3
