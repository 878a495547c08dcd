"""ps_gbps: logical fp32 bytes of every pull_all and push_all the trainer
clients made in the window, over the window's seconds, GB/s (host clock).
A call under way at the window's close counts for the share of its time
inside the window. Logical bytes, so a codec's saving shows."""


def read(rec):
    if rec.get("kind") != "ps" or not rec.get("window_s"):
        return None
    return rec["bytes"] / rec["window_s"] / 1e9
