"""driver.step_p95_ms: the 95th percentile (nearest rank) of the wall time
of every step in the window, host clock around each synchronized step."""

import math


def read(rec):
    walls = sorted(rec.get("step_walls") or [])
    if rec.get("kind") != "train" or not walls:
        return None
    return 1e3 * walls[math.ceil(0.95 * len(walls)) - 1]
