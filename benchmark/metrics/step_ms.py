"""step_ms: the window's seconds x 1000 over the training steps completed
in it (host clock, each step synchronized)."""


def read(rec):
    walls = rec.get("step_walls")
    if rec.get("kind") != "train" or not walls:
        return None
    return 1e3 * rec["window_s"] / len(walls)
