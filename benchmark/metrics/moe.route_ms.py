"""moe.route_ms: the program's torch_stage_moe_route_us (the router, the
top-k, the sort and the per-expert counts read back to the host, which
waits for the card) read on the trainer's /vars at the window's edges,
over the window's steps, ms a step."""


def read(rec):
    edges = rec.get("moe_route_us")
    walls = rec.get("step_walls")
    if (rec.get("kind") != "train" or "peaks" not in rec or not walls
            or not edges or None in edges):
        return None
    return (edges[1] - edges[0]) / len(walls) / 1e3
