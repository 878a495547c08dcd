#!/usr/bin/env python3
"""A drain whose first Install the destination refuses, on either package.

    python3 tools/drain_refusal.py jax|torch

Runs on the CPU (``JAX_PLATFORMS=cpu`` is set for the JAX package; the
port runs its engines with ``device="cpu"``). One registry hub and two
serving fleet members of the named package at the JAX tests' decoder
(``init_decoder(PRNGKey(0))`` widths, max_len 64): A monolithic, its
engine held back 20 ms a step so the drain lands mid-stream; B paged
(block_rows 8) with a pool of 5 blocks. Three sessions owned by A stream:
first a long one (a 40-token prompt, 20 tokens: 6 blocks or more at the
drain), then two short ones (2-token prompts, 14 tokens: 2 blocks each).
Once each has streamed 3 tokens A drains. B refuses the long session's
Install (ELIMIT: its pool cannot hold it even after paging cold sessions
out) while the two Installs behind it are in flight.

Prints one JSON line: the drain's count of moved sessions, B's refusals,
and per session the state it ended in on A and on B (with whether B's
copy ever got a stream), its resumes, and whether its stream equals the
serial reference. A session that ends done on A while B still holds it
parked was live on both members during the drain.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    if len(argv) != 2 or argv[1] not in ("jax", "torch"):
        print(__doc__, file=sys.stderr)
        return 2
    pkg = argv[1]
    sys.path.insert(0, ROOT)
    if pkg == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        from brpc_tpu.fleet import RegistryHub, clear_registry
        from brpc_tpu.models.decoder import decode_serial, init_decoder
        from brpc_tpu.runtime import native
        from brpc_tpu.serving import FleetServingServer, ServingFleetClient

        params = init_decoder(jax.random.PRNGKey(0))
        extra = {}

        def serial(prompt, n):
            return decode_serial(params, prompt, n, 64)
    else:
        import torch

        from brpc_tpu_torch.fleet import RegistryHub, clear_registry
        from brpc_tpu_torch.models.decoder import decode_serial, init_decoder
        from brpc_tpu_torch.runtime import native
        from brpc_tpu_torch.serving import (FleetServingServer,
                                            ServingFleetClient)

        torch.set_num_threads(1)
        params = init_decoder(torch.Generator().manual_seed(0),
                              device="cpu")
        extra = {"device": "cpu"}

        def serial(prompt, n):
            return decode_serial(params, prompt, n, 64, lanes=4)

    hub = RegistryHub()
    hub.start()

    def member(**kw):
        srv = FleetServingServer(hub.hostport, params, tag="refusal",
                                 max_len=64, max_batch=4, reg_ttl_s=3,
                                 **extra, **kw)
        srv.start()
        return srv

    a = member()
    b = member(paged=True, block_rows=8, kv_arena_bytes=5 * 2 * 8 * 32 * 4)
    inner = a.engine.step

    def step():
        time.sleep(0.02)
        return inner()

    a.engine.step = step
    refusals = []
    imp = b.manager.import_session

    def import_session(manifest, kv):
        try:
            return imp(manifest, kv)
        except native.RpcError as e:
            refusals.append([manifest["session"], e.code])
            raise

    b.manager.import_session = import_session
    c = ServingFleetClient(hub.hostport, tag="refusal")
    c.router.refresh(force=True)
    keys, i = [], 0
    while len(keys) < 3:
        if c.router.route(f"rf-{i}") == a.addr:
            keys.append(f"rf-{i}")
        i += 1
    specs = {keys[0]: (list(range(1, 41)), 20), keys[1]: ([3, 7], 14),
             keys[2]: ([5, 2], 14)}
    streams = {keys[0]: c.open(*specs[keys[0]], session_key=keys[0])}
    while len(streams[keys[0]].tokens) < 3:
        streams[keys[0]].read_token(5000)
    for k in keys[1:]:
        streams[k] = c.open(*specs[k], session_key=k)
    for ts in streams.values():
        while len(ts.tokens) < 3:
            ts.read_token(5000)
    readers = [threading.Thread(target=lambda ts=ts: list(ts))
               for ts in streams.values()]
    for t in readers:
        t.start()
    moved = a.drain()
    for t in readers:
        t.join(60)
    time.sleep(0.5)
    out = {"package": pkg, "moved": moved, "refusals": refusals,
           "sessions": []}
    for k in keys:
        sa, sb = a.manager.get(k), b.manager.get(k)
        out["sessions"].append({
            "session": k,
            "on_a": None if sa is None else [sa.state, sa.shed_reason],
            "on_b": None if sb is None else [sb.state, sb.sink is not None],
            "resumes": streams[k].resumes,
            "stream_equals_serial": streams[k].tokens == serial(*specs[k])})
    for ts in streams.values():
        ts.close()
    c.close()
    for srv in (a, b):
        srv.stop()
    clear_registry()
    hub.stop()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
