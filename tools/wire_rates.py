#!/usr/bin/env python3
"""Measures the wire's ceilings on one card: the host<->card copy rates
and the host copy that lands a one-sided read.

    python3 tools/wire_rates.py [--reps N] [--out FILE]

At two payloads of the port's parameter servers, 184.5 MB (Moonlight's
dense ``gate_up``, 2 x 11264 x 2048 fp32) and 9.4 MB (GPT-2 small's
``c_fc``, 768 x 3072 fp32), it times with the host clock, each copy
blocking as the wire's copies are:

  * H2D and D2H from and into pageable memory and page-locked memory
    (the host buffer reused, as an arena's warm pages are);
  * a host memcpy of the payload into fresh pages (an anonymous mapping
    made for each copy), into a fresh ``np.empty`` (what
    ``OnesideReader.read_np`` lands in), and into one reused buffer;
  * one one-sided pull through a parameter server in this process, both
    ways the port reads: ``read_np`` and a pageable H2D, and
    ``read_to_device`` through the reader's page-locked buffer.

It prints the card's name and power limit, then one JSON line a
measurement: the median of ``--reps`` runs after one warm-up, in GB/s
(1e9 bytes a second). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import mmap
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = {"moonlight.gate_up": 2 * 11264 * 2048 * 4,
         "gpt2.c_fc": 768 * 3072 * 4}


def _median_s(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _fresh_pages(src: np.ndarray) -> None:
    with mmap.mmap(-1, src.nbytes) as mm:
        np.frombuffer(mm, np.uint8)[:] = src


def copy_rates(nbytes: int, reps: int, dev: torch.device) -> dict:
    """GB/s of each copy of ``nbytes``, keyed by what it copies."""
    src = np.random.default_rng(0).integers(0, 255, nbytes, np.uint8)
    pageable = torch.from_numpy(src.copy())
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(pageable)
    card = pageable.to(dev)
    reused = np.empty_like(src)

    def fresh_empty():
        np.empty_like(src)[:] = src

    def reused_copy():
        reused[:] = src

    runs = {
        "h2d_pageable": lambda: pageable.to(dev),
        "h2d_pinned": lambda: pinned.to(dev),
        "d2h_pageable": lambda: pageable.copy_(card),
        "d2h_pinned": lambda: pinned.copy_(card),
        "memcpy_fresh_pages": lambda: _fresh_pages(src),
        "memcpy_fresh_np_empty": fresh_empty,
        "memcpy_reused": reused_copy,
    }
    return {k: nbytes / _median_s(fn, reps) / 1e9 for k, fn in runs.items()}


def pull_rates(nbytes: int, reps: int, dev: torch.device) -> dict:
    """GB/s of one one-sided pull of an ``nbytes`` fp32 tensor onto the
    card, through read_np and through read_to_device."""
    from brpc_tpu_torch.runtime.param_server import ParameterServer
    from brpc_tpu_torch.runtime.tensor import (OnesideReader, TensorArena,
                                               consume_oneside_payload)

    n = nbytes // 4
    value = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    ps = ParameterServer({"t": value}, device=dev, oneside=True,
                         arena=TensorArena(2 * nbytes + (64 << 20)))
    try:
        rd = OnesideReader.map(ps._oneside_window.describe())
        try:
            runs = {
                "pull_read_np": lambda: consume_oneside_payload(
                    rd.read_np("t")[1], dev),
                "pull_read_to_device": lambda: rd.read_to_device("t", dev),
            }
            out = {k: nbytes / _median_s(fn, reps) / 1e9
                   for k, fn in runs.items()}
            a = consume_oneside_payload(rd.read_np("t")[1], dev)
            b = rd.read_to_device("t", dev)[1]
            if not torch.equal(a, b):
                raise AssertionError("the two pulls differ")
            return out
        finally:
            rd.close()
    finally:
        ps.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    lines = [json.dumps({"card": torch.cuda.get_device_name(0),
                         "smi": smi.stdout.strip()})]
    for label, nbytes in SIZES.items():
        rates = copy_rates(nbytes, args.reps, dev)
        rates.update(pull_rates(nbytes, args.reps, dev))
        for what, gbps in rates.items():
            lines.append(json.dumps({"payload": label, "bytes": nbytes,
                                     "copy": what, "gbps": gbps}))
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
