"""Process groups for the port's multi-rank paths.

The JAX package fakes n devices inside one process; the port runs one
process per rank. ``run_ranks`` starts n fresh (spawned) processes, joins
them into one group — gloo on the CPU, NCCL with one card per rank on CUDA
— through a ``FileStore`` in a temporary directory (no TCP port to pick),
runs ``fn(*args)`` on every rank and returns the results in rank order,
each rank's pickled into that directory (no queue to drain before join).
``share_card=True`` starts n CUDA ranks that all use ``cuda:0`` over a gloo
group instead (NCCL refuses two ranks on one device): the caller chooses
it, it is never taken when NCCL or cards are missing.
``one_rank_group`` is the same group of one, in this process. CPU ranks
run one intra-op thread each: n ranks share one host's cores.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from brpc_tpu_torch.utils.device import resolve_device


def _backend(device_type: str, share_card: bool = False) -> str:
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {device_type!r}")
    if share_card and device_type != "cuda":
        raise ValueError("share_card=True shares a CUDA card: "
                         f"device_type is {device_type!r}")
    return "nccl" if device_type == "cuda" and not share_card else "gloo"


def _init(rank: int, world: int, store_path: str, device_type: str,
          share_card: bool = False) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(0 if share_card else rank)
    dist.init_process_group(_backend(device_type, share_card),
                            init_method="file://" + store_path,
                            rank=rank, world_size=world)


def _rank_main(rank, world, work_dir, device_type, share_card, fn, args):
    if device_type == "cpu":
        torch.set_num_threads(1)
    _init(rank, world, os.path.join(work_dir, "store"), device_type,
          share_card)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(n: int, fn, args=(), *, device_type: Optional[str] = None,
              share_card: bool = False, timeout_s: float = 120.0) -> list:
    """``fn(*args)`` on n spawned ranks of one process group; returns the
    results (picklable) in rank order. ``fn`` must be importable by name.
    ``device_type`` is "cuda" (the default: one card per rank, NCCL;
    raises when CUDA is not available) or "cpu" (gloo). ``share_card``
    (CUDA only) puts every rank on ``cuda:0`` over gloo.
    A rank that raises ends the run: ``torch.multiprocessing`` stops the
    others and raises ``ProcessRaisedException`` with its traceback. Ranks
    still running at the timeout are killed and RuntimeError is raised."""
    if device_type is None:
        device_type = resolve_device(None).type
    _backend(device_type, share_card)
    cards = 1 if share_card else n
    if device_type == "cuda" and torch.cuda.device_count() < cards:
        raise RuntimeError(f"{n} ranks need {cards} CUDA card(s), "
                           f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(prefix="brpc_tpu_torch_pg_") as work:
        ctx = torch_mp.start_processes(
            _rank_main,
            args=(n, work, device_type, share_card, fn, tuple(args)),
            nprocs=n, join=False, daemon=True, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"run_ranks: ranks still running "
                                       f"after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
        out = []
        for r in range(n):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


@contextlib.contextmanager
def one_rank_group(device_type: str):
    """A process group of one rank (this process) for the scope."""
    with tempfile.TemporaryDirectory(prefix="brpc_tpu_torch_pg_") as tmp:
        _init(0, 1, os.path.join(tmp, "store"), device_type)
        try:
            yield
        finally:
            dist.destroy_process_group()
