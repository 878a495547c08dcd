#!/usr/bin/env python3
"""Which torch.distributed verbs gloo takes on CUDA tensors, and how long
its all_reduce and broadcast take, for ranks that share one card.

    python3 tools/gloo_cuda_probe.py [--mb 12.6] [--worlds 2 4]

For each world size it spawns that many ranks on ``cuda:0`` over a gloo
group (as ``parallel.launch.run_ranks(..., share_card=True)`` does) and
tries all_reduce, broadcast, reduce, gather, all_gather,
all_gather_into_tensor and reduce_scatter_tensor on CUDA tensors, then
times all_reduce of ``--mb`` MB on the card, the same through an explicit
host copy, and a broadcast (mean of 5 after one warm call). Then, for
each point-to-point form (isend/irecv, batch_isend_irecv), two ranks on
``cuda:0`` over gloo swap a CUDA tensor, each form in a spawn of its own
under a 60 s gloo timeout, and the probe prints whether the received
values are right, the call was refused, or a rank died. Last, a
one-rank NCCL group tries the verbs the mesh harness uses. Prints one
line per rank; needs one CUDA card.
"""

import argparse
import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

VERBS = ("all_reduce", "broadcast", "reduce", "gather", "all_gather",
         "all_gather_into_tensor", "reduce_scatter_tensor")


def _verb_calls(world: int, rank: int, dev):
    x = torch.full((4, 3), float(rank + 1), device=dev)
    return {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "reduce": lambda: dist.reduce(x.clone(), dst=0),
        "gather": lambda: dist.gather(
            x, [torch.empty_like(x) for _ in range(world)] if rank == 0
            else None, dst=0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(world * 4, 3, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(1, 3, device=dev), torch.ones(world, 3, device=dev)),
    }


def _try(calls) -> dict:
    out = {}
    for name in VERBS:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 — the probe reports it
            out[name] = f"refused: {type(e).__name__}: " + \
                str(e).splitlines()[0][:120]
    return out


def _rank(rank: int, world: int, store: str, mb: float) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    res = _try(_verb_calls(world, rank, dev))
    y = torch.full((4, 3), float(rank + 1), device=dev)
    dist.all_reduce(y)
    res["all_reduce_sum_ok"] = float(y[0, 0]) == world * (world + 1) / 2
    big = torch.randn(int(mb * 1e6 / 4), device=dev)

    def host():
        h = big.cpu()
        dist.all_reduce(h)
        big.copy_(h)

    for label, fn in (("all_reduce_cuda", lambda: dist.all_reduce(big)),
                      ("all_reduce_via_host", host),
                      ("broadcast_cuda", lambda: dist.broadcast(big, 0))):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.monotonic()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        res[f"{label}_ms"] = round((time.monotonic() - t) / 5 * 1e3, 3)
    print(f"gloo world {world} rank {rank}: {res}", flush=True)
    dist.destroy_process_group()


P2P_FORMS = ("isend_irecv", "batch_isend_irecv")


def _p2p_rank(rank: int, store: str, form: str) -> None:
    """Two ranks on cuda:0 over gloo swap a CUDA tensor by ``form``."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.arange(1024, dtype=torch.float32, device="cuda") + 1000 * rank
    got = torch.full_like(x, -1.0)
    peer = 1 - rank
    try:
        if form == "isend_irecv":
            works = [dist.isend(x, peer), dist.irecv(got, peer)]
        else:
            works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                            dist.P2POp(dist.irecv, got,
                                                       peer)])
        for w in works:
            w.wait()
        torch.cuda.synchronize()
        want = torch.arange(1024, dtype=torch.float32,
                            device="cuda") + 1000 * peer
        res = "ok" if torch.equal(got, want) else \
            f"wrong values (first {got[:4].tolist()})"
    except Exception as e:  # noqa: BLE001 — the probe reports it
        res = f"refused: {type(e).__name__}: " + \
            str(e).splitlines()[0][:160]
    print(f"gloo p2p {form} rank {rank}: {res}", flush=True)
    dist.destroy_process_group()


def _p2p_probe(form: str) -> None:
    with tempfile.TemporaryDirectory() as d:
        try:
            mp.start_processes(_p2p_rank, args=(os.path.join(d, "store"),
                                                form),
                               nprocs=2, join=True, start_method="spawn")
        except Exception as e:  # noqa: BLE001 — a rank died: reported
            print(f"gloo p2p {form}: a rank died: {type(e).__name__}: "
                  + str(e).splitlines()[0][:160], flush=True)


def _nccl_one_rank() -> None:
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method="file://" +
                                os.path.join(d, "store"), rank=0,
                                world_size=1)
        print(f"nccl world 1: {_try(_verb_calls(1, 0, 'cuda'))}",
              flush=True)
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=12.6,
                    help="timed tensor size, MB (12.6: 4096 x 768 fp32)")
    ap.add_argument("--worlds", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for world in args.worlds:
        with tempfile.TemporaryDirectory() as d:
            mp.start_processes(_rank, args=(world, os.path.join(d, "store"),
                                            args.mb),
                               nprocs=world, join=True, start_method="spawn")
    for form in P2P_FORMS:
        _p2p_probe(form)
    _nccl_one_rank()


if __name__ == "__main__":
    main()
