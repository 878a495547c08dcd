"""Fleet collectives: ring/tree allreduce + allgather over the tensor
wire — the port of brpc_tpu/collectives.

Layering (pure -> wire):

  * :mod:`~brpc_tpu_torch.collectives.ring` — chunk spans and hop
    schedules, pure arithmetic;
  * :mod:`~brpc_tpu_torch.collectives.quant` — per-chunk per-hop
    quantization with cross-step error feedback (EQuARX's
    dequant/reduce/requant);
  * :mod:`~brpc_tpu_torch.collectives.core` — transport-agnostic
    algorithms + mailbox + the per-chunk-salvage failure contract;
  * :mod:`~brpc_tpu_torch.collectives.group` — :class:`CollectiveGroup`,
    the registry-membered, per-peer-channeled, QoS/overload/trace-
    integrated real thing (loaded on first use: it needs the native
    library).
"""

from brpc_tpu_torch.collectives.core import (CollectiveAborted,  # noqa: F401
                                             CollectiveTimeout, E_COLL_ABORT,
                                             E_COLL_EPOCH, Mailbox,
                                             MemberLeft, ring_allgather,
                                             ring_allreduce,
                                             ring_reduce_scatter,
                                             tree_allreduce, tree_broadcast)
from brpc_tpu_torch.collectives.quant import ChunkCodec  # noqa: F401
from brpc_tpu_torch.collectives.ring import (allgather_steps,  # noqa: F401
                                             chunk_spans, fragment_spans,
                                             owned_chunk, reduce_order,
                                             reduce_scatter_steps,
                                             ring_order)

__all__ = [
    "CollectiveAborted", "CollectiveTimeout", "MemberLeft", "Mailbox",
    "ChunkCodec", "CollectiveGroup", "collective_metrics",
    "E_COLL_ABORT", "E_COLL_EPOCH",
    "ring_allreduce", "ring_allgather", "ring_reduce_scatter",
    "tree_allreduce", "tree_broadcast",
    "chunk_spans", "fragment_spans", "ring_order", "owned_chunk",
    "reduce_order", "reduce_scatter_steps", "allgather_steps",
]


def __getattr__(name):
    if name in ("CollectiveGroup", "collective_metrics"):
        from brpc_tpu_torch.collectives import group as _g

        return getattr(_g, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
