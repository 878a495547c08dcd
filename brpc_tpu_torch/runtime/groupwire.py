"""Grouped-tensor manifest framing — the ONE wire shape every grouped
tensor RPC speaks.

PR 7's PullQ established the pattern: a JSON manifest describing N
tensors rides the RPC payload, the N encoded byte runs ride concatenated
in ONE attachment, and per-name failures ride the manifest as
``{"name", "code", "error"}`` entries instead of poisoning groupmates
(the per-name salvage discipline). PushQ (the write-side twin) and the
collectives' hop writes speak the same shape; this module is its single
implementation so the three paths cannot drift:

  * each payload entry carries the tensor's self-describing metadata
    (``dtype``/``shape``, plus ``codec``/``block`` when quantized — the
    same keys ``codec.pack_header`` frames for single-tensor sends) and
    ``nbytes``, its run length in the shared attachment;
  * error entries carry ``code``/``error`` and NO payload run;
  * runs are concatenated in entry order with no padding, so the
    receiver slices by a running offset exactly like PullQ's client.

Pure numpy/json: framing and splitting need no native library. A copy
of the JAX package's module, so the two data planes speak one wire.
"""

from __future__ import annotations

import json
from typing import Iterator, List, Optional, Tuple

import numpy as np


def pack_group(entries: List[dict], blobs: List[Optional[np.ndarray]],
               extra: Optional[dict] = None) -> Tuple[bytes, np.ndarray]:
    """Frame a group: ``entries[i]`` describes ``blobs[i]`` (``None`` for
    error entries). Returns ``(manifest_bytes, concat_u8)``; the caller
    sends the manifest as the request payload and the concatenation as
    the attachment. ``extra`` merges top-level manifest keys beside
    ``tensors`` (the collectives stamp op/epoch routing there)."""
    if len(entries) != len(blobs):
        raise ValueError(f"{len(entries)} entries vs {len(blobs)} blobs")
    out_entries, runs, total = [], [], 0
    for e, b in zip(entries, blobs):
        e = dict(e)
        if b is None:
            e.pop("nbytes", None)  # error entries own no payload run
        else:
            flat = np.ascontiguousarray(b).reshape(-1).view(np.uint8)
            e["nbytes"] = int(flat.nbytes)
            runs.append(flat)
            total += flat.nbytes
        out_entries.append(e)
    doc = {"tensors": out_entries}
    if extra:
        doc.update(extra)
    concat = np.empty(total, np.uint8)
    off = 0
    for r in runs:
        concat[off:off + r.nbytes] = r
        off += r.nbytes
    return json.dumps(doc).encode(), concat


def split_group(manifest: dict, payload) -> Iterator[Tuple[dict,
                                                           Optional[np.ndarray]]]:
    """Walk a received group: yields ``(entry, run_u8_view)`` per entry
    (``None`` run for error entries). ``payload`` is the attachment as a
    1-D uint8 array/view (or ``None``/``b""`` for an all-error group —
    the PullQ zero-attachment case). Runs are zero-copy views of the
    input; detach before the view's pages can be reused. A manifest
    whose claimed runs overrun the payload raises ``ValueError`` (the
    receiver maps it to E_UNDECODABLE)."""
    if payload is None:
        buf = np.empty(0, np.uint8)
    else:
        buf = np.asarray(payload).reshape(-1).view(np.uint8)
    off = 0
    for e in manifest["tensors"]:
        if "error" in e:
            yield e, None
            continue
        nb = int(e.get("nbytes", 0))
        if off + nb > buf.nbytes:
            raise ValueError(
                f"group manifest overruns payload: entry {e.get('name')!r}"
                f" claims {nb} bytes at offset {off} of {buf.nbytes}")
        yield e, buf[off:off + nb]
        off += nb


def parse_group(request: bytes) -> dict:
    """The manifest side of the frame (request payload -> dict)."""
    return json.loads(request.decode())
