"""What the port's two builders share: the native library's g++ copy
(runtime/native.py) and the CUDA kernels (ops/_build.py).

Both build at first use, possibly in several processes at once (test
workers, ranks on several cards), so both take ``file_lock`` around the
check and the build, and both rebuild when ``source_digest`` of their
sources no longer matches the stamp written beside the last build.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
from typing import Iterable, Optional


@contextlib.contextmanager
def file_lock(path: str):
    """An exclusive inter-process lock (``fcntl.flock``) on ``path`` for
    the scope; the file is created if missing."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)  # tpulint: allow(py-blocking)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def source_digest(root: str, paths: Iterable[str],
                  flags: Iterable[str] = ()) -> str:
    """SHA-256 over the flags and every file's bytes and path under
    ``root`` (so the digest does not depend on where the checkout is)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(paths):
        h.update(os.path.relpath(path, root).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def read_stamp(path: str) -> Optional[str]:
    """The digest stamped at ``path``, or None if there is none."""
    try:
        with open(path) as f:
            return f.read().strip()
    except FileNotFoundError:
        return None


def write_stamp(path: str, digest: str) -> None:
    with open(path, "w") as f:
        f.write(digest)
