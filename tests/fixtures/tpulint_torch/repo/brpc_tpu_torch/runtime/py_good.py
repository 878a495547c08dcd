"""py-blocking negative: waits that do not park a worker, and a justified
bootstrap sleep."""

import threading
import time

_ev = threading.Event()


def handle(request):
    _ev.wait(0)  # a poll, not a park
    return len(request)


def bootstrap():
    # Runs before any handler exists.  tpulint: allow(py-blocking)
    time.sleep(0.05)
