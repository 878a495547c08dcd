"""A JAX-package file that tools/tpulint reads and the port linter must
not report."""

import time


def handle(request):
    time.sleep(0.01)
