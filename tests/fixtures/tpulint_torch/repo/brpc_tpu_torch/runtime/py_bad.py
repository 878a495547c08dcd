"""py-blocking positive: blocking calls on the port's handler path."""

import subprocess
import time


def handle(request):
    time.sleep(0.01)  # parks the fiber worker
    return subprocess.run(["true"]).returncode
