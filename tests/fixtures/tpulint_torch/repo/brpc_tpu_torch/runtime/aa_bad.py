"""arena-alias-torch positive: tensors over arena/wire pages handed to
asynchronous copies, and one returned past the view's release()."""

import numpy as np
import torch


def h2d_async(view, dev):
    host = np.frombuffer(view.data, np.float32)
    t = torch.from_numpy(host)
    return t.to(dev, non_blocking=True)


def cuda_async(buf):
    t = torch.frombuffer(memoryview(buf), dtype=torch.float32)
    return t.reshape(-1).cuda(non_blocking=True)


def copy_async(out, view):
    out.copy_(torch.from_numpy(np.frombuffer(view.data, np.uint8)),
              non_blocking=True)


def past_release(view):
    t = torch.from_numpy(np.frombuffer(view.data, np.float32))
    view.release()
    return t
