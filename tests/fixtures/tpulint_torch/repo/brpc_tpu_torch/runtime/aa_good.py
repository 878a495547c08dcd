"""arena-alias-torch negative: detached before the async copy, a
blocking copy, and a copy returned past release()."""

import numpy as np
import torch


def h2d_async(view, dev):
    t = torch.from_numpy(np.frombuffer(view.data, np.float32)).clone()
    return t.to(dev, non_blocking=True)


def h2d_blocking(view, dev):
    t = torch.from_numpy(np.frombuffer(view.data, np.float32))
    return t.to(dev)


def copied_past_release(view):
    t = torch.from_numpy(np.array(np.frombuffer(view.data, np.float32)))
    view.release()
    return t
