"""brpc_tpu_torch — the PyTorch/CUDA data plane of the RPC framework.

The same C++ host runtime (``native/``: fibers, IOBuf, tbvar, trpc and the
shared-memory ``tpu://`` transport) carries tensors whose device side is
``torch`` on an NVIDIA GPU. Module layout and names follow ``brpc_tpu``
so each counterpart is easy to find; nothing here imports ``jax`` or
``brpc_tpu``.

Entry points place tensors on ``device="cuda"`` unless the caller names
``"cpu"``, and raise when CUDA is asked for and absent
(:func:`brpc_tpu_torch.utils.device.resolve_device`).
"""
