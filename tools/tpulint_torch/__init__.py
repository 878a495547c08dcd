"""tpulint over the PyTorch/CUDA port (brpc_tpu_torch/).

tools/tpulint's Python rules read only the JAX package's tree; this
package runs them over the port through a context that reads their
``brpc_tpu/`` selectors as ``brpc_tpu_torch/``, and adds torch twins of
the two JAX-specific rules (see rules.py).

Usage:  python -m tools.tpulint_torch [paths...] [--format text|json]
"""

from tools.tpulint_torch.core import PortContext, run_lint  # noqa: F401
