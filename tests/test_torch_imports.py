"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "brpc_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for top in (PKG, os.path.join(ROOT, "tools", "tpulint_torch")):
        for d, _dirs, names in os.walk(top):
            files += [os.path.join(d, n) for n in names
                      if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "brpc_tpu")


def test_no_file_of_the_port_imports_jax_or_brpc_tpu():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {m}"
                    for m in mods if _forbidden(m)]
    assert not bad, bad


def test_every_module_imports_with_jax_and_brpc_tpu_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['brpc_tpu'] = None\n"
        "import brpc_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    brpc_tpu_torch.__path__, 'brpc_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'brpc_tpu_torch.runtime.param_server' in names\n"
        "assert 'brpc_tpu_torch.models.tensor_service' in names\n"
        "assert 'brpc_tpu_torch.ops.ring_attention' in names\n"
        "for n in ('serving.router', 'serving.fleet',\n"
        "          'observability.fleet_view'):\n"
        "    assert 'brpc_tpu_torch.' + n in names, n\n"
        "from brpc_tpu_torch.serving import (FleetServingServer,\n"
        "    FleetTokenStream, ServingFleetClient, ServingRouter)\n"
        "from brpc_tpu_torch.fleet import FleetObserver\n"
        "from brpc_tpu_torch.observability import (RpczDisabled,\n"
        "    dump_prometheus, dump_rpcz, rpcz_set_sample_1_in_n)\n"
        "from brpc_tpu_torch.observability.metrics import (dump_fibers,\n"
        "    dump_ici)\n"
        "from brpc_tpu_torch.observability.tracing import find_trace\n"
        "from brpc_tpu_torch.runtime.native import E_DRAINING\n"
        "assert not any(m.split('.')[0] in ('jax', 'brpc_tpu')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 53


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    from brpc_tpu_torch.runtime.param_server import (ParameterClient,
                                                     ParameterServer)
    from brpc_tpu_torch.runtime.state import state_from_numpy
    from brpc_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ParameterServer({"w": np.zeros(8, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_numpy({"w": np.zeros(8, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ParameterClient("tpu://127.0.0.1:1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    # The multi-rank launcher: one card per rank unless asked for gloo.
    from brpc_tpu_torch.parallel.launch import run_ranks

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(1, print)


@pytest.mark.parametrize("entry", ["flagship_entry", "init_state",
                                   "LayeredMLP", "dryrun_multichip",
                                   "flash_init", "psstate_from_numpy",
                                   "layered_params_from_numpy"])
def test_slice_two_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    from brpc_tpu_torch.models import tensor_service as ts
    from brpc_tpu_torch.ops.flash_attention import flash_init
    from brpc_tpu_torch.runtime import state

    calls = {
        "flagship_entry": lambda: ts.flagship_entry(),
        "init_state": lambda: ts.init_state(torch.Generator(), 4, 8, 2),
        "LayeredMLP": lambda: ts.LayeredMLP((4, 2)),
        "dryrun_multichip": lambda: ts.dryrun_multichip(1),
        "flash_init": lambda: flash_init(1, 1, 4, 8),
        "psstate_from_numpy": lambda: state.psstate_from_numpy(
            {f: np.zeros(2, np.float32) for f in ts.PSState._fields}),
        "layered_params_from_numpy": lambda: state.layered_params_from_numpy(
            {"layer00": np.zeros((2, 2), np.float32)}),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_fleet_serving_server_defaults_to_cuda_and_raises_without_it():
    """A serving fleet member runs its engine on the card unless told
    otherwise, and raises before it opens a server or an arena."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves")
    from brpc_tpu_torch.runtime import native
    from brpc_tpu_torch.serving import FleetServingServer

    live = len(native._LIVE_SERVERS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetServingServer("127.0.0.1:1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetServingServer("127.0.0.1:1", role="prefill", device="cuda")
    assert len(native._LIVE_SERVERS) == live


def test_cpu_tensors_never_build_or_load_the_kernels():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: another test may load the kernels")
    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.ops import flash_attention as fa
    from brpc_tpu_torch.ops.fused_update import fused_momentum_update
    from brpc_tpu_torch.ops.quantize import dequantize_blocks

    x = torch.ones(300)
    fused_momentum_update(x, x, x)
    dequantize_blocks(torch.ones(300, dtype=torch.int8), torch.ones(2),
                      block=256, n=300, shape=(300,))
    q = torch.ones(1, 2, 8, 4)
    launches = fa.LAUNCHES.value
    fa.flash_attention_carry(q, q, q, *fa.flash_init(1, 2, 8, 4,
                                                     device="cpu"),
                             torch.zeros(2, dtype=torch.int32), causal=True)
    assert fa.LAUNCHES.value == launches
    assert _build._lib is None  # no nvcc looked for, nothing loaded
