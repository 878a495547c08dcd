"""The port's public surface against the JAX package's, read with ``ast``
(neither package is imported).

Every public function, class and method (``__init__`` included) of every
module of brpc_tpu/ has a counterpart of the same name in the same module
of brpc_tpu_torch/, and the counterpart takes every parameter the JAX one
takes (the port may add some, such as ``device``). Methods are looked up
through base classes defined in the same module. The exceptions are the
allow-list below, one entry for each idiom difference, each with its
reason; an entry that no longer matches a difference fails the test, so
the list cannot outlive what it excuses.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "brpc_tpu")
PORT_PKG = os.path.join(ROOT, "brpc_tpu_torch")

# Modules that wrap JAX itself and mean nothing without it: the spelling of
# shard_map and of Pallas's TPU compiler parameters across JAX versions, and
# XLA's virtual CPU devices. The port has no counterpart by design.
JAX_ONLY_MODULES = {
    "utils/compat.py": "JAX-version shims (shard_map, Pallas TPU params)",
    "utils/platform.py": "forces XLA's virtual CPU devices",
}

# The allow-list: {reason: {(module, qualname): {jax param: port param or
# None when the port has no counterpart}}}.
ALLOWED = {
    "rng -> generator: torch.Generator replaces the JAX PRNG key": {
        ("models/decoder.py", "init_decoder"): {"rng": "generator"},
        ("models/tensor_service.py", "init_state"): {"rng": "generator"},
    },
    "make_mesh(devices=): one process per rank, so the mesh spans the "
    "process group's ranks, not a list of devices": {
        ("parallel/mesh.py", "make_mesh"): {"devices": None},
        ("parallel/mesh.py", "ring_mesh"): {"devices": None},
    },
    "to_host= -> device='cpu': a host copy is a pull onto the CPU device": {
        ("runtime/param_server.py", "ParameterClient.pull_all"):
            {"to_host": "device"},
        ("runtime/tensor.py", "consume_oneside_payload"):
            {"to_host": "device"},
    },
    "interpret=: Pallas's interpreter; a port wrapper takes its plain "
    "version for CPU tensors instead": {
        ("ops/flash_attention.py", "flash_attention"): {"interpret": None},
        ("ops/flash_attention.py", "flash_attention_carry"):
            {"interpret": None},
        ("ops/fused_update.py", "fused_momentum_update"): {"interpret": None},
        ("ops/quantize.py", "dequantize_blocks"): {"interpret": None},
    },
    "StagedMLP.set_param(arr -> t): it takes a torch tensor": {
        ("models/pipeline.py", "StagedMLP.set_param"): {"arr": "t"},
    },
}

def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _public(name):
    return not name.startswith("_") or name == "__init__"


def _surface(path):
    """{qualname: params (None for a class), ...} and {qualname: node}."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def methods(cls, seen=()):
        out = {}
        for base in cls.bases:  # bases of the same module, nearest last
            if (isinstance(base, ast.Name) and base.id in classes
                    and base.id not in seen):
                out.update(methods(classes[base.id], seen + (cls.name,)))
        for sub in cls.body:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[sub.name] = sub
        return out

    surface, nodes = {}, {}
    for node in tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not node.name.startswith("_")):
            surface[node.name] = _params(node)
            nodes[node.name] = node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            surface[node.name] = None
            for name, fn in methods(node).items():
                if _public(name):
                    surface[f"{node.name}.{name}"] = _params(fn)
                    nodes[f"{node.name}.{name}"] = fn
    return surface, nodes


def _modules(pkg):
    out = []
    for d, _dirs, names in os.walk(pkg):
        out += [os.path.relpath(os.path.join(d, n), pkg)
                for n in names if n.endswith(".py")]
    return sorted(out)


JAX_MODULES = _modules(JAX_PKG)


def _allowed(module, qualname):
    merged = {}
    for sites in ALLOWED.values():
        merged.update(sites.get((module, qualname), {}))
    return merged


def test_every_jax_module_has_a_port_module():
    port = set(_modules(PORT_PKG))
    missing = [m for m in JAX_MODULES if m not in port]
    assert sorted(missing) == sorted(JAX_ONLY_MODULES), missing


@pytest.mark.parametrize("module", [m for m in JAX_MODULES
                                    if m not in JAX_ONLY_MODULES])
def test_module_surface_matches(module):
    jax_surface, _ = _surface(os.path.join(JAX_PKG, module))
    port_surface, _ = _surface(os.path.join(PORT_PKG, module))
    problems = []
    for qualname, jparams in sorted(jax_surface.items()):
        if qualname not in port_surface:
            problems.append(f"{qualname}: missing from the port")
            continue
        if jparams is None:
            continue
        tparams = port_surface[qualname]
        allowed = _allowed(module, qualname)
        for p in jparams:
            if p in tparams:
                continue
            if p in allowed:
                repl = allowed[p]
                if repl is not None and repl not in tparams:
                    problems.append(f"{qualname}: {p} -> {repl}, but the "
                                    f"port takes {tparams}")
                continue
            problems.append(f"{qualname}: the port does not take {p!r} "
                            f"(takes {tparams})")
    assert not problems, "\n".join(problems)


def test_allow_list_entries_are_still_needed():
    """Each entry names a parameter the JAX side takes and the port does
    not, so a port that closes a gap must drop its entry."""
    stale = []
    for reason, sites in ALLOWED.items():
        for (module, qualname), params in sites.items():
            jax_surface, _ = _surface(os.path.join(JAX_PKG, module))
            port_surface, _ = _surface(os.path.join(PORT_PKG, module))
            for p in params:
                if (p not in (jax_surface.get(qualname) or ())
                        or p in (port_surface.get(qualname) or ())):
                    stale.append(f"{module}::{qualname}({p}) [{reason}]")
    assert not stale, stale


def test_pending_parameters_are_taken_and_refused():
    """Nothing is left pending: no public function or method of the port
    takes a parameter only to refuse it with NotImplementedError (the
    last one, ``LayeredMLP(mesh=)``, now runs)."""
    refused = []
    for module in _modules(PORT_PKG):
        _s, nodes = _surface(os.path.join(PORT_PKG, module))
        for qualname, node in nodes.items():
            if any(isinstance(n, ast.Raise) and n.exc is not None
                   and "NotImplementedError" in ast.dump(n.exc)
                   for n in ast.walk(node)):
                refused.append(f"{module}::{qualname}")
    assert not refused, refused
