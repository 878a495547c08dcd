"""The port linter's rules.

Reused from tools/tpulint, run over the port through ``PortContext``:
``py-blocking`` and ``negotiation`` (runtime/), ``state-machine`` and
``block-account`` (serving/, fleet/), ``error-code`` and ``metric-name``
(the latter over both packages: their series share one native registry).

New here:

* ``metric-namespace-torch`` — every series the port registers carries
  ``torch_``, so no port series can take a JAX one's name (the collision
  itself is ``metric-name``'s);
* ``arena-alias-torch`` — the torch twin of ``arena-alias``: a tensor made
  by ``torch.from_numpy``/``torch.frombuffer`` over an arena or wire view
  (``np.frombuffer``/``memoryview``, no copy between) handed to an
  asynchronous copy (``.to(..., non_blocking=True)``,
  ``.cuda(non_blocking=True)``, ``copy_(..., non_blocking=True)``), or
  returned after the view's ``release()``: the copy may read the pages
  after the arena hands them to the next message. The blessed helpers in
  brpc_tpu_torch/runtime/tensor.py own that decision and are exempt;
* ``regime-graph-torch`` — the torch twin of ``regime-graph``: a
  ``step_sched`` node on a wire lane whose body launches device work (a
  call into ``brpc_tpu_torch.ops``, a ``torch.<op>`` call, or the
  harness's forward/backward/grads/place). Kernel launches from a wire
  thread contend with the compute lane for the interpreter lock.
"""

from __future__ import annotations

import ast
import copy

from tools.tpulint.core import Finding, LintContext
from tools.tpulint.rules_codes import ErrorCodeRule
from tools.tpulint.rules_metrics import (_PY_CAPI_RE, _PY_METRIC_RECEIVERS,
                                        _PY_REG_RE, MetricNameRule)
from tools.tpulint.rules_negotiation import NegotiationRule
from tools.tpulint.rules_py import PyBlockingRule, RegimeGraphRule
from tools.tpulint.rules_state import BlockAccountRule, SessionStateRule

PORT_TREE = "brpc_tpu/"  # read as brpc_tpu_torch/ by PortContext
PORT_METRIC_PREFIX = "torch_"


class SharedRegistryMetricNameRule(MetricNameRule):
    """``metric-name`` over native/, the JAX package and the port at
    once: a port series named like a JAX or native one collides."""

    keep_jax = True


class MetricNamespaceRule:
    id = "metric-namespace-torch"
    description = ("a metric the port registers whose name does not "
                   f"start with {PORT_METRIC_PREFIX!r}")

    def run(self, ctx: LintContext):
        findings = []
        for src in ctx.select(under=(PORT_TREE,), ext={".py"}):
            for lineno, line in enumerate(src.code_lines(), 1):
                for pat in (_PY_REG_RE, _PY_CAPI_RE):
                    for m in pat.finditer(line):
                        receiver = m.group(1)
                        if receiver and not any(
                                part in _PY_METRIC_RECEIVERS
                                or "observability" in part
                                for part in receiver.split(".")):
                            continue  # someone else's API
                        name = (m.group(2) or m.group(3)).replace(".", "_")
                        if name.startswith(PORT_METRIC_PREFIX):
                            continue
                        findings.append(Finding(
                            rule=self.id, path=src.path, line=lineno,
                            message=f"port metric \"{name}\" lacks the "
                                    f"{PORT_METRIC_PREFIX!r} prefix",
                            hint="the port's series share one registry "
                                 "with the JAX package's; prefix it "
                                 f"{PORT_METRIC_PREFIX!r} so the two "
                                 "never claim one name"))
        return findings


# ---------------------------------------------------------------------------
# arena-alias-torch
# ---------------------------------------------------------------------------

_VIEW_MAKERS = {"frombuffer", "memoryview"}          # always a view
_VIEW_KEEPERS = {"from_numpy", "reshape", "view", "view_as", "narrow",
                 "flatten", "contiguous", "detach", "as_strided",
                 "squeeze", "unsqueeze", "permute", "transpose", "t"}
_ASYNC_SINKS = {"to", "cuda"}


def _call_name(fn) -> str:
    return fn.attr if isinstance(fn, ast.Attribute) else \
        fn.id if isinstance(fn, ast.Name) else ""


def _is_view(node, tainted) -> bool:
    """Does this expression still view somebody else's pages? A view
    stays one through torch.from_numpy and the shape/stride methods;
    anything else (clone, copy, np.array, arithmetic) is a copy."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Subscript):
        return _is_view(node.value, tainted)
    if isinstance(node, ast.Attribute) and node.attr in ("T", "data"):
        return _is_view(node.value, tainted)
    if isinstance(node, ast.Call):
        name = _call_name(node.func)
        if name in _VIEW_MAKERS:
            return True
        if name in _VIEW_KEEPERS:
            return any(_is_view(a, tainted) for a in node.args) or (
                isinstance(node.func, ast.Attribute)
                and _is_view(node.func.value, tainted))
    return False


def _non_blocking(call: ast.Call) -> bool:
    return any(k.arg == "non_blocking" and isinstance(k.value, ast.Constant)
               and k.value.value is True for k in call.keywords)


class ArenaAliasTorchRule:
    id = "arena-alias-torch"
    description = ("a tensor over arena/wire pages handed to a "
                   "non_blocking copy, or returned past the view's "
                   "release()")

    def run(self, ctx: LintContext):
        findings: list[Finding] = []
        for src in ctx.select(under=(PORT_TREE,), ext={".py"}):
            if src.path.endswith("runtime/tensor.py"):
                continue  # the blessed helpers own the alias decision
            try:
                tree = ast.parse(src.text)
            except SyntaxError:
                continue
            for fn in ast.walk(tree):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    findings.extend(self._check_fn(src, fn))
        return findings

    def _check_fn(self, src, fn):
        # Statements in source order, not descending into nested defs
        # (each is checked on its own).
        nodes = []
        stack = list(reversed(fn.body))
        while stack:
            node = stack.pop()
            nodes.append(node)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            stack.extend(reversed(list(ast.iter_child_nodes(node))))
        tainted: set[str] = set()
        released = False
        out = []
        for node in nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                if _is_view(node.value, tainted):
                    tainted.add(node.targets[0].id)
                else:
                    tainted.discard(node.targets[0].id)
            elif isinstance(node, ast.Call):
                name = _call_name(node.func)
                if name == "release" and not node.args:
                    released = True
                elif name in _ASYNC_SINKS and _non_blocking(node) and \
                        isinstance(node.func, ast.Attribute) and \
                        _is_view(node.func.value, tainted):
                    out.append(self._finding(src, node, f".{name}("
                                             "non_blocking=True)"))
                elif name == "copy_" and _non_blocking(node) and \
                        node.args and _is_view(node.args[0], tainted):
                    out.append(self._finding(src, node,
                                             "copy_(non_blocking=True)"))
            elif isinstance(node, ast.Return) and released and \
                    node.value is not None and \
                    _is_view(node.value, tainted):
                out.append(Finding(
                    rule=self.id, path=src.path, line=node.lineno,
                    message="returns a view of arena/wire pages after the "
                            "view's release(): the caller reads pages the "
                            "arena may already have handed on",
                    hint="copy before release (.clone(), np.array) or "
                         "return before releasing"))
        return out

    def _finding(self, src, node, what):
        return Finding(
            rule=self.id, path=src.path, line=node.lineno,
            message=f"{what} over arena/wire pages: the copy runs after "
                    "the call returns, and may read the pages after the "
                    "arena recycles them",
            hint="copy synchronously (non_blocking=False), detach first "
                 "(.clone()), or go through the helpers in "
                 "brpc_tpu_torch/runtime/tensor.py")


# ---------------------------------------------------------------------------
# regime-graph-torch
# ---------------------------------------------------------------------------

_OPS_MODULE = "brpc_tpu_torch.ops"
_HARNESS_METHODS = {"forward", "backward", "grads", "place"}
# torch.<fn> calls that make no device work of their own.
_HOST_TORCH = {"from_numpy", "frombuffer", "is_tensor", "device", "dtype",
               "Generator", "no_grad", "enable_grad", "inference_mode",
               "get_num_threads", "set_num_threads", "Size"}
_MARK = "__tpulint_device_work__"


def _ops_names(tree) -> set:
    """Names bound to the port's kernel modules or their functions."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == _OPS_MODULE or mod.startswith(_OPS_MODULE + ".") \
                    or (mod == "brpc_tpu_torch"
                        and any(a.name == "ops" for a in node.names)):
                out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(_OPS_MODULE) and a.asname:
                    out.add(a.asname)
    return out


def _torch_names(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.asname or a.name for a in node.names
                    if a.name == "torch"}
    return out


class _MarkDeviceWork(ast.NodeTransformer):
    """Replaces each call that launches device work with a call of
    ``_MARK``, so RegimeGraphRule's dispatch test (a call of an alias)
    finds exactly those; and binds each ``for`` target to its iterable
    (``make = <iter>`` before the loop), so a node body picked by a loop
    variable (``for stage, make in (("push", make_push), ...)``) resolves
    through RegimeGraphRule's one-hop assignment lookup."""

    def visit_For(self, node):
        self.generic_visit(node)
        targets = [t for t in ast.walk(node.target)
                   if isinstance(t, ast.Name)]
        binds = [ast.copy_location(ast.Assign(
            targets=[ast.Name(id=t.id, ctx=ast.Store())],
            value=node.iter), node) for t in targets]
        return binds + [node]

    def __init__(self, ops: set, torch_names: set):
        self.ops, self.torch = ops, torch_names

    def _device_work(self, node: ast.Call) -> bool:
        fn = node.func
        if isinstance(fn, ast.Name):
            return fn.id in self.ops
        if not isinstance(fn, ast.Attribute):
            return False
        base = fn.value
        if isinstance(base, ast.Name):
            if base.id in self.ops:
                return True
            if base.id in self.torch:
                return fn.attr not in _HOST_TORCH
            if base.id == "harness":
                return fn.attr in _HARNESS_METHODS
        if isinstance(base, ast.Attribute) and base.attr == "harness":
            return fn.attr in _HARNESS_METHODS
        return False

    def visit_Call(self, node):
        self.generic_visit(node)
        if not self._device_work(node):
            return node
        return ast.copy_location(ast.Call(
            func=ast.copy_location(ast.Name(id=_MARK, ctx=ast.Load()),
                                   node.func),
            args=node.args, keywords=node.keywords), node)


class RegimeGraphTorchRule(RegimeGraphRule):
    id = "regime-graph-torch"
    description = ("step_sched node on a wire lane launches device work "
                   "off the caller's thread (interpreter-lock contention "
                   "with the compute lane)")

    def _scan(self, src, tree):
        ops, torch_names = _ops_names(tree), _torch_names(tree)
        if not ops and not torch_names:
            return []
        marked = _MarkDeviceWork(ops, torch_names).visit(copy.deepcopy(tree))
        findings = []
        self._scope(src, marked.body, {}, {}, {}, {_MARK}, findings)
        return findings

    def _finding(self, src, node):
        return Finding(
            rule=self.id, path=src.path, line=node.lineno,
            message="wire-lane step_sched node launches device work off "
                    "the caller's thread: each launch takes the "
                    "interpreter lock from the compute lane it was meant "
                    "to overlap",
            hint="launch on the COMPUTE lane (a dependent node) and keep "
                 "the wire-lane body to waits and copies, or justify with "
                 "`# tpulint: allow(regime-graph-torch)`")


RULES = [PyBlockingRule(), NegotiationRule(), SessionStateRule(),
         BlockAccountRule(), ErrorCodeRule(), SharedRegistryMetricNameRule(),
         MetricNamespaceRule(), ArenaAliasTorchRule(),
         RegimeGraphTorchRule()]
