"""The port linter's context and driver.

tools/tpulint's Python rules select the JAX package by path prefix
(``brpc_tpu/runtime/``, ``brpc_tpu/serving/``, ...), which never matches
``brpc_tpu_torch/``. :class:`PortContext` is a ``LintContext`` whose
``select`` reads each ``brpc_tpu/`` prefix as the same place in the port,
so the rules run over the port's files unchanged and report the port's
real paths: no rule body is copied and no finding is mapped back.
"""

from __future__ import annotations

from dataclasses import dataclass

from tools.tpulint.core import Finding, LintContext, collect_files
from tools.tpulint_torch.rules import RULES

JAX_PREFIX = "brpc_tpu/"
PORT_PREFIX = "brpc_tpu_torch/"

# Scanned when the caller names no paths: the port, and the native tree
# the error-code registry is read from.
DEFAULT_PATHS = ("native", "brpc_tpu_torch")


def _to_port(prefixes, keep_jax: bool) -> tuple:
    out = []
    for p in prefixes:
        if p.startswith(JAX_PREFIX):
            out.append(PORT_PREFIX + p[len(JAX_PREFIX):])
            if keep_jax:
                out.append(p)
        else:
            out.append(p)
    return tuple(out)


@dataclass
class PortContext(LintContext):
    """``select(under=("brpc_tpu/x/",))`` returns the files under
    ``brpc_tpu_torch/x/`` — and, with ``keep_jax``, those under
    ``brpc_tpu/x/`` too (the metric rules' one shared registry)."""

    keep_jax: bool = False

    def select(self, *, under=(), ext=None, exclude_under=()):
        return super().select(under=_to_port(under, self.keep_jax), ext=ext,
                              exclude_under=_to_port(exclude_under, False))


def port_context(root: str, paths=DEFAULT_PATHS,
                 keep_jax: bool = False) -> PortContext:
    paths = tuple(paths)
    if keep_jax and "brpc_tpu" not in paths:
        # Before the port: a collision is reported at its second site,
        # which is then the port's.
        paths = ("brpc_tpu",) + paths
    return PortContext(root=root, files=collect_files(root, paths),
                       keep_jax=keep_jax)


def run_lint(root: str, paths=None, rules=None) -> list[Finding]:
    """Every rule over the port under ``root``; returns the unsuppressed
    findings in port files, sorted by location. A rule that reads the
    JAX tree too (``keep_jax``) sees it, but only the port's findings are
    reported: the JAX tree is tools/tpulint's."""
    paths = tuple(paths or DEFAULT_PATHS)
    contexts = {}
    findings: list[Finding] = []
    for rule in (rules if rules is not None else RULES):
        keep = getattr(rule, "keep_jax", False)
        if keep not in contexts:
            contexts[keep] = port_context(root, paths, keep)
        ctx = contexts[keep]
        by_path = {f.path: f for f in ctx.files}
        for f in rule.run(ctx):
            if not f.path.startswith(PORT_PREFIX):
                continue
            src = by_path.get(f.path)
            if src is not None:
                if src.allowed(f.rule, f.line):
                    continue
                if not f.snippet:
                    f.snippet = src.snippet(f.line)
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
