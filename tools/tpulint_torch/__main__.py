"""CLI: python -m tools.tpulint_torch [paths...] [options]

Exit status: 0 clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import os
import sys

from tools.tpulint.report import render_json, render_text
from tools.tpulint_torch.core import DEFAULT_PATHS, run_lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpulint_torch",
        description="tpulint's Python rules and their torch twins over "
                    "the PyTorch/CUDA port (see tools/tpulint_torch)")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"paths to scan, relative to --root (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--root", default=None,
                    help="lint root (default: the repo holding this tool)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)
    root = args.root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    findings = run_lint(root, tuple(args.paths or DEFAULT_PATHS))
    render = render_json if args.format == "json" else render_text
    sys.stdout.write(render(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
