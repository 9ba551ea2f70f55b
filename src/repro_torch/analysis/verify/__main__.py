"""The verify driver (the JAX package's ``tools/verify.py``): the port's
static passes over its own tree.

    python -m repro_torch.analysis.verify --all          # every pass, text
    python -m repro_torch.analysis.verify --all --json   # machine-readable
    python -m repro_torch.analysis.verify --schedule     # race detector
    python -m repro_torch.analysis.verify --kernels      # CUDA launch checker
    python -m repro_torch.analysis.verify --conventions  # AST linter

Exits with 1 exactly when a pass reports an error. The schedule pass
lowers every MoE arch and checks its emission orders
(``schedule_check.check_model_archs``); the kernel pass checks every
kernel's launch models, the ``hopper_path`` gates against TMA's
alignment, the tuner's plan gate and the knob legalization's fixed
point (``kernel_check.check_all``); the conventions pass lints
``src/repro_torch`` (or ``--root``).
"""
import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.verify",
        description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="run every pass (the default when none is named)")
    ap.add_argument("--schedule", action="store_true",
                    help="schedule-IR race detector")
    ap.add_argument("--kernels", action="store_true",
                    help="CUDA launch resource checker")
    ap.add_argument("--conventions", action="store_true",
                    help="convention linter")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON")
    ap.add_argument("--root", default="",
                    help="tree to lint (default: the port's package)")
    args = ap.parse_args(argv)
    if not (args.schedule or args.kernels or args.conventions):
        args.all = True

    from repro_torch.analysis.verify.diagnostics import Report
    report = Report()
    if args.all or args.schedule:
        from repro_torch.analysis.verify import schedule_check
        report.extend(schedule_check.check_model_archs())
    if args.all or args.kernels:
        from repro_torch.analysis.verify import kernel_check
        report.extend(kernel_check.check_all())
    if args.all or args.conventions:
        from repro_torch.analysis.verify import conventions
        report.extend(conventions.lint_tree(args.root or None))
    print(report.to_json() if args.json else report.text())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
