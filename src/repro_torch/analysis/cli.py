"""Command-line front-end: ``python -m repro_torch.analysis {audit,fsck}``.

The counterpart of the JAX package's ``python -m repro.analysis``, with its
flags and exit status, plus ``--device`` (default ``cuda``: the kernels on
the card; ``cpu`` runs the plain versions).  Exit status is the CI
contract: 0 = no non-baselined gating findings, 1 = new findings (the build
should fail), 2 = usage error.  ``--write-baseline`` records the current
gating findings as accepted and exits 0: commit the file to move the gate.
The port's baseline is its own file, ``analysis_baseline_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import Optional

import numpy as np

from .findings import Report, load_baseline, partition, write_baseline

DEFAULT_BASELINE = "analysis_baseline_torch.json"


def build_synthetic_store(root, device="cuda"):
    """A small but fully-featured store for self-checks: a main line of
    commits, a side branch, a tag, and a constrained repack (so every fsck
    rule, ``fsck.constraint`` included, has something to verify).  The same
    commits as the JAX package's, so the two stores are alike."""
    from ..core import OptimizeSpec
    from ..store.repository import Repository

    rng = np.random.RandomState(0)
    repo = Repository(root, device=device)
    tree = {
        "w": rng.randn(64, 64).astype(np.float32),
        "b": rng.randn(256).astype(np.float32),
    }
    repo.commit(tree, message="init")
    for i in range(3):
        tree = dict(tree)
        w = tree["w"].copy()
        w[i, :8] += 1.0
        tree["w"] = w
        repo.commit(tree, message=f"step {i}")
    repo.branch("side", at=2)
    side = dict(tree)
    side["extra"] = rng.randn(128).astype(np.float32)
    repo.commit(side, message="side work", branch="side")
    repo.tag("v1", at=3)
    # generous θ: the point is recording a constraint, not stressing it
    repo.repack(OptimizeSpec.problem(6, theta=10.0))
    return repo


def _finish(report: Report, args: argparse.Namespace) -> int:
    if args.write_baseline:
        n = write_baseline(report.findings, args.baseline,
                           note="accepted via --write-baseline")
        print(f"wrote {n} accepted finding(s) to {args.baseline}")
        return 0
    baseline = load_baseline(args.baseline)
    new, old = partition(report.findings, baseline)
    if args.json:
        old_keys = {f.key() for f in old}
        print(json.dumps({
            "tool": report.tool,
            "checked": report.checked,
            "findings": [
                dict(f.to_dict(), baselined=f.key() in old_keys)
                for f in report.findings
            ],
            "new": len(new),
        }, indent=2))
    else:
        print(report.render(baseline=baseline))
    if new:
        print(f"\n{len(new)} new finding(s) — failing. Fix them, or accept "
              f"deliberately with --write-baseline and commit "
              f"{args.baseline}.", file=sys.stderr)
        return 1
    return 0


def _cmd_audit(args: argparse.Namespace) -> int:
    from .kernel_audit import run_audit

    return _finish(run_audit(args.device), args)


def _cmd_fsck(args: argparse.Namespace) -> int:
    from .fsck import fsck_store

    if args.synthetic == (args.root is not None):
        print("fsck: pass exactly one of ROOT or --synthetic", file=sys.stderr)
        return 2
    if args.synthetic:
        with tempfile.TemporaryDirectory() as td:
            repo = build_synthetic_store(td, device=args.device)
            return _finish(fsck_store(repo.store, sample=args.sample), args)
    from ..store.version_store import VersionStore

    store = VersionStore(args.root, device=args.device)
    return _finish(fsck_store(store, sample=args.sample), args)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Analyses of the PyTorch port: 'audit' runs every kernel "
                    "wrapper and solver entry point and lints dtypes, "
                    "argument writes, host syncs and shape buckets; 'fsck' "
                    "integrity-checks a VersionStore on disk.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("audit", _cmd_audit), ("fsck", _cmd_fsck)):
        s = sub.add_parser(name)
        s.set_defaults(fn=fn)
        s.add_argument("--baseline", default=DEFAULT_BASELINE,
                       help=f"baseline file (default {DEFAULT_BASELINE}; "
                            f"missing file = empty baseline)")
        s.add_argument("--write-baseline", action="store_true",
                       help="accept current gating findings and exit 0")
        s.add_argument("--json", action="store_true",
                       help="machine-readable report on stdout")
        s.add_argument("--device", default="cuda",
                       help="where the kernels run: cuda (default; raises "
                            "without a card) or cpu (the plain versions)")
        if name == "fsck":
            s.add_argument("root", nargs="?", help="store root directory to check")
            s.add_argument("--synthetic", action="store_true",
                           help="build a throwaway synthetic store and fsck it "
                                "(CI self-check)")
            s.add_argument("--sample", type=int, default=None,
                           help="cap fingerprint re-decodes to N versions "
                                "(default: all)")
    args = p.parse_args(argv)
    return args.fn(args)
