"""Finding / baseline framework of the port's analyses (fsck for now).

The port's own copy of the JAX package's ``repro.analysis.findings``, with
the same rule ids, severities, keys and baseline file format.

A :class:`Finding` is one typed violation: a rule id, a severity, a *stable*
subject (the thing that is wrong — a version id, an object, a ref name;
never a line number, which churns), a human message, and a fix hint.
``Finding.key()`` — ``"rule::subject"`` — is the identity the baseline file
stores, so a finding stays recognized across unrelated edits.

Baselines make the analyses usable as a CI *regression* gate: a committed
baseline file records the findings a repo has accepted (with a note per
entry), and :func:`partition` splits a fresh run into ``new`` (fail the
build) vs ``baselined`` (known, tolerated).  Only findings at WARNING or
above gate; NOTE-level findings are informational and never need
baselining.

Workflow::

    report = fsck_store(store)
    new, old = partition(report.findings, load_baseline(path))
    if new: fail CI, printing each finding + fix hint
    # to accept a finding deliberately:
    write_baseline(report.findings, path)     # then commit the file
"""

from __future__ import annotations

import dataclasses
import enum
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union


class Severity(enum.IntEnum):
    """How bad a finding is; only WARNING and above gate CI."""

    NOTE = 10      # informational / allowlisted — never gates
    WARNING = 20   # should be fixed; gates unless baselined
    ERROR = 30     # correctness hazard; gates unless baselined

    def __str__(self) -> str:  # "error" in reports and JSON
        return self.name.lower()


#: findings at or above this severity gate CI (NOTE never does)
GATE_SEVERITY = Severity.WARNING


@dataclasses.dataclass(frozen=True)
class Finding:
    """One typed analysis violation."""

    rule: str        # e.g. "audit.dtype64" / "fsck.cycle"
    severity: Severity
    subject: str     # stable id: target/module/vid/ref — never a line number
    message: str
    fix_hint: str = ""

    def key(self) -> str:
        """Baseline identity: stable across unrelated edits."""
        return f"{self.rule}::{self.subject}"

    def gates(self) -> bool:
        return self.severity >= GATE_SEVERITY

    def to_dict(self) -> Dict[str, str]:
        return {
            "rule": self.rule,
            "severity": str(self.severity),
            "subject": self.subject,
            "message": self.message,
            "fix_hint": self.fix_hint,
        }

    def render(self) -> str:
        hint = f"\n      fix: {self.fix_hint}" if self.fix_hint else ""
        return (
            f"[{str(self.severity).upper():7s}] {self.rule}  {self.subject}\n"
            f"      {self.message}{hint}"
        )


@dataclasses.dataclass
class Report:
    """The result of one analysis pass: findings + what was covered.

    ``checked`` counts subjects examined per rule (so "0 findings" is
    distinguishable from "0 targets") — an auditor that silently traced
    nothing would otherwise read as a clean bill of health.
    """

    tool: str                       # "audit" | "fsck"
    findings: List[Finding] = dataclasses.field(default_factory=list)
    checked: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def bump(self, rule: str, n: int = 1) -> None:
        self.checked[rule] = self.checked.get(rule, 0) + n

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def gating(self) -> List[Finding]:
        return [f for f in self.findings if f.gates()]

    def render(self, *, baseline: Optional[Dict[str, dict]] = None) -> str:
        new, old = partition(self.findings, baseline or {})
        lines = [
            f"repro_torch.analysis {self.tool}: "
            f"{sum(self.checked.values())} checks over "
            f"{len(self.checked)} rules — "
            f"{len(new)} new finding(s), {len(old)} baselined, "
            f"{len(self.findings) - len(new) - len(old)} note(s)"
        ]
        for f in self.findings:
            tag = ""
            if f in old:
                tag = "  (baselined)"
            lines.append(f.render() + tag)
        return "\n".join(lines)


# ----------------------------------------------------------------- baseline
BASELINE_VERSION = 1


def load_baseline(path: Union[str, Path, None]) -> Dict[str, dict]:
    """Load a baseline file -> {finding key: entry}; missing file = empty."""
    if path is None:
        return {}
    p = Path(path)
    if not p.exists():
        return {}
    obj = json.loads(p.read_text())
    if obj.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported baseline version {obj.get('version')!r} in {p} "
            f"(expected {BASELINE_VERSION})"
        )
    return dict(obj.get("findings", {}))


def write_baseline(
    findings: Sequence[Finding], path: Union[str, Path], *, note: str = ""
) -> int:
    """Write the gating findings as the new accepted baseline; returns count.

    Only gating findings are recorded — NOTE-level entries never need
    accepting.  Entries keep the message at time of acceptance so a later
    reader knows what was tolerated and why.
    """
    entries = {
        f.key(): {
            "severity": str(f.severity),
            "message": f.message,
            "note": note,
        }
        for f in findings
        if f.gates()
    }
    blob = json.dumps(
        {"version": BASELINE_VERSION, "findings": entries},
        indent=2,
        sort_keys=True,
    )
    Path(path).write_text(blob + "\n")
    return len(entries)


def partition(
    findings: Iterable[Finding], baseline: Dict[str, dict]
) -> Tuple[List[Finding], List[Finding]]:
    """Split gating findings into (new, baselined).

    NOTE-level findings appear in neither list — they are informational.
    A baselined entry whose severity *increased* since acceptance counts as
    new again (an accepted WARNING that became an ERROR must re-gate).
    """
    new: List[Finding] = []
    old: List[Finding] = []
    order = {"note": Severity.NOTE, "warning": Severity.WARNING,
             "error": Severity.ERROR}
    for f in findings:
        if not f.gates():
            continue
        ent = baseline.get(f.key())
        if ent is not None and order.get(ent.get("severity", "note"),
                                        Severity.NOTE) >= f.severity:
            old.append(f)
        else:
            new.append(f)
    return new, old
