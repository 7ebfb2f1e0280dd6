"""Findings and the rule registry (the counterpart of
``repro.analysis.findings``).

Every static-analysis pass of the port reports through one shape,
``Finding(rule, severity, location, message)``. ``rule`` is a stable
kebab-case id registered in :data:`RULES`, ``location`` an anchor (a
timeline item id, a wave and round of an SPMD program, a plan), and
``severity`` decides whether the finding gates (errors always; warnings
under ``strict``). The registry records rules, not pass callables.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List, Optional, Sequence


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    def __str__(self) -> str:
        return self.value


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or informational note) at one location."""
    rule: str
    severity: Severity
    location: str
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.rule} @ {self.location}: " \
               f"{self.message}"


@dataclasses.dataclass(frozen=True)
class RuleSpec:
    """Registry entry: what a rule id means and how severe a violation
    is by default."""
    name: str
    family: str                  # schedlint (the reference also has
                                 # jaxprlint and kernellint)
    description: str
    default_severity: Severity = Severity.ERROR


#: the one rule registry (id -> spec); populated by the pass modules at
#: import time via :func:`register_rule`
RULES: Dict[str, RuleSpec] = {}


def register_rule(name: str, family: str, description: str,
                  default_severity: Severity = Severity.ERROR) -> RuleSpec:
    spec = RuleSpec(name, family, description, default_severity)
    if name in RULES and RULES[name] != spec:
        raise ValueError(f"rule {name!r} registered twice with "
                         f"different specs")
    RULES[name] = spec
    return spec


def finding(rule: str, location: str, message: str,
            severity: Optional[Severity] = None) -> Finding:
    """Build a Finding for a registered rule (severity defaults to the
    rule's registered default)."""
    spec = RULES.get(rule)
    if spec is None:
        raise KeyError(f"unregistered rule {rule!r}; known: "
                       f"{sorted(RULES)}")
    return Finding(rule, severity or spec.default_severity, location,
                   message)


def filter_findings(findings: Iterable[Finding],
                    rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Keep only findings for the given rule ids (None = all)."""
    fs = list(findings)
    if rules is None:
        return fs
    wanted = set(rules)
    unknown = wanted - set(RULES)
    if unknown:
        raise KeyError(f"unknown rule(s) {sorted(unknown)}; known: "
                       f"{sorted(RULES)}")
    return [f for f in fs if f.rule in wanted]


def gate(findings: Iterable[Finding], strict: bool = False) -> bool:
    """True when the findings should fail a CI gate: any ERROR, or any
    WARNING under ``--strict`` (INFO never gates)."""
    bad = {Severity.ERROR, Severity.WARNING} if strict \
        else {Severity.ERROR}
    return any(f.severity in bad for f in findings)


def format_findings(findings: Sequence[Finding],
                    header: Optional[str] = None) -> str:
    lines = [header] if header else []
    lines += [str(f) for f in findings]
    return "\n".join(lines)
