"""Findings-based static analysis (the counterpart of ``repro.analysis``).

* :mod:`repro_torch.analysis.findings` — the :class:`Finding` spine and
  the rule registry;
* :mod:`repro_torch.analysis.schedlint` — F/B/W timeline, plan and
  emitted SPMD-program checks (ordering, overlap, frozen stages,
  activation caps, send/recv deadlock, comm-round validity, plan
  consistency).

The reference's traced-program and kernel-source passes (``jaxprlint``,
``kernellint``) and its CLI are not ported yet (ROADMAP.md queue 1 item
21).
"""
from .findings import (Finding, RuleSpec, RULES, Severity,  # noqa: F401
                       filter_findings, finding, format_findings, gate,
                       register_rule)
from .schedlint import (lint_executor_contract, lint_plan,  # noqa: F401
                        lint_spmd_program, lint_timeline)

__all__ = [
    "Finding", "RuleSpec", "RULES", "Severity", "filter_findings",
    "finding", "format_findings", "gate", "register_rule",
    "lint_executor_contract", "lint_plan", "lint_spmd_program",
    "lint_timeline",
]
