"""Finding/Report types shared by every analysis pass.

A pass emits one ``Finding`` per (rule, subject) pair it evaluated —
passing findings included, so ``ANALYSIS.json`` is a complete per-spec,
per-rule matrix and a rule that silently stopped running shows up as a
missing row, not a green report.  Failures name the spec and rule in the
same style as the conformance harness ids.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule evaluation: ``rule`` (e.g. ``'SCH001'``), ``subject``
    (spec/cell/file the rule ran against), ``ok``, and a human detail
    line (the violation for failures, the checked quantity for passes).
    ``applicable`` is False where the subject has nothing the rule could
    check (a cell without an in-place carry): not a failure, and not
    counted as a pass."""
    rule: str
    subject: str
    ok: bool
    detail: str = ''
    applicable: bool = True

    def __str__(self) -> str:
        mark = ('ok  ' if self.applicable else 'n/a ') if self.ok \
            else 'FAIL'
        return f'{mark} {self.rule} {self.subject}: {self.detail}'


@dataclasses.dataclass
class Report:
    """An ordered collection of findings from one or more passes."""
    findings: list = dataclasses.field(default_factory=list)

    def add(self, rule: str, subject: str, ok: bool, detail: str = '',
            *, applicable: bool = True):
        self.findings.append(Finding(rule, subject, ok, detail, applicable))

    def not_applicable(self, rule: str, subject: str, detail: str = ''):
        """A rule that had nothing to check on ``subject``."""
        self.add(rule, subject, True, detail, applicable=False)

    def extend(self, other: 'Report') -> 'Report':
        self.findings.extend(other.findings)
        return self

    @property
    def ok(self) -> bool:
        return all(f.ok for f in self.findings)

    @property
    def failures(self) -> list:
        return [f for f in self.findings if not f.ok]

    def counts(self, rule: str) -> tuple:
        """(ok, not applicable, failed) findings of ``rule``."""
        found = self.by_rule(rule)
        na = sum(not f.applicable for f in found)
        failed = sum(not f.ok for f in found)
        return len(found) - na - failed, na, failed

    def rules(self) -> set:
        return {f.rule for f in self.findings}

    def by_rule(self, rule: str) -> list:
        return [f for f in self.findings if f.rule == rule]

    def raise_if_failed(self) -> 'Report':
        """For library users (``analysis.verify_schedule(...)``): turn a
        failing report into one exception naming every violated rule."""
        if not self.ok:
            lines = '\n'.join(str(f) for f in self.failures)
            raise AnalysisError(
                f'{len(self.failures)} analysis finding(s) failed:\n{lines}')
        return self

    def to_dict(self) -> dict:
        by_subject: dict = {}
        for f in self.findings:
            by_subject.setdefault(f.subject, []).append(
                {'rule': f.rule, 'ok': f.ok, 'applicable': f.applicable,
                 'detail': f.detail})
        return {
            'ok': self.ok,
            'checked': len(self.findings),
            'not_applicable': sum(not f.applicable for f in self.findings),
            'failed': len(self.failures),
            'rules': sorted(self.rules()),
            'subjects': by_subject,
        }

    def to_json(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.to_dict(), indent=2, sort_keys=True)
        if path is not None:
            with open(path, 'w') as fh:
                fh.write(text + '\n')
        return text

    def summary(self) -> str:
        n_fail = len(self.failures)
        state = 'PASS' if not n_fail else f'FAIL ({n_fail} finding(s))'
        na = sum(not f.applicable for f in self.findings)
        return (f'{state}: {len(self.findings) - na} checks ({na} not '
                f'applicable) over '
                f'{len({f.subject for f in self.findings})} subjects, '
                f'{len(self.rules())} rules')


class AnalysisError(AssertionError):
    """A static contract the analyzer proves was found violated."""
