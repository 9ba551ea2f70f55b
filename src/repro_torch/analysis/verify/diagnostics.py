"""Shared diagnostic core for the verify passes (the port's copy of
``repro.analysis.verify.diagnostics``).

A :class:`Diagnostic` is one finding: which pass produced it, how bad it
is, where it points (``file:line`` for source findings, ``graph:segment``
for IR findings), what is wrong and how to fix it. :class:`Report`
aggregates findings across passes and renders them as text or JSON.

Suppression: a source line may carry ``# verify: ignore[rule] -- why``.
The justification after ``--`` is REQUIRED — an ignore without one does
not suppress anything and is itself reported (rule ``bad-ignore``), so
every suppression in the tree documents its reason.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, Iterable, List, Optional, Tuple

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One static-analysis finding."""
    passname: str                 # schedule (the port's one pass here)
    rule: str                     # stable kebab-case rule id
    severity: str                 # error | warning
    location: str                 # file:line or graph:segment-name
    message: str                  # what is wrong
    hint: str = ""                # how to fix it

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        tail = f"  [fix: {self.hint}]" if self.hint else ""
        return (f"{self.location}: {self.severity}: "
                f"{self.passname}/{self.rule}: {self.message}{tail}")


class Report:
    """Ordered collection of diagnostics with text/JSON rendering."""

    def __init__(self, diags: Iterable[Diagnostic] = ()):
        self.diags: List[Diagnostic] = list(diags)

    def extend(self, diags: Iterable[Diagnostic]) -> "Report":
        self.diags.extend(diags)
        return self

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diags if d.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def text(self) -> str:
        if not self.diags:
            return "verify: clean (0 diagnostics)"
        lines = [str(d) for d in self.diags]
        ne = len(self.errors)
        lines.append(f"verify: {len(self.diags)} diagnostic"
                     f"{'s' if len(self.diags) != 1 else ''} "
                     f"({ne} error{'s' if ne != 1 else ''})")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "diagnostics": [d.to_json() for d in self.diags],
            "errors": len(self.errors),
            "ok": self.ok,
        }, indent=1)


# ---------------------------------------------------------------------------
# Ignore comments
# ---------------------------------------------------------------------------

_IGNORE_RE = re.compile(
    r"#\s*verify:\s*ignore\[([a-z0-9*-]+)\]\s*(?:--\s*(\S.*))?")


def parse_ignores(source: str) -> Tuple[Dict[int, Tuple[str, str]],
                                        List[Tuple[int, str]]]:
    """Scan ``source`` for ``# verify: ignore[rule] -- why`` comments.

    Returns ``(ignores, bad)``: ``ignores`` maps 1-based line number to
    ``(rule, justification)`` for well-formed suppressions (rule ``*``
    suppresses every rule on that line); ``bad`` lists ``(line, rule)``
    for ignores MISSING the justification — those suppress nothing and
    the linter reports them.
    """
    ignores: Dict[int, Tuple[str, str]] = {}
    bad: List[Tuple[int, str]] = []
    for i, line in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(line)
        if not m:
            continue
        rule, why = m.group(1), (m.group(2) or "").strip()
        if why:
            ignores[i] = (rule, why)
        else:
            bad.append((i, rule))
    return ignores, bad


def suppressed(ignores: Dict[int, Tuple[str, str]], line: int,
               rule: str) -> bool:
    ent = ignores.get(line)
    return ent is not None and ent[0] in ("*", rule)


def apply_ignores(diags: List[Diagnostic], path: str, source: str,
                  passname: str) -> List[Diagnostic]:
    """Filter ``diags`` (all pointing into ``path``) through the source's
    ignore comments, appending a ``bad-ignore`` diagnostic for every
    justification-less ignore."""
    ignores, bad = parse_ignores(source)
    out = []
    for d in diags:
        line = _line_of(d.location)
        if line is not None and suppressed(ignores, line, d.rule):
            continue
        out.append(d)
    for line, rule in bad:
        out.append(Diagnostic(
            passname, "bad-ignore", "error", f"{path}:{line}",
            f"ignore[{rule}] without a justification suppresses nothing",
            hint="write `# verify: ignore[rule] -- <why this is safe>`"))
    return out


def _line_of(location: str) -> Optional[int]:
    _, _, tail = location.rpartition(":")
    return int(tail) if tail.isdigit() else None
