"""Per-line waiver syntax for fedlint findings.

A finding is waived by a trailing ``fedlint: disable=FED00x -- reason``
comment on any physical line of the flagged statement (see the
ROADMAP's invariant-catalogue section for a literal example; spelling
one out here would waive *this* file).

* one or more rule codes, comma-separated: ``disable=FED002,FED006``
* the reason after `` -- `` is REQUIRED — a waiver without one is
  itself a finding (FED000), as is a waiver that names an unknown rule
  or never matches a finding.  Waivers are an audit trail, not an
  off-switch.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: the meta-rule code for waiver-syntax problems (bad code, missing
#: reason, waiver that matched nothing) and unparseable files.
META_RULE = "FED000"

_WAIVER_RE = re.compile(r"#\s*fedlint:\s*disable=([^#]*?)(?:--(.*))?$")
_CODE_RE = re.compile(r"^FED\d{3}$")


@dataclass
class Waiver:
    line: int                       # 1-indexed line the comment sits on
    codes: Tuple[str, ...]
    reason: str
    used: bool = False
    problems: List[str] = field(default_factory=list)

    @property
    def valid(self) -> bool:
        return not self.problems


def parse_waivers(lines: List[str]) -> Dict[int, Waiver]:
    """Scan source lines for waiver comments.  Returns ``{line: Waiver}``;
    malformed waivers are returned too, carrying their ``problems`` so
    the driver can report them under FED000."""
    out: Dict[int, Waiver] = {}
    for i, line in enumerate(lines, start=1):
        m = _WAIVER_RE.search(line)
        if m is None:
            continue
        raw_codes, raw_reason = m.group(1), m.group(2)
        codes = tuple(c.strip() for c in raw_codes.split(",") if c.strip())
        reason = (raw_reason or "").strip()
        problems = []
        if not codes:
            problems.append("waiver names no rule codes")
        for c in codes:
            if not _CODE_RE.match(c):
                problems.append(f"malformed rule code {c!r} "
                                "(expected FED###)")
        if not reason:
            problems.append("waiver is missing its required reason "
                            "(`fedlint: disable=FED00x -- why`)")
        out[i] = Waiver(line=i, codes=codes, reason=reason,
                        problems=problems)
    return out
