"""fedlint driver: file discovery, rule dispatch, waiver application.

The unit of work is one Python file: parse it once, hand the
:class:`FileContext` (AST + parent map + source lines) to every rule
whose ``applies(relpath)`` predicate matches, then resolve the raw
findings against the file's waiver comments.  A finding is *waived*
when a valid waiver naming its rule code sits on any physical line of
the flagged statement; waived findings stay in the report (with their
reason) but do not fail the run.  Waivers that match nothing, name
unknown codes, or omit the required reason are themselves findings
under the FED000 meta-rule.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.waivers import META_RULE, Waiver, parse_waivers


@dataclass
class Finding:
    file: str
    line: int
    col: int
    rule: str
    message: str
    waived: bool = False
    reason: Optional[str] = None
    end_line: Optional[int] = None

    def to_dict(self) -> Dict:
        return {"file": self.file, "line": self.line, "col": self.col,
                "rule": self.rule, "message": self.message,
                "waived": self.waived, "reason": self.reason}

    def render(self) -> str:
        tag = f" [waived: {self.reason}]" if self.waived else ""
        return (f"{self.file}:{self.line}:{self.col}: "
                f"{self.rule} {self.message}{tag}")


class FileContext:
    """Everything a rule needs about one parsed file."""

    def __init__(self, path: str, rel: str, source: str, tree: ast.AST):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    # -- navigation helpers (shared by the rules) -----------------------
    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first chain of enclosing function defs."""
        return [a for a in self.ancestors(node)
                if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))]

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        for a in self.ancestors(node):
            if isinstance(a, ast.ClassDef):
                return a
        return None

    def in_loop(self, node: ast.AST) -> bool:
        """Inside a for/while body, stopping at function boundaries
        (a loop *outside* the enclosing def does not re-run its body)."""
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return False
            if isinstance(a, (ast.For, ast.AsyncFor, ast.While)):
                return True
        return False


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def iter_scopes(tree: ast.AST) -> Iterable[ast.AST]:
    """Module + every function def (each is one lint scope)."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, _SCOPE_NODES):
            yield node


def walk_scope(scope: ast.AST) -> Iterable[ast.AST]:
    """Walk one scope WITHOUT descending into nested function scopes
    (their bindings are their own scope's business).  Class bodies
    execute in the enclosing scope and are descended into."""
    stack = [scope.body] if isinstance(scope, ast.Lambda) \
        else list(scope.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _SCOPE_NODES):
            continue                    # nested scope: don't descend
        for child in ast.iter_child_nodes(node):
            stack.append(child)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# -- per-file lint --------------------------------------------------------

def lint_file(path: str, rel: str, rules: Sequence) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 1, e.offset or 0, META_RULE,
                        f"syntax error: {e.msg}")]
    ctx = FileContext(path, rel, source, tree)
    findings: List[Finding] = []
    for rule in rules:
        if rule.applies(ctx.rel):
            findings.extend(rule.check(ctx))
    waivers = parse_waivers(ctx.lines)
    findings = _apply_waivers(ctx.rel, findings, waivers,
                              active={r.code for r in rules})
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def _apply_waivers(rel: str, findings: List[Finding],
                   waivers: Dict[int, Waiver],
                   active: set) -> List[Finding]:
    out: List[Finding] = []
    for f in findings:
        span = range(f.line, (f.end_line or f.line) + 1)
        for ln in span:
            w = waivers.get(ln)
            if w is not None and w.valid and f.rule in w.codes:
                w.used = True
                f.waived = True
                f.reason = w.reason
                break
        out.append(f)
    for w in waivers.values():
        for problem in w.problems:
            out.append(Finding(rel, w.line, 0, META_RULE, problem))
        # an unused waiver is dead weight that hides nothing today and
        # could hide a regression tomorrow — but only call it unused
        # when every rule it names actually ran this invocation.
        if w.valid and not w.used and all(c in active for c in w.codes):
            out.append(Finding(
                rel, w.line, 0, META_RULE,
                f"unused waiver for {','.join(w.codes)}: no matching "
                "finding on this line"))
    return out


# -- path discovery -------------------------------------------------------

def discover(paths: Sequence[str]) -> List[Tuple[str, str]]:
    """Expand files/directories into ``(abspath, display_path)`` pairs.
    Raises ``FileNotFoundError`` for a missing input path."""
    out: List[Tuple[str, str]] = []
    for p in paths:
        if os.path.isfile(p):
            out.append((os.path.abspath(p), p))
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(".")
                                 and d != "__pycache__")
                for name in sorted(files):
                    if name.endswith(".py"):
                        full = os.path.join(root, name)
                        out.append((os.path.abspath(full), full))
        else:
            raise FileNotFoundError(p)
    return out


def lint_paths(paths: Sequence[str], rules: Sequence) -> List[Finding]:
    findings: List[Finding] = []
    for path, rel in discover(paths):
        findings.extend(lint_file(path, rel, rules))
    return findings
