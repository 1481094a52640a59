"""Shared machinery of the invariant lint plane: findings, file loading,
``# lint: allow(...)`` pragmas, and the committed baseline.

A *finding* is (rule, path, line, message, snippet). The baseline stores a
content fingerprint instead of a line number — (rule, relative path,
normalized source line, occurrence index) hashed — so unrelated edits that
shift line numbers don't invalidate accepted findings, while editing the
offending line itself does (the finding then re-surfaces for re-review,
which is the point).
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

# `# lint: allow(rule-a, rule-b) -- optional justification`
_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([^)]*)\)")


@dataclass
class Finding:
    rule: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str
    snippet: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def render(self) -> str:
        out = f"{self.path}:{self.line}: {self.rule}: {self.message}"
        if self.snippet:
            out += f"\n    {self.snippet}"
        return out

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "snippet": self.snippet,
        }


@dataclass
class SourceFile:
    """One parsed module: source text, AST, and suppression pragmas."""

    path: str  # absolute
    rel: str  # repo-relative, '/'-separated
    text: str
    tree: ast.AST
    lines: List[str] = field(default_factory=list)
    # line number -> set of allowed rule ids on that line
    pragmas: Dict[int, Set[str]] = field(default_factory=dict)
    _nodes: Optional[List[ast.AST]] = field(default=None, repr=False,
                                            compare=False)
    _docstrings: Optional[Set[int]] = field(default=None, repr=False,
                                            compare=False)

    def nodes(self) -> List[ast.AST]:
        """Every node of the tree in ``ast.walk`` order, walked once: the
        contract scans each read the whole module."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def docstring_ids(self) -> Set[int]:
        """ids of the module's docstring Constant nodes (cached)."""
        if self._docstrings is None:
            self._docstrings = {id(n) for n in iter_docstrings(self.tree)}
        return self._docstrings

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()[:120]
        return ""

    def allowed(self, line: int, rule: str) -> bool:
        """A pragma suppresses its own line and, when the pragma stands on
        a line of its own, the first following non-comment line."""
        rules = self.pragmas.get(line)
        if rules is not None and (rule in rules or "*" in rules):
            return True
        for pline, rules in self.pragmas.items():
            if rule not in rules and "*" not in rules:
                continue
            if pline >= line:
                continue
            # pragma-only line: walk forward over blank/comment lines
            src = self.lines[pline - 1].strip() if pline <= len(self.lines) else ""
            if not src.startswith("#"):
                continue
            nxt = pline + 1
            while nxt <= len(self.lines) and (
                not self.lines[nxt - 1].strip()
                or self.lines[nxt - 1].strip().startswith("#")
            ):
                nxt += 1
            if nxt == line:
                return True
        return False


def _parse_pragmas(text: str) -> Dict[int, Set[str]]:
    """Extract ``# lint: allow(...)`` pragmas via the tokenizer so strings
    containing the pragma text don't count."""
    out: Dict[int, Set[str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out.setdefault(tok.start[0], set()).update(rules)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def load_source(path: str, root: str) -> Optional[SourceFile]:
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            text = f.read()
        tree = ast.parse(text, filename=path)
    except (OSError, SyntaxError, ValueError):
        return None
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    return SourceFile(
        path=path,
        rel=rel,
        text=text,
        tree=tree,
        lines=text.splitlines(),
        pragmas=_parse_pragmas(text),
    )


def collect_files(paths: Iterable[str], root: str) -> List[SourceFile]:
    """Every .py under ``paths`` (files or directories), parsed. Order is
    deterministic (sorted walk) so finding order and baseline occurrence
    indices are stable run to run."""
    seen: Set[str] = set()
    files: List[SourceFile] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            cands = [p]
        else:
            cands = []
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git", "node_modules")
                )
                cands.extend(
                    os.path.join(dirpath, f)
                    for f in sorted(filenames)
                    if f.endswith(".py")
                )
        for c in cands:
            if c in seen:
                continue
            seen.add(c)
            sf = load_source(c, root)
            if sf is not None:
                files.append(sf)
    return files


# --------------------------------------------------------------- baseline


def fingerprint(finding: Finding, occurrence: int) -> str:
    """Stable id of an accepted finding: rule + file + normalized offending
    line + occurrence index among identical triples (so two identical
    lines in one file baseline independently)."""
    norm = " ".join(finding.snippet.split())
    h = hashlib.sha1(
        f"{finding.rule}|{finding.path}|{norm}|{occurrence}".encode()
    ).hexdigest()[:16]
    return h


def fingerprints(findings: List[Finding]) -> List[Tuple[Finding, str]]:
    counts: Dict[Tuple[str, str, str], int] = {}
    out = []
    for f in findings:
        key = (f.rule, f.path, " ".join(f.snippet.split()))
        n = counts.get(key, 0)
        counts[key] = n + 1
        out.append((f, fingerprint(f, n)))
    return out


def load_baseline(path: str) -> Dict[str, dict]:
    """fingerprint -> entry. Tolerates a missing file (empty baseline)."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return {}
    out = {}
    for entry in data.get("findings", []):
        fp = entry.get("fingerprint")
        if fp:
            out[fp] = entry
    return out


def save_baseline(path: str, findings: List[Finding]) -> int:
    entries = [
        {
            "fingerprint": fp,
            "rule": f.rule,
            "path": f.path,
            "snippet": " ".join(f.snippet.split()),
        }
        for f, fp in fingerprints(findings)
    ]
    doc = {
        "comment": (
            "Accepted pre-existing lint findings (ray-tpu-torch lint --baseline). "
            "Regenerate with: ray-tpu-torch lint --update-baseline. New findings "
            "not in this file fail CI; editing an offending line re-surfaces "
            "its finding for review."
        ),
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(entries)


def apply_baseline(
    findings: List[Finding], baseline: Dict[str, dict]
) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (new, accepted) against a loaded baseline."""
    new: List[Finding] = []
    accepted: List[Finding] = []
    for f, fp in fingerprints(findings):
        (accepted if fp in baseline else new).append(f)
    return new, accepted


# ------------------------------------------------------------ AST helpers


def call_name(node: ast.Call) -> str:
    """Dotted name of a call target: 'time.sleep', '.append' (unknown
    receiver), 'open'. Best-effort, literal-attribute chains only."""
    f = node.func
    parts: List[str] = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    else:
        parts.append("")
    return ".".join(reversed(parts))


def const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def iter_docstrings(tree: ast.AST):
    """Yield the Constant nodes that are docstrings (module/class/def), so
    scanners can exclude prose from code-literal scans."""
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
        ):
            body = getattr(node, "body", [])
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                yield body[0].value
