"""tpulint core — file loading, suppression comments, rule registry, report.

The analog of bRPC's sanitizer/contention-profiler discipline, moved to
where a Python codebase can actually enforce it: an AST pass per rule over
the whole package. Each finding is ``path:line: [rule] message``; a finding
is silenced by a ``# tpulint: disable=<rule>[,<rule>...]`` comment on the
same line or on a comment-only line directly above it (``disable=all``
silences every rule). Suppressions are deliberate, reviewable artifacts —
the meta-test in tests/test_lint.py asserts the tree itself carries zero
*unsuppressed* findings, so any new violation must either be fixed or
argued for in a comment that survives review.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

SUPPRESS_RE = re.compile(r"#\s*tpulint:\s*disable=([A-Za-z0-9_\-, ]+)")


class Finding:
    """One rule violation at a source location."""

    __slots__ = ("rule", "rel", "line", "message")

    def __init__(self, rule: str, rel: str, line: int, message: str):
        self.rule = rule
        self.rel = rel
        self.line = line
        self.message = message

    def format(self) -> str:
        return f"{self.rel}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.rel, "line": self.line,
                "message": self.message}

    def __repr__(self) -> str:
        return f"Finding({self.format()!r})"


class SourceFile:
    """One parsed source file plus its suppression map."""

    __slots__ = ("path", "rel", "text", "lines", "tree", "_suppress")

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self._suppress = self._parse_suppressions()

    def _parse_suppressions(self) -> Dict[int, set]:
        out: Dict[int, set] = {}
        for i, line in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(line)
            if m is None:
                continue
            rules = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
            out.setdefault(i, set()).update(rules)
            if line.lstrip().startswith("#"):
                # a comment-only suppression line covers the statement below
                out.setdefault(i + 1, set()).update(rules)
        return out

    def suppressed(self, rule: str, line: int) -> bool:
        rules = self._suppress.get(line)
        return rules is not None and (rule in rules or "all" in rules)


class Package:
    """Every parseable .py file under the lint root."""

    def __init__(self, files: List[SourceFile], errors: List[Finding]):
        self.files = files
        self.errors = errors  # syntax errors surface as findings
        self._by_rel = {f.rel: f for f in files}

    def file(self, rel: str) -> Optional[SourceFile]:
        return self._by_rel.get(rel)


def in_scope(rel: str, exact: set = (), prefixes: Tuple[str, ...] = ()) -> bool:
    """Module-scope matching robust to where the lint root sits: exact
    entries match as path suffixes ("tpu/transport.py" matches whether the
    root is the repo or the package), prefixes match path segments."""
    for s in exact:
        if rel == s or rel.endswith("/" + s):
            return True
    for p in prefixes:
        if rel.startswith(p) or ("/" + p) in rel:
            return True
    return False


def load_package(root: str) -> Package:
    root = os.path.abspath(root)
    paths: List[Tuple[str, str]] = []
    if os.path.isfile(root):
        paths.append((root, os.path.basename(root)))
    else:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fn in sorted(filenames):
                if not fn.endswith(".py") or fn.endswith("_pb2.py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                paths.append((full, rel))
    files: List[SourceFile] = []
    errors: List[Finding] = []
    for full, rel in paths:
        with open(full, "r", encoding="utf-8") as fh:
            text = fh.read()
        try:
            files.append(SourceFile(full, rel, text))
        except SyntaxError as e:
            errors.append(Finding("parse-error", rel, e.lineno or 0, str(e)))
    return Package(files, errors)


# ------------------------------------------------------------- rule registry
# name -> (callable(Package) -> List[Finding], one-line description)
_RULES: Dict[str, Tuple[Callable[[Package], List[Finding]], str]] = {}


def register_rule(name: str, description: str):
    def deco(fn):
        if name in _RULES:
            raise ValueError(f"lint rule {name!r} already registered")
        _RULES[name] = (fn, description)
        return fn
    return deco


def list_rules() -> List[Tuple[str, str]]:
    _ensure_rules()
    return sorted((n, d) for n, (_, d) in _RULES.items())


def _ensure_rules() -> None:
    if not _RULES:
        from brpc_tpu_torch.analysis import rules  # noqa: F401  (registers on import)


class LintResult:
    """Unsuppressed findings + how many were silenced by comments."""

    def __init__(self, findings: List[Finding], suppressed: List[Finding]):
        self.findings = findings
        self.suppressed = suppressed

    @property
    def clean(self) -> bool:
        return not self.findings


def run_lint(root: str, rules: Optional[List[str]] = None) -> LintResult:
    """Run the selected rules (default: all) over every file under root."""
    _ensure_rules()
    pkg = load_package(root)
    selected = rules if rules is not None else [n for n in _RULES]
    unknown = [n for n in selected if n not in _RULES]
    if unknown:
        raise ValueError(f"unknown lint rule(s): {', '.join(unknown)}")
    raw: List[Finding] = list(pkg.errors)
    for name in selected:
        fn, _ = _RULES[name]
        raw.extend(fn(pkg))
    kept: List[Finding] = []
    silenced: List[Finding] = []
    for f in raw:
        sf = pkg.file(f.rel)
        if sf is not None and sf.suppressed(f.rule, f.line):
            silenced.append(f)
        else:
            kept.append(f)
    key = lambda f: (f.rel, f.line, f.rule)  # noqa: E731
    kept.sort(key=key)
    silenced.sort(key=key)
    return LintResult(kept, silenced)


def format_findings(findings: List[Finding]) -> str:
    return "\n".join(f.format() for f in findings)


# ----------------------------------------------------------------- AST utils
def attr_chain(node) -> Optional[str]:
    """Dotted name of a Name/Attribute chain ("time.sleep", "self._lock"),
    or None when the chain roots in something unnameable (a call, a
    subscript)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_functions(tree):
    """Yield (funcdef, enclosing_class_name|None) for every def in the
    module, including methods (but reporting the class they sit in)."""
    def walk(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, cls
                yield from walk(child, cls)
            else:
                yield from walk(child, cls)
    yield from walk(tree, None)


def has_marker(func: ast.FunctionDef, marker: str) -> bool:
    for dec in func.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = attr_chain(target)
        if name is not None and name.split(".")[-1] == marker:
            return True
    return False


def const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
