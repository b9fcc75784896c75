"""Self-contained dev tooling: security scan, docstring coverage, dead code.

The port's own copy of :mod:`tiny_audio_tpu.devtools`: small AST-based
versions of the checks the reference runs with bandit, interrogate and
vulture (none of which the port depends on), importable for tests and wired
into ``ta-torch dev security-scan|docstrings|dead-code``, which scan the
port's package by default.  One repair against the JAX package's copy: a
method called on a call's result (``Wav2Vec2CTC(...).eval()``) is no longer
reported as the builtin ``eval``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional, Sequence


@dataclass
class Finding:
    path: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.code}] {self.message}"


def _py_files(paths: Sequence[str | Path]) -> Iterable[Path]:
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            yield from sorted(p.rglob("*.py"))


# ------------------------------------------------------------------ security


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        parts = [f.attr]
        v = f.value
        while isinstance(v, ast.Attribute):
            parts.append(v.attr)
            v = v.value
        # a receiver that is no name (``Model(...).eval()``, a method of a
        # call's result) is marked, so a method never reads as the builtin
        parts.append(v.id if isinstance(v, ast.Name) else "?")
        return ".".join(reversed(parts))
    return ""


def security_scan(paths: Sequence[str | Path]) -> list[Finding]:
    """bandit -ll equivalent: the high/medium rules that matter for this
    codebase (code-execution, unsafe deserialization, shell injection)."""
    findings: list[Finding] = []
    for path in _py_files(paths):
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            findings.append(Finding(str(path), e.lineno or 0, "S000",
                                    f"syntax error: {e.msg}"))
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            kw = {k.arg: k.value for k in node.keywords}
            if name in ("eval", "exec"):
                findings.append(Finding(str(path), node.lineno, "S102",
                                        f"use of {name}()"))
            elif name in ("pickle.load", "pickle.loads"):
                findings.append(Finding(str(path), node.lineno, "S301",
                                        "pickle deserialization of untrusted "
                                        "data"))
            elif name == "yaml.load":
                loader = kw.get("Loader")
                safe = isinstance(loader, ast.Attribute) and loader.attr in (
                    "SafeLoader", "CSafeLoader",
                )
                if not safe:
                    findings.append(Finding(str(path), node.lineno, "S506",
                                            "yaml.load without SafeLoader "
                                            "(use yaml.safe_load)"))
            elif name.startswith("subprocess.") or name in ("os.system",):
                shell = kw.get("shell")
                if name == "os.system" or (
                    isinstance(shell, ast.Constant) and shell.value is True
                ):
                    findings.append(Finding(str(path), node.lineno, "S602",
                                            f"{name} with shell semantics"))
            elif name in ("tempfile.mktemp",):
                findings.append(Finding(str(path), node.lineno, "S306",
                                        "tempfile.mktemp is racy (use "
                                        "NamedTemporaryFile)"))
            elif name in ("torch.load",):
                wo = kw.get("weights_only")
                if not (isinstance(wo, ast.Constant) and wo.value is True):
                    findings.append(Finding(str(path), node.lineno, "S302",
                                            "torch.load without "
                                            "weights_only=True"))
    return findings


# -------------------------------------------------------------- docstrings


def docstring_coverage(
    paths: Sequence[str | Path],
) -> tuple[float, list[Finding]]:
    """interrogate equivalent: % of public modules/classes/functions with a
    docstring; returns (coverage_pct, missing)."""
    total = 0
    missing: list[Finding] = []

    def public(name: str) -> bool:
        return not name.startswith("_")

    for path in _py_files(paths):
        tree = ast.parse(path.read_text(), filename=str(path))
        total += 1
        if ast.get_docstring(tree) is None:
            missing.append(Finding(str(path), 1, "D100", "module docstring"))
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) and public(node.name):
                total += 1
                if ast.get_docstring(node) is None:
                    kind = ("class" if isinstance(node, ast.ClassDef)
                            else "function")
                    missing.append(Finding(str(path), node.lineno, "D102",
                                           f"{kind} {node.name!r} docstring"))
    covered = total - len(missing)
    return (100.0 * covered / total if total else 100.0), missing


# --------------------------------------------------------------- dead code


def dead_code(
    paths: Sequence[str | Path],
    entry_points: Optional[set[str]] = None,
) -> list[Finding]:
    """vulture-lite: module-level functions/classes whose name is never
    referenced anywhere else in the scanned tree.

    Heuristic by design (string-level references, re-exports and dynamic
    dispatch count as uses); names starting with ``_``, dunders, and known
    entry points are exempt.
    """
    entry_points = entry_points or {
        "main", "entry", "dryrun_multichip", "EndpointHandler",
    }
    defs: dict[str, Finding] = {}
    sources: list[tuple[Path, str]] = []
    for path in _py_files(paths):
        text = path.read_text()
        sources.append((path, text))
        tree = ast.parse(text, filename=str(path))
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                name = node.name
                if name.startswith("_") or name in entry_points:
                    continue
                kind = ("class" if isinstance(node, ast.ClassDef)
                        else "function")
                defs.setdefault(name, Finding(
                    str(path), node.lineno, "V101",
                    f"unused {kind} {name!r}",
                ))

    unused = []
    for name, finding in defs.items():
        uses = 0
        for path, text in sources:
            uses += text.count(name)
            if str(path) == finding.path:
                uses -= 1  # its own definition
        if uses <= 0:
            unused.append(finding)
    return unused
