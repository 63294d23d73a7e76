"""The port's static analyzer: findings, suppressions, baselines and
running the passes (the JAX package's ``analysis/core.py``, scoped to
``lightgbm_tpu_torch``).

Every pass is a walk over the package's sources or an evaluation of the
port's own planners and registries (launch plans, event schema, config
registry) on the CPU: no card is needed.  Each pass module has
``PASS_NAME``, ``RULES`` (rule id -> one-line description) and
``run(modules, repo_root) -> [Finding]``.  ``run_lint`` drives them all,
applies inline suppressions (``# lint: ignore[rule-id] reason``) and an
optional baseline file, and returns the surviving findings.

A pass that crashes is an internal error (exit 2 from the CLI), never
an empty result: a gate that fails open is worse than none.
"""
from __future__ import annotations

import ast
import json
import os
import re
import tokenize
from typing import Dict, List, NamedTuple, Optional, Tuple

PACKAGE_DIRNAME = "lightgbm_tpu_torch"

# hot-path scope of the host-sync pass: modules where an implicit
# device->host wait stalls the launch queue (the training loop, the fused
# iteration, the serving data plane, and the ranks' comm and learner
# layer, where a stray wait stalls every rank at the next collective).
# obs/ is out of scope -- waiting is its job -- except the live scrape
# plane (obs/live.py), whose server thread must never touch device
# values.
HOT_PATH_PREFIXES = (
    "lightgbm_tpu_torch/ops/",
    "lightgbm_tpu_torch/models/gbdt.py",
    "lightgbm_tpu_torch/serve/",
    "lightgbm_tpu_torch/parallel/comm.py",
    "lightgbm_tpu_torch/parallel/mesh.py",
    "lightgbm_tpu_torch/obs/live.py",
)


class Finding(NamedTuple):
    """One structured lint finding (file:line, pass, rule, suggestion)."""
    rule: str            # stable rule id, the suppression key
    pass_name: str       # hostsync / recompile / events / config / smem
    file: str            # repo-relative posix path ("" for registry rules)
    line: int            # 1-based (0 for whole-repo findings)
    message: str
    suggestion: str = ""

    def key(self) -> Tuple[str, str, int]:
        return (self.rule, self.file, self.line)

    def as_dict(self) -> dict:
        return {"rule": self.rule, "pass": self.pass_name,
                "file": self.file, "line": self.line,
                "message": self.message, "suggestion": self.suggestion}


class LintInternalError(Exception):
    """A pass itself failed — the CLI exits 2, never 0 (fail closed)."""


class SourceModule(NamedTuple):
    """One parsed package source file shared by every AST pass."""
    path: str            # repo-relative posix path
    text: str
    tree: ast.Module
    lines: List[str]     # 1-based indexing via lines[line - 1]

    def in_hot_path(self) -> bool:
        return any(self.path == p or self.path.startswith(p)
                   for p in HOT_PATH_PREFIXES)


def discover_files(repo_root: str,
                   extra_dirs: Tuple[str, ...] = ()) -> List[str]:
    """Repo-relative paths of every package .py file (plus extra dirs)."""
    out: List[str] = []
    roots = (PACKAGE_DIRNAME,) + tuple(extra_dirs)
    for rel_root in roots:
        top = os.path.join(repo_root, rel_root)
        if os.path.isfile(top) and top.endswith(".py"):
            out.append(rel_root.replace(os.sep, "/"))
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn),
                                          repo_root)
                    out.append(rel.replace(os.sep, "/"))
    return out


def load_modules(repo_root: str,
                 files: Optional[List[str]] = None) -> List[SourceModule]:
    if files is None:
        files = discover_files(repo_root)
    mods: List[SourceModule] = []
    for rel in files:
        path = os.path.join(repo_root, rel)
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
            tree = ast.parse(text, filename=rel)
        except (OSError, SyntaxError) as e:
            raise LintInternalError("cannot parse %s: %s" % (rel, e))
        mods.append(SourceModule(rel, text, tree, text.splitlines()))
    return mods


# -- inline suppressions --------------------------------------------------
# ``# lint: ignore[rule-id]`` or ``# lint: ignore[a, b] -- reason`` on the
# line the finding anchors to.  Suppressions are parsed from the token
# stream (not a substring scan) so the marker inside a string literal
# never suppresses anything.
_IGNORE_RE = re.compile(
    r"#\s*lint:\s*ignore\[([A-Za-z0-9_,\-\s*]+)\]")


def collect_suppressions(mod: SourceModule) -> Dict[int, set]:
    """line -> set of suppressed rule ids ('*' = every rule)."""
    out: Dict[int, set] = {}
    try:
        tokens = tokenize.generate_tokens(iter(mod.text.splitlines(
            keepends=True)).__next__)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _IGNORE_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out.setdefault(tok.start[0], set()).update(rules)
    except tokenize.TokenError:
        pass            # the AST parse already vouched for the file
    return out


def apply_suppressions(findings: List[Finding],
                       modules: List[SourceModule]) -> List[Finding]:
    by_file = {m.path: collect_suppressions(m) for m in modules}
    kept = []
    for f in findings:
        rules = by_file.get(f.file, {}).get(f.line, set())
        if f.rule in rules or "*" in rules:
            continue
        kept.append(f)
    return kept


# -- baseline -------------------------------------------------------------
# A baseline file grandfathers known findings so a gate can land before
# the last fix does.  Entries match on (rule, file, line);
# ``--write-baseline`` writes the file from the current findings.  The
# port checks in no baseline: its tree is clean.

def load_baseline(path: str) -> List[dict]:
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError:
        return []
    except ValueError as e:
        raise LintInternalError("corrupt baseline %s: %s" % (path, e))
    entries = data.get("findings", []) if isinstance(data, dict) else data
    if not isinstance(entries, list):
        raise LintInternalError("baseline %s: expected a findings list"
                                % path)
    return entries


def write_baseline(path: str, findings: List[Finding]) -> None:
    data = {"findings": [{"rule": f.rule, "file": f.file, "line": f.line}
                         for f in findings]}
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")


def apply_baseline(findings: List[Finding],
                   entries: List[dict]) -> List[Finding]:
    keys = {(str(e.get("rule", "")), str(e.get("file", "")),
             int(e.get("line", 0))) for e in entries}
    return [f for f in findings if f.key() not in keys]


# -- running the passes ---------------------------------------------------

def all_passes():
    from . import (config_coherence, events_schema, hostsync, recompile,
                   smem)
    return (hostsync, recompile, events_schema, config_coherence, smem)


def rule_catalog() -> Dict[str, Tuple[str, str]]:
    """rule id -> (pass name, description) over every registered pass."""
    out: Dict[str, Tuple[str, str]] = {}
    for p in all_passes():
        for rule, desc in p.RULES.items():
            out[rule] = (p.PASS_NAME, desc)
    return out


def run_lint(repo_root: str, passes=None,
             files: Optional[List[str]] = None,
             baseline_path: str = "") -> List[Finding]:
    """Run the passes and return suppression/baseline-surviving findings,
    sorted by (file, line, rule) for stable output."""
    modules = load_modules(repo_root, files=files)
    findings: List[Finding] = []
    for p in (passes if passes is not None else all_passes()):
        try:
            findings.extend(p.run(modules, repo_root))
        except LintInternalError:
            raise
        except Exception as e:
            raise LintInternalError("pass %s crashed: %r"
                                    % (p.PASS_NAME, e))
    findings = list(dict.fromkeys(findings))    # nested-scope dedup
    findings = apply_suppressions(findings, modules)
    if baseline_path:
        findings = apply_baseline(findings, load_baseline(baseline_path))
    return sorted(findings, key=lambda f: (f.file, f.line, f.rule))


# -- shared AST helpers ---------------------------------------------------

def dotted_name(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, ''
    for anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def root_name(node: ast.AST) -> str:
    """Leftmost Name of an Attribute/Subscript/Call chain, '' if dynamic."""
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            break
    return node.id if isinstance(node, ast.Name) else ""


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
