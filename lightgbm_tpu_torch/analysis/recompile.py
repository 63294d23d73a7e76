"""The recompile pass: compiles inside loops.

The JAX package's ``analysis/recompile.py`` on the port.  In the port a
"compile" is a CUDA graph capture or a build of the kernels
(obs/compile.py counts both): a capture records every launch of its body
anew, and ``_build.build()`` runs ``nvcc``.  Done once and cached, each
is paid once; done in a loop body, every trip pays it again, which the
runtime tracker only reports after the time is spent.  Decidable from
the AST:

* ``capture-in-loop`` -- ``torch.cuda.graph(...)`` or
  ``<graph>.capture_begin(...)`` inside a ``for``/``while`` body;
* ``build-in-loop``   -- ``_build.build()`` inside a ``for``/``while``
  body (``_build.library()``, the cached load, is the port's cache and
  never flagged).

Scoped a function at a time (``hostsync.walk_scope``): a capture in a
factory that a loop calls is the factory's cache's business, not a
textual finding here; the port's caches (the fused iteration's graphs,
the serving buckets) capture in such factories.

The JAX pass's two static-argument rules (``jit-static-drift``,
``jit-unhashable-static``) have no counterpart: they check
``jax.jit``'s ``static_argnames``/``static_argnums`` against a
signature and a call's literals, and a CUDA graph or a torch function
has no static arguments -- a graph is keyed by the cache that holds it
(the bucket, the tree's shape), which the tests pin instead.
"""
from __future__ import annotations

import ast
from typing import List

from .core import Finding, SourceModule, dotted_name
from .hostsync import walk_scope

PASS_NAME = "recompile"

RULES = {
    "capture-in-loop":
        "a CUDA graph capture inside a loop body records its launches "
        "again every iteration (the JAX pass's jit-static-drift and "
        "jit-unhashable-static have no counterpart: a CUDA graph and a "
        "torch function take no static arguments; a graph is keyed by "
        "the cache that holds it)",
    "build-in-loop":
        "a kernel build (_build.build) inside a loop body runs nvcc's "
        "check every iteration; call the cached _build.library()",
}


def _compile_kind(node: ast.Call) -> str:
    """The rule a call breaks inside a loop, or ''."""
    name = dotted_name(node.func)
    if name in ("torch.cuda.graph", "cuda.graph"):
        return "capture-in-loop"
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr == "capture_begin":
        return "capture-in-loop"
    if name in ("_build.build", "lightgbm_tpu_torch._build.build"):
        return "build-in-loop"
    return ""


def run(modules: List[SourceModule], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        scopes: List[List[ast.stmt]] = [mod.tree.body]
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node.body)
        for body in scopes:
            loops = [n for n in walk_scope(body)
                     if isinstance(n, (ast.For, ast.While, ast.AsyncFor))]
            for loop in loops:
                for node in walk_scope(loop.body + loop.orelse):
                    if not isinstance(node, ast.Call):
                        continue
                    rule = _compile_kind(node)
                    if rule:
                        findings.append(Finding(
                            rule, PASS_NAME, mod.path, node.lineno,
                            "%s inside a loop compiles again every "
                            "iteration" % dotted_name(node.func),
                            "hoist it out of the loop: compile once and "
                            "cache (as ops/fused_iter.py and "
                            "serve/executable.py do)"))
    return list(dict.fromkeys(findings))
