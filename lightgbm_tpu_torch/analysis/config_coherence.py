"""The config pass: code, registry and docs agree on the parameters.

The JAX package's ``analysis/config_coherence.py`` on the port.  Three
surfaces must agree: attribute reads on ``Config`` objects in the code,
the port's registry in ``utils/config.py`` (``Config._FIELDS`` /
``PARAMETER_SET`` / ``ALIAS_TABLE``) and ``docs/Parameters.md``.

* ``config-unknown-read``  -- ``config.<name>`` where ``<name>`` is not a
  registered field or a real attribute of the Config class
* ``config-unknown-key``   -- a string key into ``.raw`` that is neither
  canonical nor an alias
* ``config-registry``      -- registry drift: an alias targeting an
  unregistered key, a _FIELDS entry missing from PARAMETER_SET
* ``params-doc-stale``     -- docs/Parameters.md differs from a fresh
  render of the port's registry (``params_doc.py``, the port's copy of
  tools/gen_params_doc.py, which imports the JAX package): the port's
  registry departs from the JAX package's

Config receivers: names and attributes whose last component is
``config`` or ``cfg`` (the repo's convention).
"""
from __future__ import annotations

import ast
import os
from typing import List, Set

from .core import Finding, SourceModule, dotted_name, str_const

PASS_NAME = "config"

RULES = {
    "config-unknown-read":
        "attribute read on a Config object that no registered field or "
        "class attribute provides",
    "config-unknown-key":
        "string key into Config.raw that is neither a canonical "
        "parameter nor an alias",
    "config-registry":
        "utils/config.py registry is internally inconsistent",
    "params-doc-stale":
        "docs/Parameters.md does not match a fresh render of the "
        "port's registry (analysis/params_doc.py)",
}

_RECEIVER_SUFFIXES = ("config", "cfg")
# a dotted receiver rooted at an external module is that module's own
# config object (torch.backends... or jax.config.update(...)), not the
# repo Config
_FOREIGN_ROOTS = {"jax", "jnp", "lax", "np", "numpy", "scipy", "torch"}


def _registry():
    from ..utils import config as C
    return C


def _known_attrs() -> Set[str]:
    C = _registry()
    known = set(C.Config._FIELDS)
    # real API of the class (methods, properties, class attrs) and the
    # instance attrs __init__ materializes beyond _FIELDS
    known.update(a for a in dir(C.Config) if not a.startswith("__"))
    known.update(("raw",))
    return known


def _is_config_receiver(node: ast.AST) -> bool:
    name = dotted_name(node)
    if not name:
        return False
    if "." in name and name.split(".", 1)[0] in _FOREIGN_ROOTS:
        return False
    last = name.rsplit(".", 1)[-1]
    return last in _RECEIVER_SUFFIXES


def _check_reads(mod: SourceModule, known: Set[str],
                 findings: List[Finding]) -> None:
    C = _registry()
    for node in ast.walk(mod.tree):
        # config.<attr> (read or write — a write to an unknown field is
        # the same misspelling one assignment earlier)
        if isinstance(node, ast.Attribute) \
                and _is_config_receiver(node.value) \
                and not node.attr.startswith("_") \
                and node.attr not in known:
            findings.append(Finding(
                "config-unknown-read", PASS_NAME, mod.path, node.lineno,
                "config.%s is not a registered parameter or Config "
                "attribute" % node.attr,
                "register the field in Config._FIELDS "
                "(utils/config.py) or fix the name"))
        # config.raw["key"] / config.raw.get("key", ...)
        key_node = None
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr == "raw" \
                and _is_config_receiver(node.value.value):
            key_node = node.slice
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("get", "pop", "setdefault") \
                and isinstance(node.func.value, ast.Attribute) \
                and node.func.value.attr == "raw" \
                and _is_config_receiver(node.func.value.value) \
                and node.args:
            key_node = node.args[0]
        if key_node is not None:
            key = str_const(key_node)
            if key is not None and key not in C.PARAMETER_SET \
                    and key not in C.ALIAS_TABLE:
                findings.append(Finding(
                    "config-unknown-key", PASS_NAME, mod.path,
                    node.lineno,
                    "raw[%r] is neither a canonical parameter nor an "
                    "alias" % key,
                    "add the key to utils/config.py (PARAMETER_SET or "
                    "ALIAS_TABLE) or fix the spelling"))


def _check_registry(findings: List[Finding]) -> None:
    C = _registry()
    path = "lightgbm_tpu_torch/utils/config.py"
    for alias, target in sorted(C.ALIAS_TABLE.items()):
        if target not in C.PARAMETER_SET:
            findings.append(Finding(
                "config-registry", PASS_NAME, path, 0,
                "alias %r resolves to unregistered parameter %r"
                % (alias, target),
                "register the target in PARAMETER_SET"))
    for field in sorted(C.Config._FIELDS):
        if field not in C.PARAMETER_SET:
            findings.append(Finding(
                "config-registry", PASS_NAME, path, 0,
                "Config._FIELDS[%r] is missing from PARAMETER_SET"
                % field,
                "every materialized field must be a declared parameter"))


def _check_doc(repo_root: str, findings: List[Finding]) -> None:
    from .params_doc import render
    doc_path = os.path.join(repo_root, "docs", "Parameters.md")
    if not os.path.exists(doc_path):
        return                       # fixture trees have no docs/
    with open(doc_path, encoding="utf-8") as f:
        on_disk = f.read()
    if render() != on_disk:
        findings.append(Finding(
            "params-doc-stale", PASS_NAME, "docs/Parameters.md", 0,
            "docs/Parameters.md differs from the port's registry "
            "(utils/config.py)",
            "bring the port's registry to the JAX package's (the doc is "
            "rendered from that one)"))


def run(modules: List[SourceModule], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    known = _known_attrs()
    for mod in modules:
        if mod.path.endswith("utils/config.py"):
            continue                 # the registry defines, not reads
        _check_reads(mod, known, findings)
    _check_registry(findings)
    _check_doc(repo_root, findings)
    return findings
