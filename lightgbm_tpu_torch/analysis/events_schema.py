"""The event-schema pass: every emit site against obs/events.py.

The JAX package's ``analysis/events_schema.py`` on the port.  Every
event-emitting call in the package is checked against the field tables
of the port's ``obs/events.py``:

* ``event-unknown-type``   -- emits an ``ev`` the schema doesn't declare
* ``event-unknown-field``  -- a keyword not in required + optional +
  common
* ``event-missing-field``  -- a required key provably absent (only when
  the call has no ``**splat`` that could carry it)
* ``event-schema-version`` -- a literal ``schema=`` that isn't
  ``SCHEMA_VERSION``

Emit sites: ``<obj>.event("name", k=v, ...)`` anywhere in the package
(the observer API, and local ``emit()`` shims of the same shape), and
the autotuner's deferred queue ``events.append(("name", {...}))``,
re-emitted through ``obs.event`` later (ops/learner.py).

The tables are imported from obs/events.py, not declared here again, so
the pass cannot drift from the schema it checks.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from .core import Finding, SourceModule, str_const

PASS_NAME = "events"

RULES = {
    "event-unknown-type":
        "emitted event type is not declared in obs/events.py",
    "event-unknown-field":
        "emitted field is declared neither required nor optional for "
        "this event type",
    "event-missing-field":
        "a required field of this event type is not emitted",
    "event-schema-version":
        "literal schema= disagrees with obs.events.SCHEMA_VERSION",
}

# emit-method names whose first argument is the event type and whose
# keywords are the fields
_EMIT_METHODS = ("event", "emit")


def _schema():
    from ..obs import events as ev
    return ev


def _check_fields(mod: SourceModule, line: int, ev_name: str,
                  explicit: List[str], has_splat: bool,
                  schema_kw: Optional[ast.AST],
                  findings: List[Finding]) -> None:
    ev = _schema()
    declared = ev.declared_fields(ev_name)
    if declared is None:
        findings.append(Finding(
            "event-unknown-type", PASS_NAME, mod.path, line,
            "event type %r is not declared in obs/events.py" % ev_name,
            "add it to _REQUIRED/_OPTIONAL (and bump SCHEMA_VERSION) "
            "or fix the typo"))
        return
    for field in explicit:
        if field not in declared:
            findings.append(Finding(
                "event-unknown-field", PASS_NAME, mod.path, line,
                "event %r field %r is not in the schema" % (ev_name,
                                                            field),
                "declare it in _OPTIONAL[%r] in obs/events.py or drop "
                "the field" % ev_name))
    if not has_splat:
        missing = [k for k in ev._REQUIRED[ev_name]
                   if k not in explicit]
        if missing:
            findings.append(Finding(
                "event-missing-field", PASS_NAME, mod.path, line,
                "event %r emitted without required %s" % (ev_name,
                                                          missing),
                "emit every _REQUIRED key — readers key on them "
                "unconditionally"))
    if schema_kw is not None:
        if isinstance(schema_kw, ast.Constant) \
                and isinstance(schema_kw.value, int) \
                and schema_kw.value != ev.SCHEMA_VERSION:
            findings.append(Finding(
                "event-schema-version", PASS_NAME, mod.path, line,
                "literal schema=%r but SCHEMA_VERSION is %d"
                % (schema_kw.value, ev.SCHEMA_VERSION),
                "emit schema=SCHEMA_VERSION, never a pinned literal"))


def _emit_call(node: ast.Call) -> Optional[Tuple[str, List[str], bool,
                                                 Optional[ast.AST]]]:
    """(ev, explicit fields, has_splat, schema kw) for an emit call."""
    fn = node.func
    is_emit = (isinstance(fn, ast.Attribute) and fn.attr in _EMIT_METHODS) \
        or (isinstance(fn, ast.Name) and fn.id in _EMIT_METHODS)
    if not is_emit or not node.args:
        return None
    ev_name = str_const(node.args[0])
    if ev_name is None:
        return None                 # dynamic event type: not decidable
    explicit, has_splat, schema_kw = [], False, None
    for kw in node.keywords:
        if kw.arg is None:
            has_splat = True
        else:
            explicit.append(kw.arg)
            if kw.arg == "schema":
                schema_kw = kw.value
    return ev_name, explicit, has_splat, schema_kw


def _queued_tuple(node: ast.Call) -> Optional[Tuple[str, List[str],
                                                    bool]]:
    """('name', fields, has_dynamic) for ``<list>.append(("name", {...}))``
    — the autotuner's deferred-emission idiom."""
    fn = node.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "append"
            and len(node.args) == 1):
        return None
    arg = node.args[0]
    if not (isinstance(arg, ast.Tuple) and len(arg.elts) == 2):
        return None
    ev_name = str_const(arg.elts[0])
    payload = arg.elts[1]
    if ev_name is None or not isinstance(payload, ast.Dict):
        return None
    explicit, dynamic = [], False
    for k in payload.keys:
        s = str_const(k) if k is not None else None
        if k is None or s is None:
            dynamic = True          # **merge or computed key
        else:
            explicit.append(s)
    return ev_name, explicit, dynamic


def run(modules: List[SourceModule], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            info = _emit_call(node)
            if info is not None:
                ev_name, explicit, has_splat, schema_kw = info
                _check_fields(mod, node.lineno, ev_name, explicit,
                              has_splat, schema_kw, findings)
                continue
            q = _queued_tuple(node)
            if q is not None:
                ev_name, explicit, dynamic = q
                # a queued 2-tuple only counts as an emit site when the
                # name IS a declared event — any (str, dict) append
                # would otherwise false-positive as unknown-type
                if _schema().declared_fields(ev_name) is None:
                    continue
                _check_fields(mod, node.lineno, ev_name, explicit,
                              dynamic, None, findings)
    return findings
